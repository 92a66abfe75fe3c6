"""Vector quantizer modules, counterpart of the JAX package's
``models/modules/vector_quantizer.py``.

  * ``VectorQuantizer``: one codebook over the channel dim of an NCHW
    feature map.  The codebook is a non-trainable buffer: the STE detaches
    the code path and the commitment loss detaches the quantized value, so
    it receives no gradient and stays at its k-means init.
  * the k-means init is an explicit phase, ``init_codebook_(x, generator)``,
    run once on a real batch.
  * ``make_vq_module``: an int or a per-stage list ``num_embeddings``, where
    0 means the stage passes through (``VQIdentity``).

Rows are flattened in (b, h, w) order, as the JAX package flattens NHWC.
Each call returns (quantized NCHW, idx (B, H, W) int32, commitment loss,
code usage %).
"""
from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ...ops.kmeans import kmeans, l2norm
from ...ops.vq import (METRICS, code_usage_percent, commitment_loss, cosine_prep,
                       quantize_ste, vq_assign)


class VQIdentity(nn.Module):
    """Stage pass-through for num_embeddings == 0."""

    def forward(self, x, train: bool = False):
        return x, None, None, None

    def init_codebook_(self, x, generator):
        pass


def _rows(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (B*H*W, C) rows in (b, h, w) order."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


class VectorQuantizer(nn.Module):
    def __init__(self, dim: int, num_embeddings: int, embedding_dim: Optional[int] = None,
                 decay: float = 0.8, eps: float = 1e-5, kmeans_init: bool = False,
                 kmeans_iters: int = 10, distance: str = "euclidean",
                 commitment_weight: float = 1.0, num_codebook: int = 1, ema: bool = False,
                 restart_threshold: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        if distance not in METRICS:
            raise ValueError(f"unknown distance {distance}")
        if ema or restart_threshold > 0:
            raise NotImplementedError(
                "the EMA codebook update and dead-code restart are not ported yet "
                "(ROADMAP.md, queue 1, 'VQ EMA and restart')")
        self.dim = dim
        self.num_embeddings = num_embeddings
        self.edim = embedding_dim if embedding_dim is not None else dim
        self.kmeans_init = kmeans_init
        self.kmeans_iters = kmeans_iters
        self.distance = distance
        self.commitment_weight = commitment_weight
        k = num_embeddings
        # uniform in [-1/K, 1/K]; with kmeans_init a placeholder until the
        # init phase overwrites it
        cb = torch.empty(k, self.edim).uniform_(-1.0 / k, 1.0 / k, generator=generator)
        self.register_buffer("embedding", cb)

    @torch.no_grad()
    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        """k-means init phase on stage features x (B, C, H, W).  A no-op
        unless ``kmeans_init``."""
        if not self.kmeans_init:
            return
        with torch.autocast(x.device.type, enabled=False):
            flat = _rows(x.float())
            feats = l2norm(flat) if self.distance == "cosine" else flat
            means, _ = kmeans(feats, self.num_embeddings, self.kmeans_iters,
                              use_cosine_sim=self.distance == "cosine", generator=generator)
        self.embedding.copy_(means)

    def forward(self, x: torch.Tensor, train: bool = False):
        b, _, h, w = x.shape
        # the assignment is f32 whatever autocast says: a bf16 product would
        # change which code wins
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            flat = _rows(x)
            cb = self.embedding
            if self.distance == "cosine":
                flat, cb = cosine_prep(flat, cb)
            idx, quantized, counts = vq_assign(flat.contiguous(), cb.contiguous(),
                                               self.distance)
            usage = code_usage_percent(counts)
            quantized = quantized.reshape(b, h, w, self.edim).permute(0, 3, 1, 2)
            loss = x.new_zeros(())
            if train:
                quantized = quantize_ste(x, quantized)
                if self.commitment_weight > 0:
                    loss = commitment_loss(x, quantized, self.commitment_weight)
        return quantized, idx.reshape(b, h, w), loss, usage


_VQ_ARGS = set(inspect.signature(VectorQuantizer.__init__).parameters) - {
    "self", "dim", "num_embeddings", "generator"}


def make_vq_module(vq_cfg, encoder_channels: Sequence[int], depth: int,
                   generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    """Per-stage codebook list.  ``encoder_channels`` includes the input
    channels at index 0."""
    cfg = dict(vq_cfg)
    num_embeddings = cfg.pop("num_embeddings")
    cfg = {kk: v for kk, v in cfg.items() if kk in _VQ_ARGS}
    if isinstance(num_embeddings, int):
        num_embeddings = [num_embeddings] * depth
    if not isinstance(num_embeddings, (list, tuple)):
        raise TypeError(f"{type(num_embeddings)} is not an available type")
    if len(num_embeddings) != depth:
        raise ValueError("depth and length of vq_cfg.num_embeddings must be the same")
    mods = []
    for i, k in enumerate(num_embeddings):
        if k == 0:
            mods.append(VQIdentity())
        elif k > 0:
            mods.append(VectorQuantizer(encoder_channels[i + 1], k, generator=generator, **cfg))
        else:
            raise ValueError(f"{k} is not an available number of embeddings")
    return nn.ModuleList(mods)
