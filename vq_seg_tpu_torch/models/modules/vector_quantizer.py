"""Vector quantizer modules, counterpart of the JAX package's
``models/modules/vector_quantizer.py``.

  * ``VectorQuantizer``: one codebook over the channel dim of an NCHW
    feature map.  The codebook is a non-trainable buffer: the STE detaches
    the code path and the commitment loss detaches the quantized value, so
    it receives no gradient and stays at its k-means init unless ``ema``.
  * ``ema=True`` (``vq_cfg.ema``) updates the codebook after each train
    forward that runs inside ``ema_updates()``, the counterpart of the JAX
    package applying with ``mutable=["codebook"]``: cluster sizes (the
    assignment's counts) and per-code feature sums are blended with
    ``decay`` and the codebook becomes their Laplace-smoothed running mean.
    The forward's own assignment, STE and commitment use the codebook from
    before the update.  ``restart_threshold > 0`` then reseeds every code
    whose cluster size fell below it with a row of the batch: code j takes
    the row of rank ``j % min(K, N)`` in the residuals to the pre-update
    codes, largest first, ties to the lower row.
  * the k-means init is an explicit phase, ``init_codebook_(x, generator)``,
    run once on a real batch: alone (serving, eval-mode features) or inside
    a forward with ``init_codebook=True`` (training, on the features of a
    train-mode encoder).
  * ``make_vq_module``: an int or a per-stage list ``num_embeddings``, where
    0 means the stage passes through (``VQIdentity``); ``quantize_stages``
    runs such a list over the stage features.

Inside ``parallel.data_parallel`` every batch-wide quantity is that of the
global batch: the counts behind the usage, the EMA's counts and sums, the
restart's candidates (gathered in rank order, the global row order) and
the k-means init's rows.

Rows are flattened in (b, h, w) order, as the JAX package flattens NHWC.
Each call returns (quantized NCHW, idx (B, H, W) int32, commitment loss,
code usage %).
"""
from __future__ import annotations

import contextlib
import inspect
import threading
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ...ops.kmeans import kmeans, l2norm
from ...parallel.collectives import batch_gather, batch_sum
from ...ops.vq import (METRICS, code_usage_percent, commitment_loss, cosine_prep,
                       quantize_ste, vq_assign)


class VQIdentity(nn.Module):
    """Stage pass-through for num_embeddings == 0."""

    def forward(self, x, train: bool = False, init_codebook: bool = False, generator=None):
        return x, None, None, None

    def init_codebook_(self, x, generator):
        pass


_gate = threading.local()


@contextlib.contextmanager
def ema_updates():
    """Inside this context, train forwards of ``VectorQuantizer(ema=True)``
    (not the init phase) update the codebook and its EMA state.  The train
    steps whose JAX counterparts make the ``codebook`` collection mutable
    enter it: the flagship CPS step's train passes, the supervised and
    self-supervised steps and the init phases; the ``variants.py`` steps do
    not, so their codebooks stay frozen, as in the JAX package."""
    before = getattr(_gate, "on", False)
    _gate.on = True
    try:
        yield
    finally:
        _gate.on = before


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
        if restart_threshold > 0 and not ema:
            raise ValueError(
                "restart_threshold requires ema=True (the EMA cluster size is the usage "
                "signal that marks a code dead)")
        self.dim = dim
        self.num_embeddings = num_embeddings
        self.edim = embedding_dim if embedding_dim is not None else dim
        self.kmeans_init = kmeans_init
        self.kmeans_iters = kmeans_iters
        self.distance = distance
        self.commitment_weight = commitment_weight
        self.decay = decay
        self.eps = eps
        self.ema = ema
        self.restart_threshold = restart_threshold
        k = num_embeddings
        # uniform in [-1/K, 1/K]; with kmeans_init a placeholder until the
        # init phase overwrites it
        cb = torch.empty(k, self.edim).uniform_(-1.0 / k, 1.0 / k, generator=generator)
        self.register_buffer("embedding", cb)
        if ema:  # only then, so that the state_dict of a frozen codebook keeps its keys
            self.register_buffer("cluster_size", torch.ones(k))
            self.register_buffer("embed_avg", cb.clone())

    @torch.no_grad()
    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        """k-means init phase on stage features x (B, C, H, W).  A no-op
        unless ``kmeans_init``."""
        if not self.kmeans_init:
            return
        with torch.autocast(x.device.type, enabled=False):
            flat = batch_gather(_rows(x.float()))  # the global batch's rows
            feats = l2norm(flat) if self.distance == "cosine" else flat
            means, _ = kmeans(feats, self.num_embeddings, self.kmeans_iters,
                              use_cosine_sim=self.distance == "cosine", generator=generator)
        self.embedding.copy_(means)
        if self.ema:  # the running mean is the k-means mean at unit mass
            self.cluster_size.fill_(1.0)
            self.embed_avg.copy_(means)

    @torch.no_grad()
    def ema_update_(self, feats: torch.Tensor, idx: torch.Tensor, quantized: torch.Tensor,
                    counts: torch.Tensor):
        """One EMA step (and restart) from a forward's rows ``feats`` (N, C)
        (l2-normalised for cosine), their codes ``idx``, the pre-update code
        rows ``quantized`` and the assignment's ``counts``."""
        k = self.num_embeddings
        feats = feats.detach().float()
        # index_add_ on the card sums with atomics, in no fixed order
        sums = batch_sum(torch.zeros_like(self.embed_avg).index_add_(0, idx.long(), feats))
        d = self.decay
        new_cs = d * self.cluster_size + (1.0 - d) * counts.float()
        new_ea = d * self.embed_avg + (1.0 - d) * sums
        n = torch.sum(new_cs)
        smoothed = (new_cs + self.eps) / (n + k * self.eps) * n
        new_cb = new_ea / smoothed[:, None]
        if self.distance == "cosine":
            new_cb = l2norm(new_cb)
        if self.restart_threshold > 0:
            dead = new_cs < self.restart_threshold
            # candidates from the global batch, in its row order
            err = batch_gather(torch.sum((feats - quantized) ** 2, dim=-1))
            feats = batch_gather(feats)
            # a stable sort puts the lower row first among equal residuals,
            # as the JAX package's top_k does; torch.topk promises no order
            top = torch.sort(err, descending=True, stable=True).indices[:min(k, err.shape[0])]
            cand = feats[top[torch.arange(k, device=top.device) % top.shape[0]]]
            new_cb = torch.where(dead[:, None], cand, new_cb)
            new_ea = torch.where(dead[:, None], cand, new_ea)
            new_cs = torch.where(dead, torch.ones_like(new_cs), new_cs)
        self.cluster_size.copy_(new_cs)
        self.embed_avg.copy_(new_ea)
        self.embedding.copy_(new_cb)

    def forward(self, x: torch.Tensor, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        """``init_codebook=True`` first runs the init phase on this ``x``
        (the features of the forward's own BN mode), then quantizes with the
        new codebook.  A train forward inside ``ema_updates()`` other than
        the init phase updates an ``ema`` codebook after quantizing."""
        b, _, h, w = x.shape
        if init_codebook:
            self.init_codebook_(x.detach(), generator)
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
            counts = batch_sum(counts)  # the global batch's code usage
            usage = code_usage_percent(counts)
            if train and self.ema and not init_codebook and getattr(_gate, "on", False):
                self.ema_update_(flat, idx, quantized, counts)
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


def quantize_stages(codebooks, features: list, x, train: bool, init_codebook: bool,
                    generator: Optional[torch.Generator]):
    """Quantize ``features`` in place with the per-stage ``codebooks`` (None:
    no VQ).  Returns (commitment summed and divided by the number of stages,
    the per-stage usage vector)."""
    commit = x.new_zeros((), dtype=torch.float32)
    usages = []
    if codebooks is not None:
        for i, vq in enumerate(codebooks):
            q, _idx, c_loss, usage = vq(features[i], train=train, init_codebook=init_codebook,
                                        generator=generator)
            features[i] = q
            if c_loss is not None:
                commit = commit + c_loss
            if usage is not None:
                usages.append(usage)
        commit = commit / len(features)
    usage_vec = torch.stack(usages) if usages else x.new_zeros((0,), dtype=torch.float32)
    return commit, usage_vec
