"""The flagship VQ U-Net, counterpart of the JAX package's
``models/networks/vq_unet.py`` (``VQUnetCore``, the head of ``_PTNet`` and
``VQRePTUnet1x1v2``).

encoder stages[1:] -> per-stage VQ (commitment loss summed and divided by
the number of stages) -> UnetDecoder -> bias-free 1x1 head -> x2
align-corners upsample.  The prototype loss belongs to the training slice;
in eval the network returns ``proto = 0``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..encoders import make_encoder
from ..layers import ConvPad, torch_conv_default, upsample_bilinear_ac
from ..modules.decoder import UnetDecoder
from ..modules.vector_quantizer import make_vq_module
from . import register


def _decoder_channels(encoder_channels, decoder_channels):
    """Default plan: halved encoder channels, reversed."""
    if decoder_channels is not None:
        return tuple(decoder_channels)
    return tuple(i // 2 for i in encoder_channels[1:])[::-1]


class VQUnetCore(nn.Module):
    """Shared encoder -> VQ -> decoder trunk."""

    def __init__(self, encoder_name: str, vq_cfg=None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 padding_mode: str = "zeros", bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder, enc_ch = make_encoder(encoder_name, in_channels, depth,
                                            padding_mode=padding_mode, generator=generator)
        self.codebooks = (make_vq_module(vq_cfg, list(enc_ch), depth, generator)
                          if vq_cfg is not None else None)
        self.decoder_channels = _decoder_channels(enc_ch, decoder_channels)
        self.decoder = UnetDecoder(enc_ch, self.decoder_channels, bn_eps, bn_momentum,
                                   generator=generator)

    @torch.no_grad()
    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        """k-means init phase: every VQ stage clusters its own encoder stage
        output, stage by stage from the shallowest.  The encoder runs in the
        module's current mode (eval: running BN stats)."""
        if self.codebooks is None:
            return
        features = self.encoder(x)[1:]
        for vq, f in zip(self.codebooks, features):
            vq.init_codebook_(f, generator)

    def forward(self, x, train: bool = False):
        features = list(self.encoder(x)[1:])
        commit = x.new_zeros((), dtype=torch.float32)
        usages = []
        if self.codebooks is not None:
            for i, vq in enumerate(self.codebooks):
                q, _idx, c_loss, usage = vq(features[i], train=train)
                features[i] = q
                if c_loss is not None:
                    commit = commit + c_loss
                if usage is not None:
                    usages.append(usage)
            commit = commit / len(features)
        dec = self.decoder(features)
        usage_vec = torch.stack(usages) if usages else x.new_zeros((0,), dtype=torch.float32)
        return dec, commit, usage_vec


@register("vqreptunet1x1v2")
class VQRePTUnet1x1v2(nn.Module):
    """Flagship: reflect-padded encoder, bias-free 1x1 head, x2 upsample.
    ``forward(x, gt=None, th=None, train=False)`` -> (out, commit, usage,
    proto)."""

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg, margin: float = 1.5,
                 scale: float = 1.0, use_feature: bool = False,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, pt_init: str = "kmeans", bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        # margin, scale, use_feature and pt_init configure the prototype loss
        # of the training slice; encoder_weights names pretrained weights that
        # are never fetched (the weights come from a checkpoint)
        self.num_classes = num_classes
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, vq_cfg, in_channels, decoder_channels, depth,
                               padding_mode="reflect", bn_eps=bn_eps, bn_momentum=bn_momentum,
                               generator=generator)
        dec_ch = self.core.decoder_channels
        self.segmentation_head = ConvPad(dec_ch[-1], num_classes, 1, 1, 0, bias=False,
                                         init=torch_conv_default, generator=generator)

    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        self.core.init_codebook_(x, generator)

    def forward(self, x, gt=None, th=None, train: bool = False):
        if train and gt is not None:
            raise NotImplementedError(
                "the prototype loss is not ported yet (ROADMAP.md, queue 1, "
                "'Prototype loss')")
        dec, commit, usage = self.core(x, train=train)
        out = self.segmentation_head(dec)
        if self.upsampling > 1:
            out = upsample_bilinear_ac(out, scale=self.upsampling)
        proto = x.new_zeros((), dtype=torch.float32)
        return out, commit, usage, proto
