"""VQ-VAE reconstruction networks for self-supervised codebook pretraining,
counterpart of the JAX package's ``models/networks/vqvae.py``.

``vqvaev2``: per-stage VQ on the encoder stages; the quantized stages are
bilinearly resized to the stage-1 grid, concatenated and decoded to an RGB
reconstruction at twice that grid (``stride`` 2).  ``vqvaev1`` quantizes
the deepest stage only and decodes it.  Both return (reconstruction,
commitment / number of stages, usage vector).

The decoder's transposed convolutions are flax's ``nn.ConvTranspose(k=4,
s=2, padding="SAME")``, which correlates the stride-dilated input, padded
by 2 on each side, with the kernel as it is (not flipped).  That is
``nn.ConvTranspose2d(k=4, s=2, p=1)`` with the flax kernel flipped in
both spatial axes and its in/out axes swapped (``utils/convert.py``); the
weights are drawn as flax draws them (lecun normal, zero bias).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..encoders import make_encoder
from ..layers import ConvPad, resize_bilinear, torch_conv_default
from ..modules.vector_quantizer import VectorQuantizer, make_vq_module, quantize_stages
from . import register


def _conv_transpose(in_channels: int, out_channels: int,
                    generator: Optional[torch.Generator], kernel_size: int = 4,
                    padding: int = 1) -> nn.ConvTranspose2d:
    """flax ``nn.ConvTranspose(out, (k, k), strides=(2, 2), padding="SAME")``
    for k = 4 (``padding`` 1) or 2 (``padding`` 0): output = 2 x input at
    every size; flax's lecun-normal kernel (fan in = k² x in_channels,
    truncated at two standard deviations) and zero bias."""
    up = nn.ConvTranspose2d(in_channels, out_channels, kernel_size, stride=2, padding=padding)
    std = math.sqrt(1.0 / (kernel_size ** 2 * in_channels)) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(up.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        up.bias.zero_()
    return up


class ResBlock(nn.Module):
    """relu -> 3x3 conv -> relu -> 1x1 conv, added to the input; convs with
    bias and torch's default init."""

    def __init__(self, hidden: int, res_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = ConvPad(hidden, res_channels, 3, 1, 1, bias=True, init=torch_conv_default,
                             generator=generator)
        self.conv2 = ConvPad(res_channels, hidden, 1, bias=True, init=torch_conv_default,
                             generator=generator)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class VQVAEDecoder(nn.Module):
    """3x3 conv to ``hidden_channels``, ``n_resblocks`` ResBlocks, ReLU, then
    one transposed conv to ``out_channels`` (``stride`` 2), or two with a
    ReLU between (``stride`` 4)."""

    def __init__(self, in_channels: int, out_channels: int = 3, hidden_channels: int = 32,
                 n_resblocks: int = 2, n_res_channels: int = 32, stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride not in (2, 4):
            raise ValueError(f"stride must be 2 or 4, got {stride}")
        self.conv_in = ConvPad(in_channels, hidden_channels, 3, 1, 1, bias=True,
                               init=torch_conv_default, generator=generator)
        self.resblocks = nn.ModuleList(ResBlock(hidden_channels, n_res_channels, generator)
                                       for _ in range(n_resblocks))
        ups = ([(hidden_channels, hidden_channels // 2), (hidden_channels // 2, out_channels)]
               if stride == 4 else [(hidden_channels, out_channels)])
        self.up = nn.ModuleList(_conv_transpose(i, o, generator) for i, o in ups)

    def forward(self, x):
        y = self.conv_in(x)
        for block in self.resblocks:
            y = block(y)
        y = F.relu(y)
        for i, up in enumerate(self.up):
            y = up(F.relu(y) if i else y)
        return y


@register("vqvaev2")
class VQVAEv2(nn.Module):
    """``forward(x, train=False, init_codebook=False, generator=None)`` ->
    (reconstruction (N, out, H, W) at ``stride`` 2, commitment, usage).
    ``encoder``, ``codebooks`` and ``decoder`` sit at the top level: the
    layout ``save_vqvae`` writes."""

    def __init__(self, encoder_name: str, vq_cfg, in_channels: int = 3, out_channels: int = 3,
                 hidden_channels: int = 32, n_resblocks: int = 2, n_res_channels: int = 32,
                 depth: int = 5, stride: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder, enc_ch = make_encoder(encoder_name, in_channels, depth,
                                            generator=generator)
        self.codebooks = make_vq_module(vq_cfg, list(enc_ch), depth, generator)
        self.decoder = VQVAEDecoder(sum(enc_ch[1:]), out_channels, hidden_channels,
                                    n_resblocks, n_res_channels, stride, generator)

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        feats = list(self.encoder(x)[1:])
        commit, usage = quantize_stages(self.codebooks, feats, x, train, init_codebook,
                                        generator)
        size = feats[0].shape[-2:]
        feats = [f if f.shape[-2:] == size else resize_bilinear(f, size) for f in feats]
        return self.decoder(torch.cat(feats, dim=1)), commit, usage


_V1_VQ_ARGS = ("distance", "kmeans_init", "kmeans_iters", "commitment_weight", "decay", "eps")


@register("vqvaev1")
class VQVAEv1(nn.Module):
    """The deepest stage only: one ``codebook`` (the last entry of a
    per-stage ``num_embeddings``) and the decoder on it.  The commitment
    is divided by the number of stages, as in the JAX package.  Returns
    (reconstruction at 1/16 of the input, commitment, usage (1,))."""

    def __init__(self, encoder_name: str, vq_cfg, in_channels: int = 3, out_channels: int = 3,
                 hidden_channels: int = 32, n_resblocks: int = 2, n_res_channels: int = 32,
                 depth: int = 5, stride: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        self.encoder, enc_ch = make_encoder(encoder_name, in_channels, depth,
                                            generator=generator)
        cfg = dict(vq_cfg)
        k = cfg.pop("num_embeddings")
        k = k[-1] if isinstance(k, (list, tuple)) else k
        # the JAX package passes these six knobs only: under ``ema`` (or a
        # restart threshold) its codebook stays frozen, and so does this one
        self.codebook = VectorQuantizer(enc_ch[-1], k, generator=generator,
                                        **{n: v for n, v in cfg.items() if n in _V1_VQ_ARGS})
        self.decoder = VQVAEDecoder(enc_ch[-1], out_channels, hidden_channels, n_resblocks,
                                    n_res_channels, stride, generator)

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        deepest = self.encoder(x)[-1]
        q, _idx, commit, usage = self.codebook(deepest, train=train,
                                               init_codebook=init_codebook, generator=generator)
        return self.decoder(q), commit / self.depth, usage[None]
