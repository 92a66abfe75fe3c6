"""U-Net decoder, counterpart of the JAX package's
``models/modules/decoder.py``.

Deepest feature first; each block is a double conv-BN-ReLU on the concat of
the bilinearly resized previous output and the skip.  ``cca`` (a flag per
block) puts a ``CCA`` after each flagged block (the JAX package's
``CCAUnetDecoder``, ``vqcanetv3``).  ``subpixel_tail`` runs the final block
at half resolution with 4x the channels: the skip goes in space-to-depth
and the output comes back depth-to-space.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..layers import ConvBNReLU, resize_bilinear
from .attention import CCA


class DoubleConv(nn.Sequential):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            ConvBNReLU(in_channels, out_channels, kernel_size, bn_eps, bn_momentum, generator),
            ConvBNReLU(out_channels, out_channels, kernel_size, bn_eps, bn_momentum, generator))


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2) with channel (dy * 2 + dx) * C + c,
    the 2x2 position first as in the JAX package's NHWC reshape
    (``F.pixel_unshuffle`` puts it last)."""
    b, c, h, w = x.shape
    x = x.view(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``space_to_depth``: (B, 4C, H, W) -> (B, C, 2H, 2W)."""
    b, c4, h, w = x.shape
    x = x.view(b, 2, 2, c4 // 4, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c4 // 4, 2 * h, 2 * w)


class UnetDecoder(nn.Module):
    """``bn_eps``/``bn_momentum`` (torch convention) reach exactly the
    decoder's BatchNorms, like the JAX package's decoder BN override.

    ``subpixel_tail`` applies to the final block only, when it is not the
    first and there is no ``cca``: its input is the previous output resized
    to half the skip's size beside the skip's space-to-depth, its output
    4 x ``decoder_channels[-1]`` channels, moved back depth-to-space.  Not
    numerically the reference's tail; odd skip sizes raise."""

    def __init__(self, encoder_channels: Sequence[int], decoder_channels: Sequence[int],
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1, cca=None,
                 subpixel_tail: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cca = tuple(bool(f) for f in cca) if cca is not None else None
        n = len(decoder_channels)
        self.subpixel = subpixel_tail and n > 1 and self.cca is None
        skips = list(encoder_channels[1:])[::-1]  # deep -> shallow
        blocks = []
        prev = skips[0]
        for i, out_ch in enumerate(decoder_channels):
            in_ch = prev if i == 0 else prev + skips[i]
            if self.subpixel and i == n - 1:
                blocks.append(DoubleConv(prev + 4 * skips[i], 4 * out_ch, 3, bn_eps, bn_momentum,
                                         generator))
                break
            blocks.append(DoubleConv(in_ch, out_ch, 3, bn_eps, bn_momentum, generator))
            prev = out_ch
            if self.cca is not None and self.cca[i]:
                # the CCA's BatchNorms keep the defaults: the overrides
                # reach the double convs only, as in the JAX package
                self.add_module(f"cca{i}", CCA(out_ch, out_ch, generator))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, features):
        """features: encoder stage outputs shallow -> deep, without the raw
        input."""
        feats = list(features)[::-1]
        x = feats[0]
        for i, block in enumerate(self.blocks):
            if self.subpixel and i == len(self.blocks) - 1:
                skip = feats[i]
                up = resize_bilinear(x, (skip.shape[-2] // 2, skip.shape[-1] // 2))
                x = depth_to_space(block(torch.cat([up, space_to_depth(skip)], dim=1)))
                continue
            if i > 0:
                skip = feats[i]
                up = resize_bilinear(x, skip.shape[-2:])
                x = torch.cat([up, skip], dim=1)
            x = block(x)
            if self.cca is not None and self.cca[i]:
                x = getattr(self, f"cca{i}")(x)
        return x
