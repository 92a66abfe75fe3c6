"""U-Net decoder, counterpart of the JAX package's
``models/modules/decoder.py`` (reference channel plan only).

Deepest feature first; each block is a double conv-BN-ReLU on the concat of
the bilinearly resized previous output and the skip.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..layers import ConvBNReLU, resize_bilinear


class DoubleConv(nn.Sequential):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            ConvBNReLU(in_channels, out_channels, kernel_size, bn_eps, bn_momentum, generator),
            ConvBNReLU(out_channels, out_channels, kernel_size, bn_eps, bn_momentum, generator))


class UnetDecoder(nn.Module):
    """``bn_eps``/``bn_momentum`` (torch convention) reach exactly the
    decoder's BatchNorms, like the JAX package's decoder BN override."""

    def __init__(self, encoder_channels: Sequence[int], decoder_channels: Sequence[int],
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1, cca=None,
                 subpixel_tail: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cca is not None or subpixel_tail:
            raise NotImplementedError(
                "decoder cca and subpixel_tail are not ported yet "
                "(ROADMAP.md, queue 1, 'The rest of the model zoo')")
        skips = list(encoder_channels[1:])[::-1]  # deep -> shallow
        blocks = []
        prev = skips[0]
        for i, out_ch in enumerate(decoder_channels):
            in_ch = prev if i == 0 else prev + skips[i]
            blocks.append(DoubleConv(in_ch, out_ch, 3, bn_eps, bn_momentum, generator))
            prev = out_ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, features):
        """features: encoder stage outputs shallow -> deep, without the raw
        input."""
        feats = list(features)[::-1]
        x = feats[0]
        for i, block in enumerate(self.blocks):
            if i > 0:
                skip = feats[i]
                up = resize_bilinear(x, skip.shape[-2:])
                x = torch.cat([up, skip], dim=1)
            x = block(x)
        return x
