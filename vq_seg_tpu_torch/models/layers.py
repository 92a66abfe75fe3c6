"""Shared NCHW building blocks.

Counterparts of the JAX package's ``models/layers.py``.  Two bilinear resizes
with different corner conventions exist: ``resize_bilinear`` (half-pixel,
``align_corners=False``: decoder skip upsampling and the serving output
resize) and ``upsample_bilinear_ac`` (``align_corners=True``: the x2 head
upsample).  The JAX package's trace-time globals become constructor
arguments: the compute dtype is ``torch.autocast`` and the decoder BN
overrides are ``bn_eps``/``bn_momentum`` of the decoder.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

PADDING_MODES = ("zeros", "reflect", "replicate", "circular")


def kaiming_normal(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch ``kaiming_normal_(mode="fan_out", nonlinearity="relu")``, the
    torchvision resnet conv init: normal with std sqrt(2 / fan_out)."""
    fan_out = w.shape[0] * math.prod(w.shape[2:])
    with torch.no_grad():
        return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def torch_conv_default(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch's default Conv2d init, ``kaiming_uniform_(a=sqrt(5))``: uniform
    in +-1/sqrt(fan_in)."""
    fan_in = math.prod(w.shape[1:])
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


class ConvPad(nn.Conv2d):
    """Conv2d with symmetric int padding and a padding mode.

    ``padding_mode`` reflect/replicate/circular pads only when padding > 0,
    as the JAX ``ConvPad`` does; 1x1 and downsample convs have none.  The
    weight is drawn by ``init`` from ``generator``; a bias starts at 0."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, groups: int = 1, bias: bool = True,
                 padding_mode: str = "zeros", init=kaiming_normal,
                 generator: Optional[torch.Generator] = None):
        if padding_mode not in PADDING_MODES:
            raise ValueError(f"padding_mode must be one of {PADDING_MODES}, got {padding_mode!r}")
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         groups=groups, bias=bias,
                         padding_mode=padding_mode if padding > 0 else "zeros")
        init(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


def batch_norm(channels: int, eps: float = 1e-5, momentum: float = 0.1) -> nn.BatchNorm2d:
    """BatchNorm2d with torch defaults (momentum is the torch new-stat
    fraction; flax's 0.9 is torch's 0.1)."""
    return nn.BatchNorm2d(channels, eps=eps, momentum=momentum)


class ConvBNReLU(nn.Module):
    """conv (no bias, 'same' padding) -> BN -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = ConvPad(in_channels, out_channels, kernel_size, 1, (kernel_size - 1) // 2,
                            bias=False, generator=generator)
        self.bn = batch_norm(out_channels, bn_eps, bn_momentum)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def max_pool_same(x, window: int = 3, stride: int = 2, padding: int = 1):
    """MaxPool2d(k, s, p) with -inf padding."""
    return F.max_pool2d(x, window, stride, padding)


def resize_bilinear(x, size: Tuple[int, int]):
    """Bilinear, half-pixel centres (``align_corners=False``), no antialias:
    ``jax.image.resize(..., "bilinear", antialias=False)``."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)


def upsample_bilinear_ac(x, scale: Optional[int] = None, size: Optional[Tuple[int, int]] = None):
    """``nn.UpsamplingBilinear2d``: bilinear with ``align_corners=True``."""
    h, w = x.shape[-2:]
    if size is None:
        size = (h * scale, w * scale)
    if tuple(size) == (h, w):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
