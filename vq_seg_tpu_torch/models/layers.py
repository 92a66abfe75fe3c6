"""Shared NCHW building blocks.

Counterparts of the JAX package's ``models/layers.py``.  Two bilinear resizes
with different corner conventions exist: ``resize_bilinear`` (half-pixel,
``align_corners=False``: decoder skip upsampling and the serving output
resize) and ``upsample_bilinear_ac`` (``align_corners=True``: the x2 head
upsample).  The JAX package's trace-time globals become constructor
arguments: the compute dtype is ``torch.autocast`` and the decoder BN
overrides are ``bn_eps``/``bn_momentum`` of the decoder.  Every BatchNorm
is ``BatchNorm2d``, whose training-mode running variance follows flax.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import active_group, batch_sum

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


def lecun_normal(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default ``Dense`` kernel init: a normal truncated at two
    standard deviations, variance 1 / fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dense(in_features: int, out_features: int,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    lin = nn.Linear(in_features, out_features)
    lecun_normal(lin.weight, generator)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


class ConvPad(nn.Conv2d):
    """Conv2d with symmetric int padding and a padding mode.

    ``padding_mode`` reflect/replicate/circular pads only when padding > 0,
    as the JAX ``ConvPad`` does; 1x1 and downsample convs have none.  The
    weight is drawn by ``init`` from ``generator``; a bias starts at 0.
    ``dilation`` spaces the kernel taps (atrous convolution)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, groups: int = 1, bias: bool = True,
                 padding_mode: str = "zeros", init=kaiming_normal,
                 generator: Optional[torch.Generator] = None, dilation: int = 1):
        if padding_mode not in PADDING_MODES:
            raise ValueError(f"padding_mode must be one of {PADDING_MODES}, got {padding_mode!r}")
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         dilation=dilation, groups=groups, bias=bias,
                         padding_mode=padding_mode if padding > 0 else "zeros")
        init(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def reset_parameters(self):
        """Nothing: ``__init__`` draws the weight with ``init`` and zeroes the
        bias, so torch's own draw before it would be thrown away."""


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-stat update.

    In training mode torch blends the *unbiased* batch variance into
    ``running_var``; flax's ``BatchNorm``, which the JAX package uses, blends
    the *biased* one: ``ra = (1 - m) * ra + m * batch``.  The batch mean and
    the normalisation are torch's own (cuDNN on the card).  The unbiased
    variance comes out of the same batch_norm call, blended into a zeroed
    scratch, and is rescaled by (n - 1) / n, so no extra pass over the
    activations is made.  Eval mode, parameters and ``state_dict`` keys are
    ``nn.BatchNorm2d``'s; ``num_batches_tracked`` is not advanced (a set
    ``momentum`` never reads it).  Inside ``parallel.data_parallel`` the
    training-mode statistics are those of the global batch (``_synced``)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if active_group() is not None:
            return self._synced(x)
        n = x.numel() // x.shape[1]
        scratch = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, self.running_mean, scratch, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():  # scratch = m * unbiased var
            self.running_var.mul_(1.0 - self.momentum).add_(scratch, alpha=(n - 1) / n)
        return y

    def _synced(self, x):
        """Train mode over the global batch of the active data-parallel
        group (sync-BN): the per-channel sum and count, then the sum of
        squared deviations from the global mean, each summed over the ranks
        by ``batch_sum``; autograd carries the gradient back through both.
        Statistics in f32 (f64 for an f64 ``x``), the output in ``x``'s
        dtype."""
        with torch.autocast(x.device.type, enabled=False):
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            c = x.shape[1]
            count = xf.new_full((1,), float(x.numel() // c))
            s1 = batch_sum(torch.cat([torch.sum(xf, dim=(0, 2, 3)), count]))
            n = s1[c]
            mean = s1[:c] / n
            centered = xf - mean[None, :, None, None]
            var = batch_sum(torch.sum(centered * centered, dim=(0, 2, 3))) / n
            invstd = torch.rsqrt(var + self.eps)
            y = centered * (invstd * self.weight)[None, :, None, None] + self.bias[None, :, None, None]
            with torch.no_grad():  # flax's update: the biased variance
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        return y.to(x.dtype)


def batch_norm(channels: int, eps: float = 1e-5, momentum: float = 0.1) -> BatchNorm2d:
    """BatchNorm with torch defaults (momentum is the torch new-stat
    fraction; flax's 0.9 is torch's 0.1) and flax's running-variance
    update."""
    return BatchNorm2d(channels, eps=eps, momentum=momentum)


class ConvBNReLU(nn.Module):
    """conv -> BN -> activation.  ``padding`` defaults to (k - 1) // 2, the
    'same' idiom; ``groups``, ``dilation``, ``padding_mode`` and ``bias``
    (default none) are the conv's; ``act`` is applied last (None for
    none)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None, *, padding: Optional[int] = None,
                 groups: int = 1, dilation: int = 1, padding_mode: str = "zeros", act=F.relu,
                 bias: bool = False):
        super().__init__()
        pad = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = ConvPad(in_channels, out_channels, kernel_size, 1, pad, groups=groups,
                            bias=bias, padding_mode=padding_mode, generator=generator,
                            dilation=dilation)
        self.bn = batch_norm(out_channels, bn_eps, bn_momentum)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


def max_pool_same(x, window: int = 3, stride: int = 2, padding: int = 1):
    """MaxPool2d(k, s, p) with -inf padding."""
    return F.max_pool2d(x, window, stride, padding)


def global_avg_pool(x, keepdims: bool = True):
    """AdaptiveAvgPool2d(1) over NCHW."""
    return torch.mean(x, dim=(2, 3), keepdim=keepdims)


def resize_bilinear(x, size: Tuple[int, int]):
    """Bilinear, half-pixel centres (``align_corners=False``), no antialias:
    ``jax.image.resize(..., "bilinear", antialias=False)``."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)


def resize_nearest(x, size: Tuple[int, int]):
    """Nearest resize of the last two dims with torch's floor indexing,
    ``src = floor(dst * in / out)`` in f64, as the JAX package's
    ``resize_nearest`` gathers; works on integer label maps too."""
    h, w = x.shape[-2:]
    oh, ow = size
    iy = torch.floor(torch.arange(oh, device=x.device, dtype=torch.float64) * (h / oh)).long()
    ix = torch.floor(torch.arange(ow, device=x.device, dtype=torch.float64) * (w / ow)).long()
    return x.index_select(-2, iy).index_select(-1, ix)


def resize_nearest_exact(x, size: Tuple[int, int]):
    """Nearest resize of the last two dims with half-pixel centres, ``src =
    floor((dst + 0.5) * in / out)`` in f64 (torch's ``nearest-exact``, and
    ``jax.image.resize(..., "nearest")``): a 2x downsample picks 2i + 1,
    where ``resize_nearest`` picks 2i.  Works on integer label maps too."""
    h, w = x.shape[-2:]
    oh, ow = size
    iy = torch.floor((torch.arange(oh, device=x.device, dtype=torch.float64) + 0.5)
                     * (h / oh)).long().clamp_max(h - 1)
    ix = torch.floor((torch.arange(ow, device=x.device, dtype=torch.float64) + 0.5)
                     * (w / ow)).long().clamp_max(w - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def upsample_bilinear_ac(x, scale: Optional[int] = None, size: Optional[Tuple[int, int]] = None):
    """``nn.UpsamplingBilinear2d``: bilinear with ``align_corners=True``."""
    h, w = x.shape[-2:]
    if size is None:
        size = (h * scale, w * scale)
    if tuple(size) == (h, w):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
