"""DeepLab v3 and v3+ and UniMatch's network, counterpart of the JAX
package's ``models/networks/deeplabv3.py``.

  * ``SeparableConvBNReLU``: a depthwise k x k conv (dilated) and a
    pointwise 1x1 conv, both bias-free, then BN and ReLU;
  * ``ASPP``: a 1x1 branch, one (separable) atrous branch per rate, an
    image-pooling branch (global average, 1x1 ConvBNReLU, a bilinear resize
    back, i.e. a broadcast) and a 1x1 projection of their concatenation,
    then dropout 0.5 in training;
  * ``DeepLabV3PlusDecoder``: separable ASPP on the deepest feature, a
    separable ConvBNReLU, the x4 (x2 at output stride 8) align-corners
    upsample, concatenated with a 48-channel 1x1 projection of the
    stride-4 feature, and a last separable ConvBNReLU.

Dropout is flax's: a keep mask drawn with probability 1 - rate, the kept
values divided by it.  Every train-mode forward takes ``dropout``: None
draws the mask from PyTorch's global generator, a callable ``shape ->
mask`` draws it (the ``semiweed`` driver draws from its own generator, and
a test can hand over the masks the JAX package drew).  The convs have no
bias and the kaiming normal init; the BNs are the port's flax-style
``BatchNorm2d``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..encoders import make_encoder
from ..layers import ConvBNReLU, ConvPad, batch_norm, global_avg_pool, resize_bilinear
from ..layers import upsample_bilinear_ac
from ..modules.heads import SegmentationHead
from . import register


def apply_dropout(y: torch.Tensor, rate: float, keep=None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training: ``where(keep, y / (1 - rate),
    0)``.  ``keep``: None (drawn from PyTorch's global generator) or a
    callable ``shape -> keep``, a bool tensor of that shape."""
    if rate == 0.0:
        return y
    keep_prob = 1.0 - rate
    keep = (torch.rand(y.shape, device=y.device) < keep_prob if keep is None
            else keep(tuple(y.shape)))
    if tuple(keep.shape) != tuple(y.shape):
        raise ValueError(f"dropout mask {tuple(keep.shape)} for an output {tuple(y.shape)}")
    return torch.where(keep.to(y.device), y / keep_prob, torch.zeros_like(y))


class SeparableConvBNReLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        pad = dilation * (kernel_size // 2)
        self.depthwise = ConvPad(in_channels, in_channels, kernel_size, 1, pad,
                                 groups=in_channels, bias=False, generator=generator,
                                 dilation=dilation)
        self.pointwise = ConvPad(in_channels, out_channels, 1, bias=False, generator=generator)
        self.bn = batch_norm(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.pointwise(self.depthwise(x))))


class ASPP(nn.Module):
    """``forward(x, train=False, dropout=None)``; ``train`` turns the
    dropout on (the BN mode is the module's own)."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), separable: bool = False,
                 dropout: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.b0 = ConvBNReLU(in_channels, out_channels, 1, generator=generator, padding=0)
        if separable:
            rates = [SeparableConvBNReLU(in_channels, out_channels, 3, r, generator)
                     for r in atrous_rates]
        else:
            rates = [ConvBNReLU(in_channels, out_channels, 3, generator=generator, padding=r,
                                dilation=r) for r in atrous_rates]
        self.rates = nn.ModuleList(rates)
        self.pool = ConvBNReLU(in_channels, out_channels, 1, generator=generator, padding=0)
        n_branches = len(atrous_rates) + 2
        self.project = ConvBNReLU(n_branches * out_channels, out_channels, 1,
                                  generator=generator, padding=0)

    def forward(self, x, train: bool = False, dropout=None):
        res = [self.b0(x)] + [branch(x) for branch in self.rates]
        pooled = self.pool(global_avg_pool(x))
        res.append(resize_bilinear(pooled, x.shape[-2:]))
        y = self.project(torch.cat(res, dim=1))
        return apply_dropout(y, self.dropout, dropout) if train else y


class DeepLabV3PlusDecoder(nn.Module):
    """``forward(features, train=False, dropout=None)``: ``features`` are
    the encoder's stage outputs (the last is the deepest, ``features[-4]``
    the stride-4 one)."""

    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), output_stride: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = 2 if output_stride == 8 else 4
        self.aspp = ASPP(encoder_channels[-1], out_channels, atrous_rates, separable=True,
                         generator=generator)
        self.aspp_sep = SeparableConvBNReLU(out_channels, out_channels, 3, generator=generator)
        self.block1 = ConvBNReLU(encoder_channels[-4], 48, 1, generator=generator, padding=0)
        self.block2 = SeparableConvBNReLU(out_channels + 48, out_channels, 3,
                                          generator=generator)

    def forward(self, features, train: bool = False, dropout=None):
        y = self.aspp_sep(self.aspp(features[-1], train, dropout))
        y = upsample_bilinear_ac(y, scale=self.scale)
        hi = self.block1(features[-4])
        if y.shape[-2:] != hi.shape[-2:]:
            y = resize_bilinear(y, hi.shape[-2:])
        return self.block2(torch.cat([y, hi], dim=1))


@register("deeplabv3")
class DeepLabV3(nn.Module):
    """ASPP (not separable, rates 12/24/36) on the deepest feature of an
    output-stride-32 encoder, a 3x3 ConvBNReLU and a 1x1 head upsampled
    x``upsampling``.  ``forward(x, train=False, dropout=None)`` -> logits."""

    def __init__(self, encoder_name: str, num_classes: int,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: int = 256, depth: int = 5, upsampling: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder, enc_ch = make_encoder(encoder_name, in_channels, depth,
                                            generator=generator)
        self.aspp = ASPP(enc_ch[-1], decoder_channels, generator=generator)
        self.conv = ConvBNReLU(decoder_channels, decoder_channels, 3, generator=generator)
        self.segmentation_head = SegmentationHead(decoder_channels, num_classes, 1, upsampling,
                                                  generator=generator)

    def forward(self, x, train: bool = False, dropout=None):
        y = self.aspp(self.encoder(x)[-1], train, dropout)
        return self.segmentation_head(self.conv(y))


@register("deeplabv3plus")
class DeepLabV3Plus(nn.Module):
    """An output-stride-16 (or 8) encoder, ``DeepLabV3PlusDecoder`` and a
    1x1 head upsampled x``upsampling``, then resized to the input where it
    differs.  ``forward(x, train=False, dropout=None)`` -> (logits, None)."""

    def __init__(self, encoder_name: str, num_classes: int,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: int = 256, depth: int = 5, encoder_output_stride: int = 16,
                 decoder_atrous_rates: Sequence[int] = (12, 24, 36), upsampling: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder, enc_ch = make_encoder(encoder_name, in_channels, depth,
                                            generator=generator,
                                            output_stride=encoder_output_stride)
        self.decoder = DeepLabV3PlusDecoder(enc_ch, decoder_channels, tuple(decoder_atrous_rates),
                                            encoder_output_stride, generator)
        self.segmentation_head = SegmentationHead(decoder_channels, num_classes, 1, upsampling,
                                                  generator=generator)

    def _logits(self, x, features, train: bool, dropout):
        out = self.segmentation_head(self.decoder(features, train, dropout))
        if out.shape[-2:] != x.shape[-2:]:
            out = resize_bilinear(out, x.shape[-2:])
        return out

    def forward(self, x, train: bool = False, dropout=None):
        return self._logits(x, self.encoder(x), train, dropout), None


@register("unimatch")
class UniMatch(DeepLabV3Plus):
    """``deeplabv3plus`` with UniMatch's feature-perturbation forward.
    ``forward(x, need_fp=False, train=False, dropout=None, fp_dropout=None)``
    -> (logits, None), or with ``need_fp`` (logits, perturbed logits): the
    stride-2 feature ``feats[1]`` and the deepest ``feats[-1]`` go through
    dropout 0.5 (``fp_dropout``: None or a callable ``shape -> keep``,
    called for ``feats[1]`` and then ``feats[-1]``), and the clean and
    perturbed feature lists are concatenated along the batch before the
    decoder, so its BNs and its ASPP dropout (``dropout``) see 2N rows."""

    def forward(self, x, need_fp: bool = False, train: bool = False, dropout=None,
                fp_dropout=None):
        feats = self.encoder(x)
        if not need_fp:
            return self._logits(x, feats, train, dropout), None
        fp = list(feats)
        fp[1] = apply_dropout(feats[1], 0.5, fp_dropout) if train else feats[1]
        fp[-1] = apply_dropout(feats[-1], 0.5, fp_dropout) if train else feats[-1]
        out = self._logits(x, [torch.cat([a, b]) for a, b in zip(feats, fp)], train, dropout)
        return out[: x.shape[0]], out[x.shape[0]:]
