"""U-Nets of the JAX package's ``models/networks/unet.py``: the supervised
baseline ``Unet``, the textbook ``UnetOriginal``, the angular-head
networks ``VQASHUnet``, ``VQASHUnetv2``, ``VQRePTUnetAngular`` and
``VQRePTUnetAngularv3``, ``VQUnetwithSalientloss`` with its saliency
decoder, and ``SupConVQUnet`` with its pixel supervised-contrastive loss.

``Unet``: a ``VQUnetCore`` with no VQ and a zero-padded encoder, a 3x3 head
with bias, then the x2 align-corners upsample; the forward returns bare
logits.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...losses.contrastive import supcon_loss
from ..layers import ConvBNReLU, ConvPad, resize_bilinear, torch_conv_default
from ..layers import upsample_bilinear_ac
from ..modules.heads import (AngularSegmentationHead, AngularSegmentationHeadv2,
                             AngularSegmentationHeadv3)
from . import register
from .vq_unet import VQUnetCore, _head_out, _vq_head, self_entropy
from .vqvae import _conv_transpose


@register("unet")
class Unet(nn.Module):
    """``forward(x, train=False)`` -> (N, num_classes, H, W) logits;
    ``train`` is accepted for the trainers' uniform call and changes
    nothing (the BN mode is the module's own)."""

    def __init__(self, encoder_name: str, num_classes: int, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, encoder_weights: Optional[str] = None,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, None, in_channels, decoder_channels, depth,
                               bn_eps=bn_eps, bn_momentum=bn_momentum, generator=generator)
        self.segmentation_head = ConvPad(self.core.decoder_channels[-1], num_classes, 3, 1, 1,
                                         bias=True, init=torch_conv_default, generator=generator)

    def forward(self, x, train: bool = False):
        dec, _, _ = self.core(x)
        out = self.segmentation_head(dec)
        if self.upsampling > 1:
            out = upsample_bilinear_ac(out, scale=self.upsampling)
        return out


class DBConv(nn.Sequential):
    """Two VALID 3x3 ``ConvBNReLU``s whose convs have a bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(*(ConvBNReLU(c, out_channels, 3, generator=generator, padding=0,
                                      bias=True) for c in (in_channels, out_channels)))


@register("unetoriginal")
class UnetOriginal(nn.Module):
    """The textbook 2015 U-Net: the input reflect-padded by 4 (and up to a
    multiple of 4 at the bottom and right), four ``DBConv`` + 2x2 max-pool
    contractions from ``first_outchannels``, a ``DBConv`` bottleneck, four
    expansions (flax's ``ConvTranspose((2, 2), strides=2)``, i.e.
    ``ConvTranspose2d(k=2, s=2, p=0)`` with the flax kernel flipped and its
    in/out axes swapped; centre zero-padding to the skip, the skip
    concatenated after it, a ``DBConv``), a 1x1 head with bias, and the
    crop back to the input's size.  ``forward(x, train=False)`` ->
    (logits, None); ``train`` changes nothing (the BN mode is the
    module's own).  ``upsampling`` and ``bn_eps``/``bn_momentum`` (the
    trainers' decoder BN settings) are accepted and not read, as in the
    JAX package."""

    def __init__(self, num_classes: int = 3, in_channels: int = 3, first_outchannels: int = 64,
                 upsampling: int = 1, bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = first_outchannels
        chans = (f, f * 2, f * 4, f * 8)
        self.contract = nn.ModuleList(DBConv(i, o, generator)
                                      for i, o in zip((in_channels,) + chans[:-1], chans))
        self.bottleneck = DBConv(f * 8, f * 16, generator)
        ups = (f * 16,) + chans[::-1][:-1]
        self.upconv = nn.ModuleList(_conv_transpose(i, o, generator, kernel_size=2, padding=0)
                                    for i, o in zip(ups, chans[::-1]))
        self.expand = nn.ModuleList(DBConv(2 * c, c, generator) for c in chans[::-1])
        self.segmentation_head = ConvPad(f, num_classes, 1, bias=True, init=torch_conv_default,
                                         generator=generator)

    def forward(self, x, train: bool = False):
        h, w = x.shape[-2:]
        padh, padw = (4 - h % 4) % 4, (4 - w % 4) % 4
        y = F.pad(x, (4, padw + 4, 4, padh + 4), mode="reflect")
        skips = []
        for block in self.contract:
            y = block(y)
            skips.append(y)
            y = F.max_pool2d(y, 2, 2)
        y = self.bottleneck(y)
        for up, block, skip in zip(self.upconv, self.expand, skips[::-1]):
            y = up(y)
            dh, dw = skip.shape[-2] - y.shape[-2], skip.shape[-1] - y.shape[-1]
            y = F.pad(y, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            y = block(torch.cat([y, skip], dim=1))
        return self.segmentation_head(y)[..., :h, :w], None


@register("VQUnetwithSalientloss")
class VQUnetwithSalientloss(nn.Module):
    """A VQ U-Net (zero-padded encoder, ``_VQHead``: a 3x3 head with bias
    and the x2 upsample) with an auxiliary saliency decoder on the deepest
    quantized stage: ``ConvBNReLU`` to 512, 256, 64 and 32 channels, each
    followed by a x2 half-pixel bilinear resize, then a bias-free 3x3 conv
    to one channel and a sigmoid.  ``forward(x, train=False,
    init_codebook=False, generator=None)`` -> (out, commit, usage) with
    ``train`` false, else (out, commit, usage, saliency (N, 1, H/2,
    W/2))."""

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, encoder_weights: Optional[str] = None,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, vq_cfg, in_channels, decoder_channels, depth,
                               bn_eps=bn_eps, bn_momentum=bn_momentum, generator=generator)
        self.segmentation_head = _vq_head(self.core.decoder_channels[-1], num_classes, generator)
        enc_ch = self.core.encoder.encoder_channels()
        chans = (512, 256, 64, 32)
        self.salient_decoder = nn.ModuleList(
            ConvBNReLU(i, o, 3, generator=generator)
            for i, o in zip((enc_ch[-1],) + chans[:-1], chans))
        self.salient_out = ConvPad(32, 1, 3, 1, 1, bias=False, generator=generator)

    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        self.core.init_codebook_(x, generator)

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        dec, commit, usage, feats = self.core(x, train=train, init_codebook=init_codebook,
                                              generator=generator, return_features=True)
        out = _head_out(self.segmentation_head, dec, self.upsampling)
        if not train:
            return out, commit, usage
        aux = feats[-1]
        for block in self.salient_decoder:
            aux = block(aux)
            aux = resize_bilinear(aux, (aux.shape[-2] * 2, aux.shape[-1] * 2))
        return out, commit, usage, torch.sigmoid(self.salient_out(aux))


@register("vqashunet")
class VQASHUnet(nn.Module):
    """A VQ U-Net trunk (reflect-padded encoder for ``head_version`` 1,
    zero-padded for 2) under an angular head: ``AngularSegmentationHead``
    (v1, 3x3 conv, upsample, then the cosines) or
    ``AngularSegmentationHeadv2`` (v2, 1x1 conv, the cosines, then the
    upsample of the scores; its commitment term weighted by
    ``seghead_commit_weight`` inside the head's loss).  The head returns
    softmax probabilities, which a criterion softmaxes again.
    ``use_feature`` is accepted and not read.  ``forward(x, gt=None,
    train=False, init_codebook=False, init_protos=False, generator=None)``
    -> (scores, commit, usage, angular loss)."""

    head_version = 1

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg, margin: float = 1.5,
                 scale: float = 1.0, use_feature: bool = False,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, seghead_commit_weight: float = 1.0, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        v1 = self.head_version == 1
        self.core = VQUnetCore(encoder_name, vq_cfg, in_channels, decoder_channels, depth,
                               padding_mode="reflect" if v1 else "zeros",
                               bn_eps=bn_eps, bn_momentum=bn_momentum, generator=generator)
        ch = self.core.decoder_channels[-1]
        if v1:
            self.segmentation_head = AngularSegmentationHead(
                ch, num_classes, embedding_dim=ch, out_channels=ch, scale=scale, margin=margin,
                upsampling=upsampling, generator=generator)
        else:
            self.segmentation_head = AngularSegmentationHeadv2(
                ch, num_classes, out_channels=ch, scale=scale, margin=margin,
                upsampling=upsampling, commit_weight=seghead_commit_weight, generator=generator)

    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        self.core.init_codebook_(x, generator)

    def forward(self, x, gt=None, train: bool = False, init_codebook: bool = False,
                init_protos: bool = False, generator: Optional[torch.Generator] = None):
        """``gt``: (N, H, W) integer labels at the input size, used with
        ``train``."""
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        out, angular = self.segmentation_head(dec, gt, train=train, init_protos=init_protos,
                                              generator=generator)
        return out, commit, usage, angular


@register("vqashunetv2")
class VQASHUnetv2(VQASHUnet):
    """``VQASHUnet`` with the v2 head and a zero-padded encoder."""

    head_version = 2


class _AngularPTNet(nn.Module):
    """The reflect-padded VQ trunk under an angular head at the decoder's
    resolution (1x1 conv, no upsample inside the head); the x``upsampling``
    align-corners upsample applies to the output scores only, so the
    angular loss is taken on the decoder grid.  ``use_feature`` and
    ``encoder_weights`` are accepted and not read by the network."""

    head_cls = AngularSegmentationHeadv2

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg, margin: float = 1.5,
                 scale: float = 1.0, use_feature: bool = False,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, pt_init: str = "kmeans", bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, vq_cfg, in_channels, decoder_channels, depth,
                               padding_mode="reflect", bn_eps=bn_eps, bn_momentum=bn_momentum,
                               generator=generator)
        ch = self.core.decoder_channels[-1]
        self.segmentation_head = self.head_cls(ch, num_classes, out_channels=ch, scale=scale,
                                               margin=margin, kernel_size=1, upsampling=1,
                                               pt_init=pt_init, generator=generator)

    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        self.core.init_codebook_(x, generator)

    def _out(self, out):
        return upsample_bilinear_ac(out, scale=self.upsampling) if self.upsampling > 1 else out


@register("vqreptunetangular")
class VQRePTUnetAngular(_AngularPTNet):
    """``AngularSegmentationHeadv2`` whose rows are filtered by the entropy
    of the head's own scores: in training with ``gt`` a preliminary eval
    pass of the head (no gradient, nothing updated) gives the entropy, then
    the real pass keeps the rows below its ``percent``-ile.  ``forward(x,
    gt=None, percent=None, train=False, init_codebook=False,
    init_protos=False, generator=None)`` -> (scores, commit, usage, angular
    loss), the ``reptcps`` signature."""

    def forward(self, x, gt=None, percent=None, train: bool = False,
                init_codebook: bool = False, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        entropy = None
        if train and gt is not None:
            with torch.no_grad():
                pre, _ = self.segmentation_head(dec, None, train=False)
            entropy = self_entropy(pre)
        out, angular = self.segmentation_head(
            dec, gt, percent if percent is not None else 100.0, entropy, train=train,
            init_protos=init_protos, generator=generator)
        return self._out(out), commit, usage, angular


@register("vqreptunetangularv3")
class VQRePTUnetAngularv3(_AngularPTNet):
    """``AngularSegmentationHeadv3``: ``forward(x, pred=None,
    split="labeled", th=0.0, train=False, init_codebook=False,
    init_protos=False, generator=None)`` -> (scores, commit, usage, angular
    loss); ``pred`` is the labels on the ``"labeled"`` split and the other
    model's score map on ``"unlabeled"``, masked at ``th``."""

    head_cls = AngularSegmentationHeadv3

    def forward(self, x, pred=None, split: str = "labeled", th=0.0, train: bool = False,
                init_codebook: bool = False, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        out, angular = self.segmentation_head(dec, pred, split, th, train=train,
                                              init_protos=init_protos, generator=generator)
        return self._out(out), commit, usage, angular


@register("supconvqunet")
class SupConVQUnet(nn.Module):
    """A zero-padded VQ trunk, a 3x3 head with bias, the x``upsampling``
    upsample and the softmax over classes; in training on the ``"label"``
    split with ``gt`` the supervised-contrastive loss of the first two
    items' decoder features (``losses/contrastive.py``).  ``use_feature`` is
    accepted and not read.  ``forward(x, gt=None, split=None, train=False,
    init_codebook=False, generator=None)`` -> (scores, commit, usage,
    contrastive loss)."""

    def __init__(self, encoder_name: str, num_classes: int, vq_cfg, use_feature: bool = False,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: Optional[Sequence[int]] = None, depth: int = 5,
                 upsampling: int = 2, bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsampling = upsampling
        self.core = VQUnetCore(encoder_name, vq_cfg, in_channels, decoder_channels, depth,
                               bn_eps=bn_eps, bn_momentum=bn_momentum, generator=generator)
        self.segmentation_head = _vq_head(self.core.decoder_channels[-1], num_classes, generator)

    def init_codebook_(self, x: torch.Tensor, generator: torch.Generator):
        self.core.init_codebook_(x, generator)

    def forward(self, x, gt=None, split: Optional[str] = None, train: bool = False,
                init_codebook: bool = False, generator: Optional[torch.Generator] = None):
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        aux = x.new_zeros((), dtype=torch.float32)
        if train and split == "label" and gt is not None:
            aux = supcon_loss(dec, gt)
        out = torch.softmax(_head_out(self.segmentation_head, dec, self.upsampling), dim=1)
        return out, commit, usage, aux
