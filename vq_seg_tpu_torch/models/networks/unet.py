"""U-Nets of the JAX package's ``models/networks/unet.py``: the supervised
baseline ``Unet``, the angular-head networks ``VQASHUnet``,
``VQASHUnetv2``, ``VQRePTUnetAngular`` and ``VQRePTUnetAngularv3``, and
``SupConVQUnet`` with its pixel supervised-contrastive loss.  The saliency
and textbook U-Nets of that module are in ROADMAP.md, queue 1, "The rest of
the model zoo".

``Unet``: a ``VQUnetCore`` with no VQ and a zero-padded encoder, a 3x3 head
with bias, then the x2 align-corners upsample; the forward returns bare
logits.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ...losses.contrastive import supcon_loss
from ..layers import ConvPad, torch_conv_default, upsample_bilinear_ac
from ..modules.heads import (AngularSegmentationHead, AngularSegmentationHeadv2,
                             AngularSegmentationHeadv3)
from . import register
from .vq_unet import VQUnetCore, _head_out, _vq_head, self_entropy


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
