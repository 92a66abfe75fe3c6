"""Ablation networks, counterpart of the JAX package's
``models/networks/ablation.py``: the flagship's ``_PTNet`` trunk
(reflect-padded encoder, per-stage VQ, U-Net decoder) and bias-free 1x1
head, with the prototype loss switched off (``nopt``: a constant 0 where it
would be) or replaced by the plain ``PrototypeLoss`` (``scheme6``).  Both
take the flagship's ``(x, gt, percent)`` call, so they train under the
flagship's CPS step and config with the name swapped; the percent is not
read.

Under CPS the unlabeled passes hand the other model's (N, C, H, W) score
map as ``gt``.  ``scheme6``'s plain loss wants integer labels, so it takes
the map's argmax (the JAX package flattens the map as if it were labels
and fails on the shapes, ROADMAP.md section 3).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..layers import upsample_bilinear_ac
from . import register
from .vq_unet import _PTNet


class _AblationNet(_PTNet):
    head_kernel = 1
    head_bias = False

    def forward(self, x, gt=None, percent=None, train: bool = False,
                init_codebook: bool = False, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        """``forward(x, gt=None, percent=None, train=False, init_codebook=False,
        init_protos=False, generator=None)`` -> (out, commit, usage, proto)."""
        dec, commit, usage = self.core(x, train=train, init_codebook=init_codebook,
                                       generator=generator)
        out = self.segmentation_head(dec)
        proto = x.new_zeros((), dtype=torch.float32)
        if self.prototype_loss is not None and train and gt is not None:
            if gt.dim() == 4:  # a score map: its argmax labels
                gt = torch.argmax(gt, dim=1)
            proto = self.prototype_loss(dec, gt, init_protos=init_protos, generator=generator)
        if self.upsampling > 1:
            out = upsample_bilinear_ac(out, scale=self.upsampling)
        return out, commit, usage, proto


@register("nopt")
class NoPT(_AblationNet):
    """The prototype loss off: ``proto`` is a constant 0."""

    proto_kind = None


@register("scheme6")
class Scheme6(_AblationNet):
    """The plain ``PrototypeLoss`` (ArcFace-margin CE over the cosines to
    the detached class prototypes)."""

    proto_kind = "prototype"
