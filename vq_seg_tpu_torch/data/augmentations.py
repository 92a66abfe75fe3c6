"""Batch augmentations, counterpart of the JAX package's
``data/augmentations.py``: ``make_cutout_mask``, ``CutMix``, ``CutOut``,
``augmentation`` and the dihedral ``similarity_transform`` with its
inverse.

One box per batch, drawn on the host from an explicit CPU
``torch.Generator`` with the JAX package's distribution: the box's width
uniform in [int(W * ratio) + 1, W), its height floor(H * W * ratio /
width) (the quotient taken in f32), its corner uniform over the positions
that keep it inside.  The mask is 0 inside the box and 1 outside; CutMix
mixes each batch item with the next, ``x * m + roll(x, -1, 0) * (1 - m)``.
NCHW images and (N, H, W) label maps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import batch_roll


def make_cutout_mask(generator: torch.Generator, img_size: Tuple[int, int], ratio: float,
                     device=None) -> torch.Tensor:
    """One (H, W) int32 mask, 0 on a box of area about ``ratio * H * W``
    and 1 elsewhere, on ``device`` (the CPU by default)."""
    h, w = img_size

    def randint(low: int, high: int) -> int:
        return int(torch.randint(low, high, (), generator=generator))

    cut_w = randint(int(w * ratio) + 1, w)
    cut_h = int(np.floor_divide(np.float32(h * w * ratio), np.float32(cut_w)))
    x1 = randint(0, w - cut_w + 1)
    y1 = randint(0, h - cut_h + 1)
    mask = torch.ones(h, w, dtype=torch.int32)
    mask[y1:y1 + cut_h, x1:x1 + cut_w] = 0
    return mask.to(device) if device is not None else mask


def _broadcast(mask: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """The (H, W) mask in ``batch``'s dtype, shaped to multiply an NCHW or
    an (N, H, W) batch."""
    m = mask.to(device=batch.device, dtype=batch.dtype)
    return m[None, None] if batch.dim() == 4 else m[None]


def cutmix(batch: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``batch[i] * mask + batch[i + 1] * (1 - mask)``, the last item mixed
    with the first, in ``batch``'s dtype (integer labels stay integers).
    Inside ``parallel.data_parallel`` i runs over the global batch: each
    rank's last item mixes with the next rank's first (``batch_roll``)."""
    m = _broadcast(mask, batch)
    return batch * m + batch_roll(batch) * (1 - m)


class CutMix:
    """``cutmix`` with a box drawn per call unless ``mask`` is passed (to
    mix several tensors with one box).  Returns (mixed, mask)."""

    def __init__(self, ratio: float):
        self.ratio = ratio

    def __call__(self, generator: Optional[torch.Generator], batch: torch.Tensor,
                 mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = make_cutout_mask(generator, tuple(batch.shape[-2:]), self.ratio)
        return cutmix(batch, mask), mask


class CutOut:
    """``batch[i] * mask``.  Returns (masked, mask)."""

    def __init__(self, ratio: float):
        self.ratio = ratio

    def __call__(self, generator: Optional[torch.Generator], batch: torch.Tensor,
                 mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = make_cutout_mask(generator, tuple(batch.shape[-2:]), self.ratio)
        return batch * _broadcast(mask, batch), mask


def augmentation(generator: Optional[torch.Generator], inputs: torch.Tensor, label: torch.Tensor,
                 logits: torch.Tensor, aug_cfg, ignore_index: int = 255, mask=None):
    """Joint input/label/logits augmentation with one box: ``cutout`` zeroes
    the box in the inputs and logits and sets the labels there to
    ``ignore_index``; ``cutmix`` mixes each item with the next inside it.
    NCHW inputs and logits, (N, H, W) labels; ``aug_cfg`` has ``name`` and
    ``ratio``.  The box is drawn from ``generator`` unless ``mask`` is
    given.  Returns (inputs, label, logits)."""
    name = aug_cfg["name"] if isinstance(aug_cfg, dict) else aug_cfg.name
    ratio = aug_cfg["ratio"] if isinstance(aug_cfg, dict) else aug_cfg.ratio
    if mask is None:
        mask = make_cutout_mask(generator, tuple(inputs.shape[-2:]), ratio)
    mask = mask.to(inputs.device)
    if name == "cutout":
        label = torch.where(mask[None] == 0, torch.full_like(label, ignore_index), label)
        return inputs * _broadcast(mask, inputs), label, logits * _broadcast(mask, logits)
    if name == "cutmix":
        return cutmix(inputs, mask), cutmix(label, mask), cutmix(logits, mask)
    raise ValueError(name)


def similarity_transform(generator: Optional[torch.Generator], x: torch.Tensor,
                         aug: Optional[int] = None):
    """The reference's 8-case dihedral transform.  Returns (transformed,
    aug id, angle).  ``aug`` is drawn uniform in [0, 10) from ``generator``
    unless given.  As in the reference (and the JAX package), only case 1
    (width flip) and case 2 (height flip) change ``x``; cases 3-8 draw an
    angle uniform in [0, 90) (negated for 4, 6 and 8), which only the
    inverse reads.  Channel-first (N, C, H, W) or (C, H, W), or (H, W): the
    width is the last axis (the JAX package's NHWC and HWC put it second
    to last)."""
    if aug is None:
        aug = int(torch.randint(0, 10, (), generator=generator))
    angle = 0.0
    if aug == 1:
        x = torch.flip(x, dims=(-1,))
    elif aug == 2:
        x = torch.flip(x, dims=(-2,))
    elif aug >= 3:
        angle = float(torch.rand((), generator=generator)) * 90.0
        if aug in (4, 6, 8):
            angle = -angle
    return x, aug, angle


def inverse_similarity_transform(x: torch.Tensor, aug: int, angle: float) -> torch.Tensor:
    """Undo ``similarity_transform``'s flips; cases 5-8 flip as the
    reference's inverse does (the width for 5 and 6, the height for 7 and
    8), although the forward left those inputs as they were."""
    if aug in (1, 5, 6):
        return torch.flip(x, dims=(-1,))
    if aug in (2, 7, 8):
        return torch.flip(x, dims=(-2,))
    return x
