"""Dice loss, counterpart of the JAX package's ``losses/dice.py``, NCHW.

The reference's ignore quirk is kept (PARITY.md): ignored pixels get their
logits zeroed and their target forced to class 0, so they still add the
class-0 one-hot to the denominator.  Computed in f32 with autocast off.
"""
from __future__ import annotations

import torch

from ..parallel.collectives import batch_mean
from ..utils.seg_tools import one_hot


def dice_coefficient(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                     ignore_index=None) -> torch.Tensor:
    """pred (N, C, H, W) logits; target (N, H, W) integers -> per-class dice
    (C,), averaged over the batch (the global batch inside
    ``parallel.data_parallel``)."""
    with torch.autocast(pred.device.type, enabled=False):
        n, c = pred.shape[:2]
        pred = pred.reshape(n, c, -1).float()
        target = target.reshape(n, -1)
        if ignore_index is not None:
            mask = target != ignore_index
            pred = pred * mask.unsqueeze(1)
            target = target * mask
        if num_classes == 1:
            tgt = target.float().unsqueeze(1)
            prd = torch.sigmoid(pred)
        else:
            tgt = one_hot(target, num_classes, 1)
            prd = torch.softmax(pred, dim=1)
        inter = torch.sum(prd * tgt, dim=2)  # (N, C)
        sum_sets = torch.sum(prd + tgt, dim=2)
        return batch_mean(2 * inter / (sum_sets + 1e-6), dim=0)


def dice_loss(pred: torch.Tensor, target: torch.Tensor, num_classes: int = 3, weight=None,
              ignore_index=None) -> torch.Tensor:
    dice = dice_coefficient(pred, target, num_classes, ignore_index)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32, device=dice.device)
        return torch.sum((1.0 - dice) * w / torch.sum(w)) / num_classes
    return 1.0 - torch.mean(dice)


class DiceLoss:
    """Callable ``dice_loss`` with its class count, weights and ignore index."""

    def __init__(self, num_classes: int, weight=None, ignore_index=None):
        self.num_classes = num_classes
        self.weight = weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target):
        return dice_loss(pred, target, self.num_classes, self.weight, self.ignore_index)
