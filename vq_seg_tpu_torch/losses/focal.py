"""Focal loss, counterpart of the JAX package's ``losses/focal.py``: NCHW
logits and (N, H, W) integer targets.

Two behaviours of the reference are kept:
  * ``FocalLoss`` applies the softmax (the sigmoid for one class), and
    ``focal_loss`` applies it again;
  * ignored pixels get zero logits and target 0 and stay in the sum; the
    log is clamped at 1e-12, so a zero probability gives a finite term.
"""
from __future__ import annotations

import torch

from ..parallel.collectives import batch_mean, batch_sum


def focal_loss(pred, target, alpha=0.25, gamma=2.0, num_classes: int = 3, ignore_index=None,
               reduction: str = "sum", weight=None):
    """``pred`` (N, C, H, W) logits, ``target`` (N, H, W) integers.
    ``reduction`` "none" gives the (N, H*W) terms; "mean" is the plain mean
    of the weighted terms (the reference divides by the weights' sum and
    then overwrites the result); "sum" their sum."""
    n, c = pred.shape[:2]
    pred = pred.float().reshape(n, c, -1).transpose(1, 2)  # (N, HW, C)
    target = target.reshape(n, -1)
    if ignore_index is not None:
        mask = target != ignore_index
        pred = pred * mask[..., None]
        target = target * mask
    p = torch.sigmoid(pred) if num_classes == 1 else torch.softmax(pred, dim=-1)
    onehot = (target[..., None] == torch.arange(num_classes, device=target.device)).to(p.dtype)
    if weight is not None:
        onehot = onehot * torch.as_tensor(weight, dtype=p.dtype, device=p.device)
    ce = -torch.log(torch.clamp_min(p, 1e-12))
    fl = torch.sum(alpha * (1.0 - p) ** gamma * ce * onehot, dim=-1)
    if reduction == "none":
        return fl
    if reduction == "mean":
        return batch_mean(fl)
    if reduction == "sum":
        return batch_sum(torch.sum(fl))
    raise NotImplementedError(f"Invalid reduction mode: {reduction}")


class FocalLoss:
    """``(pred, target) -> loss``: the softmax over classes (the sigmoid
    for one class), then ``focal_loss``, which applies it again."""

    def __init__(self, num_classes: int, alpha=0.25, gamma=2.0, ignore_index=-100,
                 reduction: str = "mean", weight=None):
        self.num_classes = num_classes
        self.alpha, self.gamma = alpha, gamma
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.weight = weight

    def __call__(self, pred, target):
        pred = torch.sigmoid(pred) if self.num_classes == 1 else torch.softmax(pred, dim=1)
        return focal_loss(pred, target, self.alpha, self.gamma, self.num_classes,
                          self.ignore_index, self.reduction, self.weight)
