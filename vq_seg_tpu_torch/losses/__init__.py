"""Loss registry, counterpart of the JAX package's ``losses/__init__.py``:
NCHW logits and (N, H, W) integer targets."""
from __future__ import annotations

from .cross_entropy import cross_entropy_loss, nll_loss
from .dice import DiceLoss, dice_coefficient, dice_loss

__all__ = ["make_loss", "cross_entropy_loss", "nll_loss", "dice_loss", "dice_coefficient",
           "DiceLoss"]


class _CE:
    def __init__(self, ignore_index=-100, weight=None):
        self.ignore_index = ignore_index
        self.weight = weight

    def __call__(self, pred, target):
        return cross_entropy_loss(pred, target, self.ignore_index, self.weight)


class _NLL(_CE):
    def __call__(self, pred, target):
        return nll_loss(pred, target, self.ignore_index, self.weight)


def make_loss(loss_name: str, num_classes: int, ignore_index: int = -100, weight=None):
    """Name -> callable loss ``(pred, target) -> scalar``."""
    if loss_name == "cross_entropy":
        return _CE(ignore_index, weight)
    if loss_name == "nll_loss":
        return _NLL(ignore_index, weight)
    if loss_name == "dice_loss":
        return DiceLoss(num_classes, weight, ignore_index)
    if loss_name == "focal_loss":
        raise NotImplementedError(
            "focal_loss is not ported yet (ROADMAP.md, queue 1, 'Other losses and trainers')")
    raise ValueError(f"unknown loss {loss_name!r}")
