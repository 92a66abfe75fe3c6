"""Loss registry, counterpart of the JAX package's ``losses/__init__.py``:
NCHW logits and (N, H, W) integer targets; also the supervised-contrastive
and diagonal-cosine losses of the ``supconcps`` and ``semiweed`` trainers;
``make_loss_as_func`` and ``compute_class_weight``."""
from __future__ import annotations

import torch

from .contrastive import SupConLoss, supcon_loss
from .cross_entropy import cross_entropy_loss, nll_loss
from .dc import DCLoss, dc_loss
from .dice import DiceLoss, dice_coefficient, dice_loss
from .focal import FocalLoss, focal_loss

__all__ = ["make_loss", "make_loss_as_func", "compute_class_weight", "cross_entropy_loss",
           "nll_loss", "dice_loss", "dice_coefficient", "DiceLoss", "focal_loss", "FocalLoss", "supcon_loss", "SupConLoss", "dc_loss",
           "DCLoss"]


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
        return FocalLoss(num_classes, ignore_index=ignore_index, weight=weight)
    raise ValueError(f"unknown loss {loss_name!r}")


loss_func_dict = {
    "cross_entropy": cross_entropy_loss,
    "dice_loss": dice_loss,
    "focal_loss": focal_loss,
    "nll_loss": nll_loss,
}


def make_loss_as_func(loss_name: str):
    return loss_func_dict[loss_name]


def compute_class_weight(num_classes: int, y: torch.Tensor) -> torch.Tensor:
    """Inverse-frequency class weights, ``1 - count / total`` over the
    labels in ``[0, num_classes)``: other values (the 255 ignore label) are
    dropped, as ``jnp.bincount(..., length=num_classes)`` drops them."""
    y = y.reshape(-1)
    y = y[(y >= 0) & (y < num_classes)]
    counts = torch.bincount(y, minlength=num_classes)
    return 1.0 - counts / counts.sum()
