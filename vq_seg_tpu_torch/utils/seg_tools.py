"""Label-map tools, counterpart of the JAX package's ``utils/seg_tools.py``.

NCHW throughout: score maps are (N, C, H, W) and label maps (N, H, W)
integers.  Nothing here leaves the device.
"""
from __future__ import annotations

from typing import Mapping

import torch

from ..config import pixel_to_label_lut


def img_to_label(target_img: torch.Tensor, pixel_to_label: Mapping) -> torch.Tensor:
    """Grayscale mask pixel values -> class ids (int64) through a 256-entry
    lookup table; unlisted values map to themselves."""
    lut = torch.from_numpy(pixel_to_label_lut(pixel_to_label)).long().to(target_img.device)
    return lut[target_img.long()]


def one_hot(target: torch.Tensor, num_classes: int, dim: int) -> torch.Tensor:
    """f32 one-hot along ``dim``; values outside [0, num_classes) give an
    all-zero row, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=target.device)
    shape = [1] * (target.dim() + 1)
    shape[dim] = num_classes
    return (target.unsqueeze(dim) == classes.view(shape)).float()


def label_to_onehot(target: torch.Tensor, num_classes: int, eps: float = 1e-6) -> torch.Tensor:
    """(N, H, W) labels -> (N, num_classes, H, W) one-hot + eps."""
    return one_hot(target, num_classes, 1) + eps


def onehot_1d(target: torch.Tensor, num_classes: int, eps: float = 1e-6) -> torch.Tensor:
    """(M,) labels -> (M, num_classes) one-hot + eps."""
    return one_hot(target.reshape(-1), num_classes, 1) + eps


def score_mask(pred: torch.Tensor, th: float = 0.7) -> torch.Tensor:
    """(N, C, H, W) scores -> (N, 1, H, W) int64: 1 where the largest
    softmax probability exceeds ``th``, else 0."""
    pmax = torch.softmax(pred.float(), dim=1).amax(dim=1, keepdim=True)
    return (pmax > th).long()


def confidence_filtered_pseudo(pred: torch.Tensor, pseudo: torch.Tensor, th: float = 0.7,
                               ignore_index: int = 255) -> torch.Tensor:
    """Pseudo-labels (N, H, W) with the pixels whose largest softmax
    probability of ``pred`` (N, C, H, W) is at most ``th`` set to
    ``ignore_index``."""
    pmax = torch.softmax(pred.float(), dim=1).amax(dim=1)
    return torch.where(pmax > th, pseudo, torch.full_like(pseudo, ignore_index))
