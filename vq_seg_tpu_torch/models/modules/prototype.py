"""Class-prototype loss of the flagship, counterpart of the JAX package's
``models/modules/prototype.py`` (the helpers, ``_ProtoBase`` and
``ReliablePrototypeLossv2``; the other prototype losses are in ROADMAP.md,
queue 1, "The rest of the model zoo").

  * The prototype table is an ``nn.Parameter`` (K, C), drawn normal(0, 1)
    (``pt_init`` normal, kmeans or class_means) or uniform in +-1/K.
  * Its data-dependent init is an explicit phase: a forward with
    ``init_protos=True`` overwrites the table with the k-means (10
    iterations) or the class means of this batch's rows, then computes the
    loss with it.
  * The loss runs in f32 with autocast off, on rows flattened in (n, h, w)
    order as the JAX package flattens NHWC.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ...ops.kmeans import kmeans, l2norm
from ..layers import resize_bilinear, resize_nearest


def orthogonal_loss_fn(t: torch.Tensor) -> torch.Tensor:
    """Eq. (2) of arXiv:2112.00384 over the rows of t."""
    n = t.shape[0]
    normed = l2norm(t)
    cos = normed @ normed.T
    return torch.sum(cos ** 2) / (n ** 2) - 1.0 / n


def arcface_phi(cosine: torch.Tensor, margin: float, easy_margin: bool) -> torch.Tensor:
    """phi = cos(theta + m), with the easy or hard margin fallback."""
    cos_m, sin_m = math.cos(margin), math.sin(margin)
    th = math.cos(math.pi - margin)
    mm = math.sin(math.pi - margin) * margin
    sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 0.0, 1.0))
    phi = cosine * cos_m - sine * sin_m
    if easy_margin:
        return torch.where(cosine > 0, phi, cosine)
    return torch.where(cosine > th, phi, cosine - mm)


def eps_softmax_ce(logits: torch.Tensor, positive: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-mean(log(exp(pos) / (sum exp + 1e-7) + 1e-7) [* mask]) over the
    last dim of ``logits``."""
    sum_all = torch.sum(torch.exp(logits), dim=-1)
    lg = torch.log(torch.exp(positive) / (sum_all + 1e-7) + 1e-7)
    if mask is not None:
        lg = lg * mask
    return -torch.mean(lg)


def _flatten_with_gt(x: torch.Tensor, gt: torch.Tensor):
    """(N, C, h, w) features and (N, H, W) labels -> (N*h*w, C) f32 rows and
    (N*h*w,) int64 labels, the labels resized nearest (floor-indexed) to the
    feature grid."""
    n, c, h, w = x.shape
    if tuple(gt.shape[1:]) != (h, w):
        gt = resize_nearest(gt, (h, w))
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c).float(), gt.reshape(-1).long()


def class_mean_features(flat_x: torch.Tensor, flat_gt: torch.Tensor, num_classes: int):
    """Per-class mean row; a class with no rows gets zeros."""
    sums = torch.zeros(num_classes, flat_x.shape[1], dtype=flat_x.dtype, device=flat_x.device)
    sums.index_add_(0, flat_gt, flat_x)
    cnt = torch.zeros(num_classes, dtype=flat_x.dtype, device=flat_x.device)
    cnt.index_add_(0, flat_gt, torch.ones_like(flat_gt, dtype=flat_x.dtype))
    return sums / cnt.clamp_min(1.0)[:, None]


class _ProtoBase(nn.Module):
    """The prototype table and its explicit init phase."""

    def __init__(self, num_classes: int = 3, embedding_dim: int = 0, pt_init: str = "kmeans",
                 use_feature: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        k = num_classes
        if pt_init == "uniform":
            table = torch.empty(k, embedding_dim).uniform_(-1.0 / k, 1.0 / k, generator=generator)
        elif pt_init in ("normal", "kmeans", "class_means"):
            table = torch.randn(k, embedding_dim, generator=generator)
        else:
            raise ValueError("init has to be in [uniform, normal, kmeans, class_means]")
        self.num_classes = num_classes
        self.pt_init = pt_init
        self.use_feature = use_feature
        self.embedding = nn.Parameter(table)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        # a tree from an eval-mode init has no table (the JAX package creates
        # it on the first forward with gt): the drawn table stays, and the
        # init phase overwrites it.  A table that is present is loaded.
        key = prefix + "embedding"
        n_missing = len(missing_keys)
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys,
                                      unexpected_keys, error_msgs)
        if key not in state_dict and key in missing_keys[n_missing:]:
            missing_keys.remove(key)

    @torch.no_grad()
    def _init_table(self, flat_x, flat_gt, generator: Optional[torch.Generator]):
        if self.pt_init == "kmeans":
            if generator is None:
                raise ValueError("the k-means prototype init needs a generator")
            means, _ = kmeans(flat_x, self.num_classes, 10, generator=generator)
        elif self.pt_init == "class_means":
            means = class_mean_features(flat_x, flat_gt, self.num_classes)
        else:
            return
        self.embedding.copy_(means)

    def _table(self, flat_x, flat_gt, init_protos: bool, generator):
        if init_protos:
            self._init_table(flat_x, flat_gt, generator)
        if self.use_feature:
            return class_mean_features(flat_x, flat_gt, self.num_classes).detach()
        return self.embedding


class ReliablePrototypeLossv2(_ProtoBase):
    """The flagship's confidence-masked ArcFace prototype loss.

    ``gt`` is (N, H, W) integer labels, or an (N, C, H, W) score map: the
    map is resized bilinear (half-pixel, no antialias) to the feature grid,
    its argmax is the label and pixels whose largest softmax probability is
    at most ``th`` are masked out.  The margin is multiplicative at the gt
    logit (``cos_gt <- cos_gt * phi_gt``, PARITY.md).  The l2-normalised
    live table gets gradients."""

    def __init__(self, num_classes: int = 3, embedding_dim: int = 0, pt_init: str = "kmeans",
                 use_feature: bool = False, scale: float = 1.0, margin: float = 0.5,
                 easy_margin: bool = True, orthogonal_reg_weight: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, embedding_dim, pt_init, use_feature, generator)
        self.scale = scale
        self.margin = margin
        self.easy_margin = easy_margin
        self.orthogonal_reg_weight = orthogonal_reg_weight

    def forward(self, x: torch.Tensor, gt: torch.Tensor, th: Optional[float] = None,
                init_protos: bool = False, generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            h, w = x.shape[-2:]
            confidence_mask = None
            if gt.dim() == 4:  # a score map
                pred = gt.float()
                if tuple(pred.shape[-2:]) != (h, w):
                    pred = resize_bilinear(pred, (h, w))
                prob = torch.softmax(pred, dim=1)
                confidence_mask = (prob.amax(dim=1) > th).float().reshape(-1)
                gt = torch.argmax(pred, dim=1)
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator)
            # class-major (K, M) cosines, as in the JAX package
            cosine = l2norm(table) @ l2norm(flat_x).T
            phi = arcface_phi(cosine, self.margin, self.easy_margin)
            gt_onehot = torch.arange(self.num_classes, device=x.device)[:, None] == flat_gt[None, :]
            cosine = self.scale * torch.where(gt_onehot, cosine * phi, cosine)
            positive = torch.sum(torch.where(gt_onehot, cosine, torch.zeros_like(cosine)), dim=0)
            sum_all = torch.sum(torch.exp(cosine), dim=0)
            lg = torch.log(torch.exp(positive) / (sum_all + 1e-7) + 1e-7)
            if confidence_mask is not None:
                lg = lg * confidence_mask
            loss = -torch.mean(lg)
            if self.orthogonal_reg_weight > 0:
                loss = loss + orthogonal_loss_fn(table) * self.orthogonal_reg_weight
        return loss
