"""Class-prototype losses, counterpart of the JAX package's
``models/modules/prototype.py``: the helpers, ``entropy_mask``,
``_ProtoBase``, the flagship's ``ReliablePrototypeLossv2`` and the
entropy-filtered losses of the ``reptcps`` networks
(``ReliablePrototypeLoss``, ``ReliableEuclideanPrototypeLoss``,
``StableTemperaturedPrototypeLoss``, ``OnlyCWPrototypeLoss``) and the
(x, gt)-signature losses of the ``vqpt`` networks (``PrototypeLoss``,
``EuclideanPrototypeLoss``, ``LearnableEuclideanPrototypeLoss``,
``NEDPrototypeLoss``).

  * The prototype table is an ``nn.Parameter`` (K, C), drawn normal(0, 1)
    (``pt_init`` normal, kmeans or class_means) or uniform in +-1/K.
  * Its data-dependent init is an explicit phase: a forward with
    ``init_protos=True`` overwrites the table with the k-means (10
    iterations) or the class means of this batch's rows, then computes the
    loss with it.
  * The loss runs in f32 with autocast off, on rows flattened in (n, h, w)
    order as the JAX package flattens NHWC.
  * The entropy filter keeps the pixels whose entropy is at most its
    ``percent``-ile, taken on the device (``torch.quantile``, numpy's
    ``linear`` method, as ``jnp.percentile``), so nothing is read back.
  * Inside ``parallel.data_parallel`` the percentile, the class means, the
    k-means init and every loss's mean are those of the global batch.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ...ops.kmeans import kmeans, l2norm
from ...parallel.collectives import batch_gather, batch_mean, batch_sum
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
    return -batch_mean(lg)


def percentile(t: torch.Tensor, percent) -> torch.Tensor:
    """``jnp.percentile(t, percent)`` over all of ``t`` (method ``linear``),
    on the device, at the quantile ``jnp.percentile`` takes: ``percent``
    rounded to f32, then divided by 100.  ``torch.quantile`` refuses inputs
    above 2**24 elements; the largest here is the CPS pseudo-label filter's
    entropy map, (8, 448, 448) = 1,605,632 at the shipped configs' batch
    and size."""
    q = float(np.float32(percent)) / 100.0
    return torch.quantile(batch_gather(t.reshape(-1)), q, interpolation="linear")


def entropy_mask(entropy: torch.Tensor, percent) -> torch.Tensor:
    """Flat bool mask of the pixels whose entropy is at most the
    ``percent``-ile of ``entropy`` (computed detached)."""
    thresh = percentile(entropy.detach(), percent)
    return (entropy <= thresh).reshape(-1)


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
    sums = batch_sum(sums.index_add(0, flat_gt, flat_x))
    cnt = torch.zeros(num_classes, dtype=flat_x.dtype, device=flat_x.device)
    cnt = batch_sum(cnt.index_add_(0, flat_gt, torch.ones_like(flat_gt, dtype=flat_x.dtype)))
    return sums / cnt.clamp_min(1.0)[:, None]


class _ProtoBase(nn.Module):
    """The prototype table and its explicit init phase."""

    def __init__(self, num_classes: int = 3, embedding_dim: int = 0, pt_init: str = "kmeans",
                 use_feature: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        k = self.num_rows
        if pt_init == "uniform":
            table = torch.empty(k, embedding_dim).uniform_(-1.0 / k, 1.0 / k, generator=generator)
        elif pt_init in ("normal", "kmeans", "class_means"):
            table = torch.randn(k, embedding_dim, generator=generator)
        else:
            raise ValueError("init has to be in [uniform, normal, kmeans, class_means]")
        self.pt_init = pt_init
        self.use_feature = use_feature
        self.embedding = nn.Parameter(table)

    @property
    def num_rows(self) -> int:
        """Rows of the prototype table: one per class."""
        return self.num_classes

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        # a tree from an eval-mode init has no table (the JAX package creates
        # it, and a learnable alpha, on the first forward with gt): the drawn
        # values stay, and the init phase overwrites the table.  What is
        # present is loaded.
        n_missing = len(missing_keys)
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict, missing_keys,
                                      unexpected_keys, error_msgs)
        for key in [prefix + name for name in self._parameters]:
            if key not in state_dict and key in missing_keys[n_missing:]:
                missing_keys.remove(key)

    @torch.no_grad()
    def _init_table(self, flat_x, flat_gt, generator: Optional[torch.Generator]):
        if self.pt_init == "kmeans":
            if generator is None:
                raise ValueError("the k-means prototype init needs a generator")
            means, _ = kmeans(batch_gather(flat_x), self.num_classes, 10, generator=generator)
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


class _MarginProtoBase(_ProtoBase):
    """A prototype table with the ArcFace margin's settings."""

    def __init__(self, num_classes: int = 3, embedding_dim: int = 0, pt_init: str = "kmeans",
                 use_feature: bool = False, scale: float = 1.0, margin: float = 0.5,
                 easy_margin: bool = True, orthogonal_reg_weight: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, embedding_dim, pt_init, use_feature, generator)
        self.scale = scale
        self.margin = margin
        self.easy_margin = easy_margin
        self.orthogonal_reg_weight = orthogonal_reg_weight

    def _blended_logits(self, cosine: torch.Tensor, flat_gt: torch.Tensor):
        """The reference's eps-ed one-hot (+1e-6 everywhere) over the
        class-major (K, M) cosines, the additive blend ``onehot * phi + (1 -
        onehot) * cos`` when ``margin != 0``, then the scale.  Returns
        (logits, onehot); the eps leaks into the positive ``sum(logits *
        onehot)`` too."""
        onehot = _class_major_onehot(flat_gt, self.num_rows).float() + 1e-6
        if self.margin != 0:
            phi = arcface_phi(cosine, self.margin, self.easy_margin)
            cosine = onehot * phi + (1.0 - onehot) * cosine
        if self.scale != 1:
            cosine = self.scale * cosine
        return cosine, onehot


class ReliablePrototypeLossv2(_MarginProtoBase):
    """The flagship's confidence-masked ArcFace prototype loss.

    ``gt`` is (N, H, W) integer labels, or an (N, C, H, W) score map: the
    map is resized bilinear (half-pixel, no antialias) to the feature grid,
    its argmax is the label and pixels whose largest softmax probability is
    at most ``th`` are masked out.  The margin is multiplicative at the gt
    logit (``cos_gt <- cos_gt * phi_gt``, PARITY.md).  The l2-normalised
    live table gets gradients."""

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
            loss = -batch_mean(lg)
            if self.orthogonal_reg_weight > 0:
                loss = loss + orthogonal_loss_fn(table) * self.orthogonal_reg_weight
        return loss


def _class_major_onehot(flat_gt: torch.Tensor, k: int) -> torch.Tensor:
    """(K, M) bool: row i marks the rows labelled i."""
    return torch.arange(k, device=flat_gt.device)[:, None] == flat_gt[None, :]


class ReliablePrototypeLoss(_MarginProtoBase):
    """Margin CE with entropy-percentile pixel filtering (the ``vqreptunet``
    family): ``PrototypeLoss`` with each row's log term masked.  The
    l2-normalised table is detached: it gets no gradient and stays at its
    init (``_blended_logits`` for the eps-ed one-hot and the additive
    margin).  ``forward(x, gt, percent, entropy)``: ``gt`` (N, H, W) integer labels,
    ``entropy`` the flat per-row entropies of the feature grid."""

    def forward(self, x, gt, percent, entropy, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator)
            cosine, onehot = self._blended_logits(
                l2norm(table).detach() @ l2norm(flat_x).T, flat_gt)  # class-major (K, M)
            mask = entropy_mask(entropy, percent).float()
            positive = torch.sum(cosine * onehot, dim=0)
            sum_all = torch.sum(torch.exp(cosine), dim=0)
            loss = -batch_mean(torch.log(torch.exp(positive) / (sum_all + 1e-7) + 1e-7) * mask)
            if self.orthogonal_reg_weight > 0:
                loss = loss + orthogonal_loss_fn(table) * self.orthogonal_reg_weight
        return loss


class ReliableEuclideanPrototypeLoss(_ProtoBase):
    """Entropy-masked MSE between each row and its class's prototype.  The
    table is live: it gets gradients.  ``forward(x, gt, percent,
    entropy)``."""

    def forward(self, x, gt, percent, entropy, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator)
            mask = entropy_mask(entropy, percent).float()[:, None]
            gt_embed = table.index_select(0, flat_gt)
            loss = batch_mean((flat_x * mask - gt_embed * mask) ** 2)
        return loss


class StableTemperaturedPrototypeLoss(_ProtoBase):
    """Temperatured cosine CE with entropy filtering (``vqretemptunet``).
    The live table is l2-normalised in the forward; the cosines of
    filtered-out rows are zeroed before the exp, and the denominator is
    ``sum(exp(cos)) / t`` (exp, then divide), as the reference has it.
    ``forward(x, gt, percent, entropy)``."""

    def __init__(self, num_classes: int = 3, embedding_dim: int = 0, pt_init: str = "kmeans",
                 use_feature: bool = False, t: float = 0.1, orthogonal_reg_weight: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, embedding_dim, pt_init, use_feature, generator)
        self.t = t
        self.orthogonal_reg_weight = orthogonal_reg_weight

    def forward(self, x, gt, percent, entropy, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator)
            cosine = l2norm(table) @ l2norm(flat_x).T  # class-major (K, M)
            cosine = cosine * entropy_mask(entropy, percent).float()[None, :]
            onehot = _class_major_onehot(flat_gt, self.num_rows)
            positive = torch.exp(
                torch.sum(torch.where(onehot, cosine, torch.zeros_like(cosine)), dim=0) / self.t)
            sum_all = torch.sum(torch.exp(cosine) / self.t, dim=0)
            loss = -batch_mean(torch.log(positive / (sum_all + 1e-7) + 1e-7))
            if self.orthogonal_reg_weight > 0:
                loss = loss + orthogonal_loss_fn(table) * self.orthogonal_reg_weight
        return loss


class OnlyCWPrototypeLoss(_MarginProtoBase):
    """Crop/weed-only prototype loss (``vqonlyptunet1x1``): the table holds
    the K-1 non-background prototypes (``num_classes`` is the full count),
    background rows are masked out with the entropy-filtered ones, and no
    margin is applied (the reference computes phi and never uses it).  Its
    k-means init draws K-1 clusters; ``class_means`` leaves the table as
    drawn.  The live table gets gradients.  ``forward(x, gt, percent,
    entropy)``."""

    @property
    def num_rows(self) -> int:
        return self.num_classes - 1

    @torch.no_grad()
    def _init_table(self, flat_x, flat_gt, generator: Optional[torch.Generator]):
        if self.pt_init != "kmeans":
            return
        if generator is None:
            raise ValueError("the k-means prototype init needs a generator")
        means, _ = kmeans(batch_gather(flat_x), self.num_rows, 10, generator=generator)
        self.embedding.copy_(means)

    def forward(self, x, gt, percent, entropy, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator)
            cosine = self.scale * (l2norm(table) @ l2norm(flat_x).T)  # class-major (K-1, M)
            mask = entropy_mask(entropy, percent) & (flat_gt != 0)
            # gt - 1 indexes the (K-1)-row table; background rows are masked
            onehot = _class_major_onehot(torch.clamp(flat_gt - 1, 0, self.num_rows - 1),
                                         self.num_rows)
            positive = torch.sum(torch.where(onehot, cosine, torch.zeros_like(cosine)), dim=0)
            sum_all = torch.sum(torch.exp(cosine), dim=0)
            lg = torch.log(torch.exp(positive) / (sum_all + 1e-7) + 1e-7) * mask.float()
            loss = -batch_mean(lg)
            if self.orthogonal_reg_weight > 0:
                loss = loss + orthogonal_loss_fn(table) * self.orthogonal_reg_weight
        return loss


class PrototypeLoss(_MarginProtoBase):
    """ArcFace-margin softmax CE over the cosines to the class prototypes
    (``vqptunet``), with ``_blended_logits``'s eps-ed one-hot and additive
    margin: ``-mean(log(exp(pos) / (sum exp + 1e-7) + 1e-7))``.  The
    l2-normalised table is detached: it gets no gradient and stays at its
    init.  ``forward(x, gt)``: ``gt`` (N, H, W) integer labels."""

    def forward(self, x, gt, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator)
            cosine, onehot = self._blended_logits(
                l2norm(table).detach() @ l2norm(flat_x).T, flat_gt)  # class-major (K, M)
            positive = torch.sum(cosine * onehot, dim=0)
            sum_all = torch.sum(torch.exp(cosine), dim=0)
            loss = -batch_mean(torch.log(torch.exp(positive) / (sum_all + 1e-7) + 1e-7))
        return loss


class EuclideanPrototypeLoss(_ProtoBase):
    """MSE between each row and its class's prototype, the table detached
    (``vqeuptunet`` with ``learnable_alpha: false``).  ``forward(x, gt)``."""

    def forward(self, x, gt, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator)
            target = table.detach().index_select(0, flat_gt)
            loss = batch_mean((target - flat_x) ** 2)
        return loss


def _distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A, B) Euclidean distances between the rows of a and b by the
    expanded form, clamped at 1e-12 under the square root."""
    d2 = torch.sum(a ** 2, -1)[:, None] - 2 * a @ b.T + torch.sum(b ** 2, -1)[None, :]
    return torch.sqrt(torch.clamp_min(d2, 1e-12))


class LearnableEuclideanPrototypeLoss(_ProtoBase):
    """The mean over classes of each class's mean distance to its detached
    prototype, scaled by ``sigmoid(alpha)``, ``alpha`` a trainable scalar
    from -1 (``vqeuptunet``'s default).  ``forward(x, gt)``."""

    def __init__(self, num_classes: int = 3, embedding_dim: int = 0, pt_init: str = "kmeans",
                 use_feature: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, embedding_dim, pt_init, use_feature, generator)
        self.alpha = nn.Parameter(torch.tensor(-1.0))

    def forward(self, x, gt, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator).detach()
            d = _distances(flat_x, table)  # (M, K)
            onehot = _class_major_onehot(flat_gt, self.num_classes).T.float()  # (M, K)
            per_class = (batch_sum(torch.sum(d * onehot, dim=0))
                         / torch.clamp_min(batch_sum(onehot.sum(0)), 1.0))
            loss = torch.mean(per_class) * torch.sigmoid(self.alpha)
        return loss


class NEDPrototypeLoss(_ProtoBase):
    """Minus the mean softmax, over classes, of ``+distance / temperature``
    at each row's gt class, the table detached (``vqnedptunet``).  The
    module's own default init is ``class_means``; the network passes its
    ``pt_init``.  ``forward(x, gt)``."""

    def __init__(self, num_classes: int = 3, embedding_dim: int = 0,
                 pt_init: str = "class_means", use_feature: bool = False,
                 temperature: float = 0.04, generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, embedding_dim, pt_init, use_feature, generator)
        self.temperature = temperature

    def forward(self, x, gt, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        with torch.autocast(x.device.type, enabled=False):
            flat_x, flat_gt = _flatten_with_gt(x, gt)
            table = self._table(flat_x, flat_gt, init_protos, generator).detach()
            p = torch.softmax(_distances(table, flat_x) / self.temperature, dim=0)  # (K, M)
            onehot = _class_major_onehot(flat_gt, self.num_rows)
            loss = -batch_mean(torch.sum(torch.where(onehot, p, torch.zeros_like(p)), dim=0))
        return loss
