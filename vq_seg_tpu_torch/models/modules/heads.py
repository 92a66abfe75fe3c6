"""Segmentation heads, counterpart of the JAX package's
``models/modules/heads.py``: ``SegmentationHead`` (the DeepLab networks'
conv, upsample and activation), ``VQSegmentationHead``, a codebook of
``num_embeddings`` (= classes) codes as the classifier, and the angular
heads (``AngularSegmentationHead`` of ``vqashunet``,
``AngularSegmentationHeadv2`` of ``vqashunetv2`` and
``vqreptunetangular``, ``AngularSegmentationHeadv3`` of
``vqreptunetangularv3``), cosine classifiers over a trainable table of
class embeddings.  Inside ``parallel.data_parallel`` the heads' loss means
and the VQ head's code usage are those of the global batch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...ops.kmeans import kmeans, l2norm
from ...ops.vq import code_usage_percent, commitment_loss, quantize_ste, vq_assign
from ...parallel.collectives import batch_mean, batch_sum
from ...utils.seg_tools import score_mask
from ..layers import ConvPad, resize_nearest_exact, torch_conv_default, upsample_bilinear_ac
from .prototype import (_class_major_onehot, _ProtoBase, arcface_phi, entropy_mask,
                        orthogonal_loss_fn)
from .vector_quantizer import _rows


def l1norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """t / max(sum |t|, eps) along ``dim``."""
    return t / torch.sum(torch.abs(t), dim=dim, keepdim=True).clamp_min(eps)


class SegmentationHead(nn.Module):
    """conv (k x k, bias, torch's default init) -> x``upsampling``
    align-corners bilinear upsample -> ``activation`` (None for none)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 upsampling: int = 1, activation=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsampling = upsampling
        self.activation = activation
        self.conv = ConvPad(in_channels, out_channels, kernel_size, 1, kernel_size // 2,
                            bias=True, init=torch_conv_default, generator=generator)

    def forward(self, x):
        x = self.conv(x)
        if self.upsampling > 1:
            x = upsample_bilinear_ac(x, scale=self.upsampling)
        return x if self.activation is None else self.activation(x)


class _AngularHead(_ProtoBase):
    """A conv (bias, torch's default init) to ``out_channels`` and a table
    of class embeddings (``embedding_dim``, else ``out_channels``, wide),
    an ``nn.Parameter`` that Adam trains: the cosines are taken against it
    live, so it gets gradients.  Its init phase (``init_protos``) sets the
    table to the k-means (10 iterations) of this batch's rows."""

    def __init__(self, in_channels: int, num_classes: int = 3, embedding_dim: int = 0,
                 out_channels: int = 3, scale: float = 1.0, margin: float = 0.5,
                 kernel_size: int = 3, upsampling: int = 2, easy_margin: bool = True,
                 pt_init: str = "kmeans", generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, embedding_dim or out_channels, pt_init, False, generator)
        self.scale, self.margin, self.easy_margin = scale, margin, easy_margin
        self.upsampling = upsampling
        self.conv = ConvPad(in_channels, out_channels, kernel_size, 1, kernel_size // 2,
                            bias=True, init=torch_conv_default, generator=generator)

    def _margin_ce(self, cosine: torch.Tensor, flat_gt: torch.Tensor, mask=None):
        """The multiplicative margin at the gt class, ``scale * (gt ? cos *
        phi : cos)`` (times the (M,) ``mask`` where given), and
        ``-mean(log(exp(pos) / (sum exp + 1e-7) + 1e-7))`` over the
        class-major (K, M) logits.  Returns (loss, logits)."""
        phi = arcface_phi(cosine, self.margin, self.easy_margin)
        onehot = _class_major_onehot(flat_gt, self.num_classes)
        logits = self.scale * torch.where(onehot, cosine * phi, cosine)
        if mask is not None:
            logits = logits * mask[None, :]
        positive = torch.sum(torch.where(onehot, logits, torch.zeros_like(logits)), dim=0)
        sum_all = torch.sum(torch.exp(logits), dim=0)
        return -batch_mean(torch.log(torch.exp(positive) / (sum_all + 1e-7) + 1e-7)), logits


def _class_scores(cosine: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """Class-major (K, N*h*w) logits -> (N, K, h, w) softmax probabilities."""
    return torch.softmax(cosine, dim=0).reshape(-1, n, h, w).permute(1, 0, 2, 3)


class AngularSegmentationHead(_AngularHead):
    """v1: conv -> x``upsampling`` align-corners upsample -> cosines of the
    l1-normalised rows to the l1-normalised embeddings; in training with
    ``gt`` (labels at the upsampled size) the margin CE, and the scores are
    taken from the margin logits.  The k-means init runs on the
    l1-normalised rows.  ``forward(x, gt=None, train=False,
    init_protos=False, generator=None)`` -> (softmax scores (N, K, H, W),
    loss)."""

    def forward(self, x, gt=None, train: bool = False, init_protos: bool = False,
                generator: Optional[torch.Generator] = None):
        y = self.conv(x)
        if self.upsampling > 1:
            y = upsample_bilinear_ac(y, scale=self.upsampling)
        n, _, h, w = y.shape
        with torch.autocast(y.device.type, enabled=False):
            flat = _rows(y).float()
            if init_protos:
                self._init_table(l1norm(flat), None, generator)
            cosine = l1norm(self.embedding) @ l1norm(flat).T  # class-major (K, M)
            loss = flat.new_zeros(())
            if train and gt is not None:
                loss, cosine = self._margin_ce(cosine, gt.reshape(-1).long())
            pred = _class_scores(cosine, n, h, w)
        return pred, loss


class AngularSegmentationHeadv2(_AngularHead):
    """v2: conv (1x1 by default) -> cosines of the l2-normalised rows to the
    l2-normalised embeddings; in training with ``gt`` the margin CE on the
    conv's grid, ``gt`` resized there by the half-pixel nearest rule
    (``resize_nearest_exact``), and the scores taken from the margin
    logits; with ``entropy`` (flat, per row of the conv's grid) the logits
    of the rows above its ``percent``-ile are zeroed.  The softmax scores
    are upsampled x``upsampling`` (align-corners).  In training the loss
    also holds ``commit_weight`` x the MSE between the conv output and its
    gt class's (detached) normalised embedding, and the orthogonality term
    with ``orthogonal_reg_weight``.  The k-means init runs on the raw rows.
    ``forward(x, gt=None, percent=100.0, entropy=None, train=False,
    init_protos=False, generator=None)`` -> (scores (N, K, H, W), loss)."""

    def __init__(self, in_channels: int, num_classes: int = 3, out_channels: int = 3,
                 scale: float = 1.0, margin: float = 0.5, kernel_size: int = 1,
                 upsampling: int = 2, easy_margin: bool = True,
                 orthogonal_reg_weight: float = 0.0, commit_weight: float = 1.0,
                 pt_init: str = "kmeans", generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, num_classes, 0, out_channels, scale, margin, kernel_size,
                         upsampling, easy_margin, pt_init, generator)
        self.orthogonal_reg_weight = orthogonal_reg_weight
        self.commit_weight = commit_weight

    def forward(self, x, gt=None, percent=100.0, entropy=None, train: bool = False,
                init_protos: bool = False, generator: Optional[torch.Generator] = None):
        y = self.conv(x)
        n, c, h, w = y.shape
        with torch.autocast(y.device.type, enabled=False):
            y = y.float()
            flat = _rows(y)
            if init_protos:
                self._init_table(flat, None, generator)
            wn = l2norm(self.embedding)
            cosine = wn @ l2norm(flat).T  # class-major (K, M)
            loss = flat.new_zeros(())
            gt_map = None
            if train and gt is not None:
                gt_map = gt if tuple(gt.shape[1:]) == (h, w) else resize_nearest_exact(gt, (h, w))
                gt_map = gt_map.long()
                mask = None if entropy is None else entropy_mask(entropy, percent).float()
                loss, cosine = self._margin_ce(cosine, gt_map.reshape(-1), mask)
            pred = _class_scores(cosine, n, h, w)
            if self.upsampling > 1:
                pred = upsample_bilinear_ac(pred, scale=self.upsampling)
            if gt_map is not None:
                class_feat = wn.detach().index_select(0, gt_map.reshape(-1))
                class_feat = class_feat.reshape(n, h, w, c).permute(0, 3, 1, 2)
                loss = loss + self.commit_weight * batch_mean((class_feat - y) ** 2)
                if self.orthogonal_reg_weight > 0:
                    loss = loss + orthogonal_loss_fn(self.embedding) * self.orthogonal_reg_weight
        return pred, loss


class AngularSegmentationHeadv3(_AngularHead):
    """v3: in-head pseudo-label self-training.  conv (1x1 by default) ->
    x``upsampling`` -> cosines of the l2-normalised rows to the
    l2-normalised embeddings; the returned scores are the softmax of the
    plain cosines.  In training with ``pred`` the margin CE: on the
    ``"labeled"`` split ``pred`` is (N, H, W) integer labels, on
    ``"unlabeled"`` it is the other model's (N, K, H, W) score map, whose
    argmax is the pseudo-label and, where ``th`` > 0, whose confidence mask
    (``score_mask(pred, th)``) multiplies the logits (the JAX package's
    intended mask).  Labels and mask reach the conv's grid by the
    half-pixel nearest rule.  The loss also holds the MSE between the conv
    output and its label's (detached) normalised embedding, and the
    orthogonality term with ``orthogonal_reg_weight``.  The k-means init
    runs on the l2-normalised rows.  ``forward(x, pred=None,
    split="labeled", th=0.0, train=False, init_protos=False,
    generator=None)`` -> (scores (N, K, H, W), loss)."""

    def __init__(self, in_channels: int, num_classes: int = 3, out_channels: int = 3,
                 scale: float = 1.0, margin: float = 0.5, kernel_size: int = 1,
                 upsampling: int = 1, easy_margin: bool = True,
                 orthogonal_reg_weight: float = 0.0, pt_init: str = "kmeans",
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, num_classes, 0, out_channels, scale, margin, kernel_size,
                         upsampling, easy_margin, pt_init, generator)
        self.orthogonal_reg_weight = orthogonal_reg_weight

    def forward(self, x, pred=None, split: str = "labeled", th=0.0, train: bool = False,
                init_protos: bool = False, generator: Optional[torch.Generator] = None):
        y = self.conv(x)
        if self.upsampling > 1:
            y = upsample_bilinear_ac(y, scale=self.upsampling)
        n, c, h, w = y.shape
        with torch.autocast(y.device.type, enabled=False):
            y = y.float()
            flat = _rows(y)
            if init_protos:
                self._init_table(l2norm(flat), None, generator)
            wn = l2norm(self.embedding)
            cosine = wn @ l2norm(flat).T  # class-major (K, M)
            result = _class_scores(cosine, n, h, w)
            loss = flat.new_zeros(())
            if train and pred is not None:
                unlabeled = split == "unlabeled"
                gt = torch.argmax(pred, dim=1) if unlabeled else pred
                if tuple(gt.shape[1:]) != (h, w):
                    gt = resize_nearest_exact(gt, (h, w))
                gt = gt.long()
                mask = None
                if unlabeled and float(th) > 0:
                    mask = resize_nearest_exact(score_mask(pred, float(th))[:, 0], (h, w))
                    mask = mask.reshape(-1).float()
                loss, _ = self._margin_ce(cosine, gt.reshape(-1), mask)
                class_feat = wn.detach().index_select(0, gt.reshape(-1))
                class_feat = class_feat.reshape(n, h, w, c).permute(0, 3, 1, 2)
                loss = loss + batch_mean((class_feat - y) ** 2)
                if self.orthogonal_reg_weight > 0:
                    loss = loss + orthogonal_loss_fn(self.embedding) * self.orthogonal_reg_weight
        return result, loss


class VQSegmentationHead(nn.Module):
    """A VQ codebook as the classifier.  ``forward(x, train, init_codebook,
    generator)`` -> (quantized (N, C, H, W), score (N, K, H, W), idx (N, H,
    W), commitment loss, code usage %).

    euclidean: the assignment is ``ops/vq.py::vq_assign`` (the kernel on
    the card); the score is ``softmax(1 - d / sum(d))`` over the true L2
    distances, computed with the expanded formula in plain torch.  cosine:
    the score is the similarity of the l2-normalised rows and codes, all in
    plain torch.  The codebook is a buffer drawn uniform in [-1/K, 1/K],
    set by k-means on the first batch with ``kmeans_init``."""

    def __init__(self, dim: int, num_embeddings: int, embedding_dim: Optional[int] = None,
                 kmeans_init: bool = False, kmeans_iters: int = 10, distance: str = "euclidean",
                 commitment_weight: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edim = embedding_dim or dim
        self.num_embeddings = k = num_embeddings
        self.kmeans_init = kmeans_init
        self.kmeans_iters = kmeans_iters
        self.distance = distance
        self.commitment_weight = commitment_weight
        cb = torch.empty(k, self.edim).uniform_(-1.0 / k, 1.0 / k, generator=generator)
        self.register_buffer("embedding", cb)

    def forward(self, x: torch.Tensor, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        n, _, h, w = x.shape
        k = self.num_embeddings
        with torch.autocast(x.device.type, enabled=False):
            x = x.float()
            flat = _rows(x)
            if init_codebook and self.kmeans_init:
                with torch.no_grad():
                    feats = l2norm(flat) if self.distance == "cosine" else flat
                    means, _ = kmeans(feats, k, self.kmeans_iters,
                                      use_cosine_sim=self.distance == "cosine",
                                      generator=generator)
                    self.embedding.copy_(means)
            cb = self.embedding
            if self.distance == "cosine":
                cb = l2norm(cb)
                score = l2norm(flat) @ cb.T
                idx = torch.argmax(score, dim=-1).to(torch.int32)
                quant = cb.index_select(0, idx)
                counts = torch.bincount(idx, minlength=k)
            else:
                idx, quant, counts = vq_assign(flat.detach().contiguous(), cb.contiguous(),
                                               "euclidean")
                d = torch.sqrt(torch.clamp_min(
                    torch.sum(flat ** 2, -1, keepdim=True) - 2 * flat @ cb.T
                    + torch.sum(cb ** 2, -1)[None, :], 0.0))
                score = 1.0 - d / torch.sum(d, dim=-1, keepdim=True)
            usage = code_usage_percent(batch_sum(counts))
            loss = x.new_zeros(())
            quant = quant.reshape(n, h, w, self.edim).permute(0, 3, 1, 2)
            if train:
                quant = quantize_ste(x, quant)
                if self.commitment_weight > 0:
                    loss = commitment_loss(x, quant, self.commitment_weight)
            score = torch.softmax(score.reshape(n, h, w, k), dim=-1).permute(0, 3, 1, 2)
        return quant, score, idx.reshape(n, h, w), loss, usage
