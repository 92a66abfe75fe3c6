"""Confusion-matrix segmentation metrics, counterpart of the JAX package's
``metrics/measurement.py``.  Pure tensor functions that stay on the device;
only ``Measurement`` returns Python numbers.

  * per-image confusion matrix binned as ``num_classes * gt + pred``;
  * mIoU: mean over classes of the batch-mean per-image IoU, +1e-8 in the
    denominator; an image missing a class contributes IoU 0;
  * precision (+1e-7) and recall per class, averaged over the batch;
    f1 = 2PR / (P + R);
  * accuracy: mean per-image pixel accuracy, or with ``ignore_idx`` one
    global accuracy over the kept pixels.
"""
from __future__ import annotations

import torch


def _labels_of(pred: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) scores or (N, H, W) labels -> labels."""
    return torch.argmax(pred, dim=1) if pred.dim() == 4 else pred


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-image confusion matrices (N, K, K) f32, rows gt, columns pred.

    The bins are counted with ``index_add_`` into N*K*K + 1 slots: the
    ``bincount`` of the image-offset bin ids, without the device-to-host
    read of the largest id that ``torch.bincount`` makes on the card.  Ids
    outside [0, K*K), such as an ignored target, go to the last slot, which
    is dropped, as a one-hot drops them."""
    k = num_classes
    labels = _labels_of(pred)
    n = labels.shape[0]
    cats = (k * target.long() + labels.long()).reshape(n, -1)
    valid = (cats >= 0) & (cats < k * k)
    offset = (torch.arange(n, device=cats.device) * (k * k)).unsqueeze(1)
    bins = torch.where(valid, cats + offset, torch.full_like(cats, n * k * k)).reshape(-1)
    counts = torch.zeros(n * k * k + 1, dtype=torch.float32, device=cats.device)
    counts.index_add_(0, bins, torch.ones_like(bins, dtype=torch.float32))
    return counts[:-1].reshape(n, k, k)


def miou(conf_mat: torch.Tensor):
    """(mIoU, per-class IoU) from (N, K, K) confusion matrices."""
    sum_col = conf_mat.sum(dim=-2)
    sum_row = conf_mat.sum(dim=-1)
    diag = torch.diagonal(conf_mat, dim1=-2, dim2=-1)
    iou = torch.mean(diag / (sum_col + sum_row - diag + 1e-8), dim=0)
    return iou.mean(), iou


def precision(conf_mat: torch.Tensor):
    diag = torch.diagonal(conf_mat, dim1=-2, dim2=-1)
    per_class = torch.mean(diag / (conf_mat.sum(dim=-2) + 1e-7), dim=0)
    return per_class.mean(), per_class


def recall(conf_mat: torch.Tensor):
    diag = torch.diagonal(conf_mat, dim1=-2, dim2=-1)
    per_class = torch.mean(diag / conf_mat.sum(dim=-1), dim=0)
    return per_class.mean(), per_class


def f1score(recall_v, precision_v):
    return 2 * recall_v * precision_v / (recall_v + precision_v)


def accuracy(pred: torch.Tensor, target: torch.Tensor, ignore_idx=None) -> torch.Tensor:
    labels = _labels_of(pred)
    n = labels.shape[0]
    p = labels.reshape(n, -1)
    t = target.reshape(n, -1)
    if ignore_idx is None:
        return torch.mean((p == t).sum(dim=-1) / p.shape[-1])
    keep = t != ignore_idx
    return ((p == t) & keep).sum() / keep.sum()


class Measurement:
    """``measure(pred, target) -> (acc, miou, iou_list, precision, recall,
    f1)`` as Python numbers; ``pred`` is (N, C, H, W) scores or (N, H, W)
    labels."""

    def __init__(self, num_classes: int, ignore_idx=None):
        self.num_classes = num_classes
        self.ignore_idx = ignore_idx

    def measure(self, pred: torch.Tensor, target: torch.Tensor):
        conf = confusion_matrix(pred, target, self.num_classes)
        acc = float(accuracy(pred, target, self.ignore_idx))
        miou_v, iou = miou(conf)
        precision_v = float(precision(conf)[0])
        recall_v = float(recall(conf)[0])
        return (acc, float(miou_v), [float(v) for v in iou], precision_v, recall_v,
                f1score(recall_v, precision_v))

    __call__ = measure
