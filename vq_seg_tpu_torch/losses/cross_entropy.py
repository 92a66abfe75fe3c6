"""Cross-entropy and NLL with ``ignore_index`` and class weights,
counterpart of the JAX package's ``losses/cross_entropy.py``.

``nn.CrossEntropyLoss(weight, ignore_index)`` semantics on NCHW scores: the
weighted mean over the kept pixels, normalised by their summed weights.
The sum of weights is floored at 1e-12, so a map with every pixel ignored
gives 0 where torch's own loss gives NaN.  Computed in f32 with autocast
off, whatever dtype the model emitted.
"""
from __future__ import annotations

import torch


def _nll(logp: torch.Tensor, target: torch.Tensor, ignore_index: int, weight):
    c = logp.shape[1]
    t = target.long()
    keep = t != ignore_index
    valid = keep & (t >= 0) & (t < c)  # an out-of-range class scores 0, as a one-hot does
    idx = torch.where(valid, t, torch.zeros_like(t)).unsqueeze(1)
    nll = -torch.gather(logp, 1, idx).squeeze(1) * valid
    if weight is not None:
        wvec = torch.as_tensor(weight, dtype=torch.float32, device=logp.device)
        w = wvec[idx.squeeze(1)] * valid
    else:
        w = keep.float()
    return torch.sum(nll * w) / torch.sum(w).clamp_min(1e-12)


def cross_entropy_loss(pred: torch.Tensor, target: torch.Tensor, ignore_index: int = -100,
                       weight=None) -> torch.Tensor:
    """pred (N, C, H, W) logits; target (N, H, W) integers."""
    with torch.autocast(pred.device.type, enabled=False):
        return _nll(torch.log_softmax(pred.float(), dim=1), target, ignore_index, weight)


def nll_loss(pred: torch.Tensor, target: torch.Tensor, ignore_index: int = -100,
             weight=None) -> torch.Tensor:
    """pred (N, C, H, W) log-probabilities; target (N, H, W) integers."""
    with torch.autocast(pred.device.type, enabled=False):
        return _nll(pred.float(), target, ignore_index, weight)
