"""Pixel supervised-contrastive loss, counterpart of the JAX package's
``losses/contrastive.py``.

Between the first two batch items' feature maps: with ``l = f1 @ f2.T /
temperature`` over their pixels (rows in (h, w) order) and ``pos`` the pairs
that share a label, ``loss = -log(sum(exp(l) * pos) / sum(exp(l))) / (hw *
hw)``.  Labels reach the features' grid by the half-pixel nearest rule.

The function is computed in log space: with ``r = sum_neg exp(l) /
sum_pos exp(l)`` (the negative pairs' mass over the positive pairs'),
``loss = log(1 + r) / (hw * hw)``, each sum taken after subtracting its own
maximum, and the gradient with respect to the logits is ``sigmoid(log r) x
(the softmax over the negative pairs, minus the softmax over the positive
pairs) / (hw * hw)``.  That is the plain formula and its gradient, exactly.
The JAX package subtracts the global maximum only: where every positive
pair's logit lies more than about 100 below it (unnormalised features at
temperature 0.04: it happens within three steps at full width), its f32
``exp`` underflows to 0, its loss is +inf and its gradient NaN; the log
form stays finite.  Where nearly all the mass sits on positive pairs its
f32 loss is the log of a ratio one ulp from 1, and its gradient the
difference of two near-equal reciprocals: rounding noise, where the log
form keeps ``r`` itself.  Elsewhere the two agree to f32 rounding.

The (hw, hw) matrix is never held whole: at 512x512 inputs the decoder
output is 256x256, so it would be 65,536^2 f32, 16 GiB, for each labeled
pass.  ``SupConFunction`` works in blocks of ``block_rows`` rows of f1: the
two maxima, then the two sums, and a backward that recomputes each block's
exponentials, so that the memory is one (block_rows, hw) block at a time.
"""
from __future__ import annotations

import torch

from ..models.layers import resize_nearest_exact
from ..parallel.collectives import active_group, batch_head, batch_sum, group_rank

# rows of f1 per block: a (4096, 65536) f32 block is 1 GiB
BLOCK_ROWS = 4096


def _blocks(n: int, rows: int):
    return [(s, min(s + rows, n)) for s in range(0, n, rows)]


class SupConFunction(torch.autograd.Function):
    """``forward(f1 (M, C), f2 (M, C), g1 (M,), g2 (M,), temperature,
    block_rows)`` -> the scalar loss, computed block by block."""

    @staticmethod
    def _block(f1, f2, g1, g2, s, e, temperature, top_neg, top_pos):
        """A block's positive mask and its exponentials, each pair shifted
        by its own class's maximum."""
        logits = (f1[s:e] @ f2.T) / temperature
        pos = g1[s:e, None] == g2[None, :]
        return pos, torch.exp(logits - torch.where(pos, top_pos, top_neg))

    @staticmethod
    def forward(ctx, f1, f2, g1, g2, temperature: float, block_rows: int):
        m = f1.shape[0]
        blocks = _blocks(m, block_rows)
        low = torch.tensor(float("-inf"), dtype=f1.dtype, device=f1.device)
        top_neg, top_pos = low, low
        for s, e in blocks:
            logits = (f1[s:e] @ f2.T) / temperature
            pos = g1[s:e, None] == g2[None, :]
            top_neg = torch.maximum(top_neg, torch.max(torch.where(pos, low, logits)))
            top_pos = torch.maximum(top_pos, torch.max(torch.where(pos, logits, low)))
        s_neg = f1.new_zeros(())
        s_pos = f1.new_zeros(())
        for s, e in blocks:
            pos, sim = SupConFunction._block(f1, f2, g1, g2, s, e, temperature, top_neg, top_pos)
            s_neg = s_neg + torch.sum(torch.where(pos, 0.0, sim))
            s_pos = s_pos + torch.sum(torch.where(pos, sim, 0.0))
        log_ratio = (top_neg + torch.log(s_neg)) - (top_pos + torch.log(s_pos))
        ctx.save_for_backward(f1, f2, g1, g2, top_neg, top_pos, s_neg, s_pos, log_ratio)
        ctx.temperature, ctx.block_rows = temperature, block_rows
        return torch.nn.functional.softplus(log_ratio) / (m * m)

    @staticmethod
    def backward(ctx, grad_out):
        f1, f2, g1, g2, top_neg, top_pos, s_neg, s_pos, log_ratio = ctx.saved_tensors
        t = ctx.temperature
        m = f1.shape[0]
        # dloss/dl = sigmoid(log r) (negatives' softmax - positives' softmax) / m^2
        scale = grad_out * torch.sigmoid(log_ratio) / (m * m) / t
        d1 = torch.empty_like(f1)
        d2 = torch.zeros_like(f2)
        for s, e in _blocks(m, ctx.block_rows):
            pos, sim = SupConFunction._block(f1, f2, g1, g2, s, e, t, top_neg, top_pos)
            g = sim * torch.where(pos, -scale / s_pos, scale / s_neg)
            d1[s:e] = g @ f2
            d2 += g.T @ f1[s:e]
        return d1, d2, None, None, None, None


def supcon_loss(x: torch.Tensor, label: torch.Tensor, temperature: float = 0.04,
                block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """x (N, C, h, w) with N >= 2; label (N, H, W) integers, resized to (h,
    w) where they differ.  At least f32 whatever autocast says.

    Inside ``parallel.data_parallel`` the two items are the global batch's
    first two, wherever they lie (``batch_head``: on the first rank, or on
    the first two when a rank holds one item).  The group's first rank
    computes the loss and the others contribute 0, keeping the gathered
    rows in their graphs so that every rank joins the gather's backward;
    the sum over the ranks is the loss on every rank."""
    n, c, h, w = x.shape
    if tuple(label.shape[1:]) != (h, w):
        label = resize_nearest_exact(label, (h, w))
    with torch.autocast(x.device.type, enabled=False):
        first = batch_head(x, 2).to(torch.promote_types(x.dtype, torch.float32))
        g = batch_head(label, 2).reshape(2, h * w)
        if active_group() is not None and group_rank() != 0:
            return batch_sum(torch.sum(first) * 0.0)
        rows = first.permute(0, 2, 3, 1).reshape(2, h * w, c)
        loss = SupConFunction.apply(rows[0], rows[1], g[0], g[1], float(temperature),
                                    int(block_rows))
        return loss if active_group() is None else batch_sum(loss)


class SupConLoss:
    def __init__(self, temperature: float = 0.04):
        self.temperature = temperature

    def __call__(self, x, label):
        return supcon_loss(x, label, self.temperature)
