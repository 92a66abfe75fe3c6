"""Batch-wide reductions across the processes of a data-parallel group.

The JAX package gets a sharded step's global-batch math from GSPMD, which
inserts the reductions.  Here every reduction over the batch goes through
one of these helpers, and they reduce over the group that
``data_parallel(group)`` made active; with no group active they compute
what the single-process code computes, the same expressions in the same
order.

The design that makes the sharded step exact:

  * every rank computes the *global* loss, the same value on every rank;
  * ``batch_sum`` and ``batch_gather`` are differentiable: the backward of
    an all-reduce or an all-gather sums the upstream gradient over the
    ranks, so each rank's gradient is R times its share;
  * ``average_gradients`` then takes the mean over the R ranks, which is
    the single-process gradient.  A term that every rank computes alike
    without a collective (a regulariser of a replicated parameter) has the
    full gradient on each rank, and the mean keeps it.

A reduction that skips these helpers computes a per-rank value and breaks
the first point.

Every collective runs on the tensors where they lie: gloo, too, runs its
all-reduce, all-gather and broadcast on CUDA tensors.  ``timing(True)``
makes each collective synchronise the card around itself and add its wall
time to ``stats``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import Counter
from typing import Iterable, Optional

import torch
import torch.distributed as dist

_state = threading.local()

stats = {"calls": Counter(), "seconds": 0.0}
_timed = False
BUCKET_BYTES = 25 << 20  # the gradient all-reduce's bucket, as DDP's default


@contextlib.contextmanager
def data_parallel(group):
    """Inside this context the helpers reduce over ``group`` (a process
    group, or None for none); the previous group comes back on exit."""
    before = active_group()
    _state.group = group
    try:
        yield
    finally:
        _state.group = before


def on_mesh(mesh):
    """A step decorator: the step runs inside ``data_parallel`` over
    ``mesh.data_group`` (none without a mesh, ``parallel.make_mesh``), so
    that every batch-wide reduction of its forwards, losses and metrics is
    the global batch's and ``backward`` averages the gradients over the
    group."""
    group = None if mesh is None else mesh.data_group

    def wrap(step):
        @functools.wraps(step)
        def run(*args, **kwargs):
            with data_parallel(group):
                return step(*args, **kwargs)
        return run

    return wrap


def backward(loss: torch.Tensor, *models):
    """``loss.backward()``, then, inside ``data_parallel``, each gradient of
    ``models`` replaced by its mean over the group: every rank's ``loss``
    is the global loss (or, in a pair-sharded step, the global batch's
    loss of this rank's model), so the mean is the single-process
    gradient."""
    loss.backward()
    group = active_group()
    if group is not None:
        average_gradients([p for m in models for p in m.parameters()], group)


def active_group():
    """The process group of the innermost ``data_parallel``, or None."""
    return getattr(_state, "group", None)


def group_size() -> int:
    """Ranks in the active group (1 with none)."""
    group = active_group()
    return 1 if group is None else dist.get_world_size(group)


def group_rank() -> int:
    """This process's rank in the active group (0 with none): the index of
    its shard of the global batch."""
    group = active_group()
    return 0 if group is None else dist.get_rank(group)


def timing(on: bool):
    """Time every collective (synchronising the card around it) into
    ``stats`` while on; ``stats`` starts again from zero."""
    global _timed
    _timed = bool(on)
    stats["calls"].clear()
    stats["seconds"] = 0.0


@contextlib.contextmanager
def _timed_call(name: str, t: torch.Tensor):
    stats["calls"][name] += 1
    if not _timed:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    stats["seconds"] += time.perf_counter() - t0


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``."""
    with _timed_call("all_reduce", t):
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated on dim 0 in group-rank order."""
    t = t.contiguous()
    with _timed_call("all_gather", t):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        ctx.rank = dist.get_rank(group)
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, grad):
        # each rank's rows get the sum over the ranks of their gradient
        grad = all_reduce_(grad.contiguous().clone(), ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active group's ranks (differentiable); ``t``
    itself with no group."""
    group = active_group()
    return t if group is None else _AllReduce.apply(t, group)


def batch_gather(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` concatenated on dim 0 in rank order
    (differentiable): with shards laid out as ``shard_batch_fn`` lays them,
    the rows of the global batch in their single-process order.  ``t``
    itself with no group."""
    group = active_group()
    return t if group is None else _AllGather.apply(t, group)


def batch_roll(t: torch.Tensor) -> torch.Tensor:
    """``torch.roll(t, -1, 0)`` over the global batch (differentiable): row
    i takes global row i + 1, the last rank's last row the first rank's
    first.  Each rank's last row comes from the next rank, by a gather of
    every rank's first row.  ``torch.roll(t, -1, 0)`` with no group."""
    if active_group() is None:
        return torch.roll(t, -1, 0)
    firsts = batch_gather(t[:1])
    nxt = (group_rank() + 1) % group_size()
    return torch.cat([t[1:], firsts[nxt:nxt + 1]])


def batch_head(t: torch.Tensor, k: int) -> torch.Tensor:
    """The global batch's first ``k`` rows, on every rank (differentiable;
    every rank gathers its first ``k`` rows, each must hold at least
    ``min(k, its rows)``).  ``t[:k]`` with no group."""
    if active_group() is None:
        return t[:k]
    return batch_gather(t[:k])[:k]


def batch_mean(t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """The mean over the global batch: of every element of ``t``, or along
    ``dim``, whose length is the same on every rank.  ``t.mean()`` with no
    group."""
    if active_group() is None:
        return torch.mean(t) if dim is None else torch.mean(t, dim=dim)
    if dim is None:
        return batch_sum(torch.sum(t)) / (t.numel() * group_size())
    return batch_sum(torch.sum(t, dim=dim)) / (t.shape[dim] * group_size())


def average_gradients(params: Iterable[torch.nn.Parameter], group):
    """Replace each gradient by its mean over ``group``: the gradients are
    flattened into buckets of about ``BUCKET_BYTES`` by dtype and device,
    one all-reduce each.  A parameter without a gradient is skipped (the
    same ones on every rank: the ranks run the same graph)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    n = dist.get_world_size(group)
    buckets: dict = {}  # (dtype, device) -> [bytes of the open bucket, buckets]
    for p in params:
        if p.grad is None:
            continue
        entry = buckets.setdefault((p.grad.dtype, p.grad.device), [0, [[]]])
        if entry[0] >= BUCKET_BYTES:
            entry[0] = 0
            entry[1].append([])
        entry[0] += p.grad.numel() * p.grad.element_size()
        entry[1][-1].append(p.grad)
    for _, bucket_list in buckets.values():
        for grads in bucket_list:
            flat = _flatten_dense_tensors(grads)
            all_reduce_(flat, group)
            flat.div_(n)
            for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
                g.copy_(avg)
