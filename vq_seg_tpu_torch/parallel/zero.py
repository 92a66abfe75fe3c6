"""ZeRO-1, counterpart of the JAX package's ``parallel/zero.py``.

The JAX package shards each Adam moment over the ``data`` axis and lets
XLA insert the all-gather of the updated parameters.  Here Adam is wrapped
in ``torch.distributed.optim.ZeroRedundancyOptimizer`` over the model's
data group: each rank keeps the moments of its share of the parameters,
updates that share and broadcasts it.  The gradients are averaged before
the step (``collectives.average_gradients``), as for a replicated Adam.

The wrapper's ``param_groups`` are the ones the step writes the LR into;
it copies them into the local Adam at every ``step()``.  A checkpoint
calls ``consolidate_state_dict(to=0)`` on every rank of the group, and
then the group's first rank holds ``state_dict()`` in Adam's own format.
"""
from __future__ import annotations

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer


def zero_adam(params, group, **adam_kwargs) -> ZeroRedundancyOptimizer:
    """Adam with its moments sharded over ``group``."""
    return ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.Adam,
                                   process_group=group, **adam_kwargs)


def opt_bytes_per_chip(opt) -> int:
    """Bytes of optimizer state resident on this rank: the local Adam's
    moments under ZeRO, every moment of a replicated Adam."""
    local = opt.optim if isinstance(opt, ZeroRedundancyOptimizer) else opt
    return sum(v.numel() * v.element_size() for s in local.state.values()
               for v in s.values() if isinstance(v, torch.Tensor))
