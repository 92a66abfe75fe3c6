"""ZeRO-1, counterpart of the JAX package's ``parallel/zero.py``.

The JAX package shards each Adam moment over the ``data`` axis and lets
XLA insert the all-gather of the updated parameters.  Here Adam is wrapped
in ``torch.distributed.optim.ZeroRedundancyOptimizer`` over the model's
data group: each rank keeps the moments of its share of the parameters,
updates that share and broadcasts it.  The gradients are averaged before
the step (``collectives.average_gradients``), as for a replicated Adam.

With gradient accumulation (``every_k`` > 1) the local optimizer is the
``MultiStepAdam`` of ``training/cps.py`` (``optax.MultiSteps``): each rank
keeps the running means of its own share only, as JAX's sharded
``MultiStepsState`` does, and on the other micro-steps the parameters it
broadcasts have not moved.

The wrapper's ``param_groups`` are the ones the step writes the LR into;
it copies them into the local Adam at every ``step()``.  A checkpoint
calls ``consolidate_state_dict(to=0)`` on every rank of the group, and
then the group's first rank holds ``state_dict()`` in Adam's own format,
with ``mini_step`` and ``acc_grads`` (by global parameter index) under
accumulation, as a replicated ``MultiStepAdam.state_dict()`` holds them.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer


class ZeroMultiStep(ZeroRedundancyOptimizer):
    """ZeRO-1 over ``MultiStepAdam``: the consolidated state carries the
    accumulation's ``mini_step`` and every parameter's ``acc_grads``, and
    loading it gives each rank its share of them."""

    def state_dict(self) -> dict:
        sd = super().state_dict()
        accs = {}
        for rank, local in enumerate(self._all_state_dicts):
            local_params = [p for group in self._partition_parameters()[rank]
                            for p in group["params"]]
            for i, acc in local.get("acc_grads", {}).items():
                accs[self._param_to_index[local_params[int(i)]]] = acc
        sd["mini_step"] = int(self._all_state_dicts[0].get("mini_step", 0))  # alike on all
        sd["acc_grads"] = dict(sorted(accs.items()))
        return sd

    def load_state_dict(self, state_dict: dict):
        state_dict = dict(state_dict)
        mini_step = int(state_dict.pop("mini_step", 0))
        accs = state_dict.pop("acc_grads", {})
        super().load_state_dict(state_dict)
        self.optim.mini_step = mini_step
        self.optim.acc_grads = {}
        for i, acc in accs.items():
            p = self._index_to_param[int(i)]
            if self._param_to_rank[p] == self.rank:
                self.optim.acc_grads[p] = acc.to(p.device, p.dtype, copy=True)


def zero_adam(params, group, every_k: int = 1, **adam_kwargs) -> ZeroRedundancyOptimizer:
    """Adam with its moments sharded over ``group``; with ``every_k`` > 1
    the accumulating ``MultiStepAdam``, its running means sharded too."""
    if every_k > 1:
        from ..training.cps import MultiStepAdam

        # k bound into the class, so that the param groups hold Adam's keys only
        return ZeroMultiStep(params, optimizer_class=functools.partial(MultiStepAdam,
                                                                       every_k=every_k),
                             process_group=group, **adam_kwargs)
    return ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.Adam,
                                   process_group=group, **adam_kwargs)


def opt_bytes_per_chip(opt) -> int:
    """Bytes of optimizer state resident on this rank: the local Adam's
    moments under ZeRO, every moment of a replicated Adam."""
    local = opt.optim if isinstance(opt, ZeroRedundancyOptimizer) else opt
    return sum(v.numel() * v.element_size() for s in local.state.values()
               for v in s.values() if isinstance(v, torch.Tensor))
