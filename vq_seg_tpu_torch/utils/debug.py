"""Numerical-debug tooling, counterpart of the JAX package's
``utils/debug.py``.

  * ``enable_nan_debug(enable)`` — ``torch.autograd.set_detect_anomaly``:
    a backward function that returns NaN raises there, with the forward's
    stack.  It also works as a context manager that puts the previous mode
    back on exit.  Unlike ``jax_debug_nans`` it does not look at the
    forward's values, so a trainer that honours ``cfg.train.debug_nans``
    also checks each step's loss with ``finite_or_raise``.
  * ``check_finite(tree, name)`` — every non-finite floating leaf of nested
    dicts, lists, tuples, tensors, numpy arrays and floats (a
    ``state_dict``, an optimizer's ``state_dict``), as ``(path, "NaN" or
    "Inf")``; paths join dict keys (in sorted order, as JAX flattens them)
    and sequence indices with "/".
  * ``finite_or_raise(tree, name)`` — raises ``FloatingPointError`` naming
    the first 20 of them.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def enable_nan_debug(enable: bool = True) -> torch.autograd.set_detect_anomaly:
    return torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:  # keys of mixed types
            keys = list(tree)
        for k in keys:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _problem(leaf):
    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return None
        nan, inf = torch.stack([torch.isnan(leaf).any(), torch.isinf(leaf).any()]).tolist()
    else:
        a = np.asarray(leaf)
        if not np.issubdtype(a.dtype, np.floating):
            return None
        nan, inf = bool(np.isnan(a).any()), bool(np.isinf(a).any())
    return "NaN" if nan else "Inf" if inf else None


def check_finite(tree, name: str = "tree") -> List[Tuple[str, str]]:
    """Return [(path, problem)] for every non-finite leaf (empty = healthy)."""
    bad = []
    for path, leaf in _leaves(tree):
        problem = _problem(leaf)
        if problem is not None:
            bad.append(("/".join(str(k) for k in path), problem))
    return bad


def finite_or_raise(tree, name: str = "tree"):
    bad = check_finite(tree, name)
    if bad:
        lines = "\n".join(f"  {p}: {w}" for p, w in bad[:20])
        raise FloatingPointError(f"non-finite values in {name}:\n{lines}")
