"""Process-group set-up and host sharding, counterpart of the JAX
package's ``parallel/distributed.py``.

``initialize`` brings up ``torch.distributed``: from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``) or from explicit arguments.  The backend is ``nccl`` for
processes that drive cards and ``gloo`` on the CPU.  Under ``nccl`` each
process takes the card ``LOCAL_RANK`` as its current device.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def default_backend(device="cuda") -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, backend: Optional[str] = None,
               device="cuda", timeout_s: float = 1800.0) -> bool:
    """Initialise the default process group; returns whether it is
    initialised.  A no-op when it already is.  With no arguments the
    environment (torchrun) gives the topology, and a process without one
    stays single (False).  Explicit arguments that fail raise: a swallowed
    failure would run single-process in silence."""
    if dist.is_initialized():
        return True
    backend = backend or default_backend(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None and world_size is None and rank is None:
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                             "MASTER_PORT")):
            return False
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    return True


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> list:
    """Deterministic per-process slice of a (sorted) item list: process i
    takes items[i::count].  Every process must pass the same order."""
    pi = dist.get_rank() if process_index is None else process_index
    pc = dist.get_world_size() if process_count is None else process_count
    return list(items)[pi::pc]
