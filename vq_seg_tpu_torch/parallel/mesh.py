"""The training mesh as process groups, counterpart of the JAX package's
``parallel/mesh.py``.

The JAX mesh has the axes ``data``, ``model`` and ``space`` over devices,
and GSPMD inserts the collectives.  Here one process drives one card (or
one CPU process of a ``gloo`` group), and the mesh holds, for this process:

  * its coordinates (d, m): data index and model index, laid out as the
    JAX package reshapes its devices, rank ``ranks[d * n_model + m]``;
  * ``data_group``: the ranks (d', m) for every d', which hold the same
    model on different shards of the batch (its gradients and its
    BatchNorm statistics are reduced over them);
  * ``pair_group``: the ranks (d, m') for every m', which hold the two CPS
    models on the same shard (the pair-sharded step swaps its pseudo
    labels over them); None when ``n_model`` is 1.

``space`` stays 1: spatial partitioning is not ported (ROADMAP.md, queue 1,
item 21).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_model: int
    ranks: tuple  # the mesh's global ranks in (d, m) order
    rank: int  # this process's global rank
    data_index: int
    model_index: int
    data_group: object
    pair_group: Optional[object]
    group: object  # every rank of the mesh

    @property
    def pair(self) -> bool:
        """Each CPS model on its own ranks (the pair-sharded step)."""
        return self.n_model == 2

    @property
    def backend(self) -> str:
        return dist.get_backend(self.data_group)

    def rank_of(self, d: int, m: int) -> int:
        return self.ranks[d * self.n_model + m]

    @property
    def is_main(self) -> bool:
        """The rank that logs, evaluates and writes: (0, 0)."""
        return self.rank == self.ranks[0]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_space: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The mesh over ``ranks`` (default: every rank of the initialised
    default group), ``n_data`` defaulting to all of them.  Every process of
    the default group must call it, in the same order as every other
    group it creates; a process outside ``ranks`` gets None."""
    if n_space != 1:
        raise NotImplementedError("spatial partitioning (a space axis > 1) is not ported yet "
                                  "(ROADMAP.md, queue 1, item 21)")
    if n_model not in (1, 2):
        raise ValueError(f"the model axis holds the CPS pair: 1 or 2, got {n_model}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(parallel.distributed.initialize)")
    ranks = tuple(range(dist.get_world_size()) if ranks is None else ranks)
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data < 1 or n_data * n_model > len(ranks):
        raise ValueError(f"a {n_data} x {n_model} mesh does not fit {len(ranks)} ranks")
    ranks = ranks[:n_data * n_model]
    group = dist.new_group(list(ranks))
    data_groups = [dist.new_group([ranks[d * n_model + m] for d in range(n_data)])
                   for m in range(n_model)]
    pair_groups = ([dist.new_group([ranks[d * n_model + m] for m in range(n_model)])
                    for d in range(n_data)] if n_model > 1 else [None] * n_data)
    me = dist.get_rank()
    if me not in ranks:
        return None
    d, m = divmod(ranks.index(me), n_model)
    return Mesh(n_data, n_model, ranks, me, d, m, data_groups[m], pair_groups[d], group)


def shard_batch_fn(mesh: Mesh):
    """A callable that returns this rank's rows of a global batch (a tensor
    or an array, batch on dim 0): data index d holds rows [d*b, (d+1)*b),
    as GSPMD lays a batch out over the ``data`` axis."""

    def shard(x):
        n = x.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"batch {n} does not divide over the {mesh.n_data} data ranks")
        b = n // mesh.n_data
        return x[mesh.data_index * b:(mesh.data_index + 1) * b]

    return shard


def shard_draw(draw, mesh: Optional[Mesh], rows: int):
    """``draw`` (a callable ``shape -> tensor``, a random mask drawn from a
    generator that every rank seeds alike) made to draw for the global
    batch: for a local shape (k * rows, ...) it draws (k * rows * n_data,
    ...) and returns this rank's rows of each of the k blocks of the
    global batch (a batch of ``rows`` per rank concatenated k times, as
    UniMatch's perturbed pass concatenates two).  So every rank draws what
    the single process draws, from the same generator state.  ``draw``
    itself without a mesh."""
    if mesh is None or mesh.n_data == 1:
        return draw

    def sharded(shape):
        k, extra = divmod(shape[0], rows)
        if extra:
            raise ValueError(f"a draw of {shape[0]} rows is not a multiple of the shard's {rows}")
        full = draw((k * rows * mesh.n_data, *shape[1:]))
        full = full.reshape(k, mesh.n_data, rows, *shape[1:])[:, mesh.data_index]
        return full.reshape(tuple(shape))

    return sharded


def pad_to_devices(batch_size: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= batch_size."""
    return -(-batch_size // n_devices) * n_devices
