"""Parallelism of the port, counterpart of the JAX package's ``parallel/``:
a ``Mesh`` of process groups (``mesh.py``), the process-group set-up and
host sharding (``distributed.py``), the batch-wide reductions that keep a
sharded step the single-process step (``collectives.py``) and ZeRO-1
(``zero.py``)."""
from .collectives import (average_gradients, batch_gather, batch_mean, batch_sum,  # noqa: F401
                          data_parallel)
from .mesh import Mesh, make_mesh, pad_to_devices, shard_batch_fn  # noqa: F401
from .zero import opt_bytes_per_chip, zero_adam  # noqa: F401
