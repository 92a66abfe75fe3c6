"""CLI trainer, the port's ``scripts/train.py``::

    python -m vq_seg_tpu_torch.train --config_path config/vqreptunet1x1v2.json

Runs on the card unless ``--device cpu`` is given.  The mode defaults to
the config's ``"mode"`` key, else ``cps``.  Ported: ``cps`` (the
flagship), ``reptcps`` (``config/vqreptunet1x1.json`` and its siblings),
``sup`` (``config/CWFID_Unet.json``, ``only_sup_kmeans.json``...),
``plaincps`` (``config/cps_vqv2*.json``, ``vqcanet.json``,
``vqatunet.json`` and the other attention networks), ``objcps``
(``config/vqcanet_obj_loss.json``, ``vqimdbnet.json``), ``vqpt``
(``config/vq_pt_unet.json``, ``vq_eu_pt_unet.json``, ``vq_nedpt_unet.json``,
``vqash.json``, ``vqash_deep.json``, ``vqashv2.json``), ``easyhard``
(``config/vq_pt_unet_easyhard.json``), ``angularv3``
(``config/vqreptunetangularv3.json``; ``vqreptunetangular.json`` trains
under ``reptcps``), ``supconcps`` (``config/sup_con_loss.json``),
``semiweed`` (``config/semiweednet.json``), ``selfsup``
(``config/vqvaev2_selfsup.json``), ``unimatch`` (the ``unimatch`` network;
no shipped config) and ``salientcps`` (``VQUnetwithSalientloss`` with
``train.salient_dir``; no shipped config): every mode of the JAX CLI, and
``sup`` also runs ``config/obia_CWFID.json`` (fcn32s on an OBIA tree), so
all 41 shipped configs train.  ``--trace DIR`` writes a ``torch.profiler``
trace of the whole run (host and card) into DIR, for TensorBoard or
``chrome://tracing``; keep the run short.

The JAX CLI's parallelism flags, for every mode but ``selfsup``, under
torchrun (one process per card, NCCL; ``--device cpu`` runs gloo
processes)::

    torchrun --nproc_per_node 4 -m vq_seg_tpu_torch.train --data_parallel \\
        --per_device_batch --config_path config/vqreptunet1x1v2.json

``--data_parallel`` shards each global batch over the processes, and the
step computes the single-process step on the global batch;
``--per_device_batch`` makes the config's ``batch_size`` per process.
``--pair_parallel`` puts each CPS model of ``--mode cps`` on its own
processes (with ``--data_parallel``: data x 2 processes); under the other
modes the two processes of a data index hold replicas, as GSPMD replicates
the parameters of the JAX drivers.  ``--zero`` shards Adam's moments
(ZeRO-1, with or without ``grad_accum_steps``) under ``--mode cps`` only,
as in the JAX CLI.  ``--mode selfsup`` takes no mesh, as in the JAX CLI:
the main process trains it alone and the others exit.  ``--spatial`` > 1
is not ported (ROADMAP.md, queue 1, item 21).
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import tempfile

from .config import load_config

MODES = ("cps", "sup", "selfsup", "plaincps", "unimatch", "salientcps", "vqpt", "reptcps",
         "angularv3", "easyhard", "objcps", "supconcps", "semiweed")
PORTED = MODES  # every mode of the JAX CLI trains here


def mesh_layout(cfg, data_parallel=False, per_device_batch=False, pair_parallel=False,
                spatial=1, world_size=1):
    """The mesh's (n_data, n_model) from the CLI's parallelism flags over
    ``world_size`` processes, or None when no parallelism was asked for,
    with the JAX CLI's checks (``resolve_mesh``).  With
    ``per_device_batch`` the config's ``batch_size`` is per process and is
    scaled in place to the global batch; otherwise the data axis is the
    gcd of the batch and the processes, and the others idle (a warning)."""
    if not (data_parallel or pair_parallel or spatial > 1):
        return None
    if spatial > 1:
        raise NotImplementedError("--spatial > 1 is not ported yet (ROADMAP.md, queue 1, "
                                  "item 21)")
    n_model = 2 if pair_parallel else 1
    avail = world_size // n_model
    if pair_parallel and avail < 1:
        raise SystemExit("--pair_parallel needs >= 2 processes")
    if not data_parallel:
        n_data = 1
    elif per_device_batch:
        n_data = avail
        cfg.train.batch_size = int(cfg.train.batch_size) * n_data
        print(f"--per_device_batch: global batch = {cfg.train.batch_size} over {n_data} "
              "data ranks")
    else:
        n_data = math.gcd(int(cfg.train.batch_size), avail)
        if n_data * n_model < world_size:
            print(f"--data_parallel: batch {cfg.train.batch_size} shards over {n_data} of "
                  f"{avail} data ranks (the data axis must divide the batch; use "
                  "--per_device_batch or raise batch_size to use every process)")
    return n_data, n_model


def resolve_mesh(cfg, data_parallel=False, per_device_batch=False, pair_parallel=False,
                 spatial=1, device="cuda"):
    """The training mesh from the CLI's flags (``mesh_layout``) over the
    processes of ``torch.distributed``: initialised from torchrun's
    environment, or as a group of one process without it.  None when no
    parallelism was asked for; a process outside the mesh gets ``False``."""
    if not (data_parallel or pair_parallel or spatial > 1):
        return None
    import torch.distributed as dist

    from .parallel import distributed
    from .parallel.mesh import make_mesh

    if not distributed.initialize(device=device):
        store = os.path.join(tempfile.mkdtemp(prefix="vq_seg_store_"), "store")
        distributed.initialize(f"file://{store}", 1, 0, device=device)
    layout = mesh_layout(cfg, data_parallel, per_device_batch, pair_parallel, spatial,
                         dist.get_world_size())
    mesh = make_mesh(*layout)
    return False if mesh is None else mesh


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("::")[0])
    parser.add_argument("--config_path", default="./config/vqreptunet1x1v2.json")
    parser.add_argument("--mode", default=None, choices=MODES,
                        help='trainer family; defaults to the config\'s "mode" key, else cps')
    parser.add_argument("--max_steps_per_epoch", type=int, default=None)
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run into DIR (keep "
                             "num_epochs small: the whole run is traced)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard each global batch over the processes (torchrun)")
    parser.add_argument("--per_device_batch", action="store_true",
                        help="with --data_parallel: the config's batch_size is per process "
                             "(global batch = batch_size x data ranks)")
    parser.add_argument("--zero", action="store_true",
                        help="cps mode: ZeRO-1, the Adam moments sharded over each model's "
                             "data ranks")
    parser.add_argument("--pair_parallel", action="store_true",
                        help="cps mode: each CPS model on its own processes (the other modes: "
                             "replicas); composes with --data_parallel")
    parser.add_argument("--spatial", type=int, default=1,
                        help="shard image rows over N processes (not ported yet)")
    opt = parser.parse_args(argv)
    cfg = load_config(opt.config_path)
    if opt.zero:
        cfg.train.zero_opt = True
    mode = opt.mode or cfg.get("mode") or "cps"
    mesh = resolve_mesh(cfg, opt.data_parallel, opt.per_device_batch, opt.pair_parallel,
                        opt.spatial, opt.device)
    if mesh is False:
        import torch.distributed as dist

        print(f"rank {dist.get_rank()} is outside the mesh and idles")
        dist.destroy_process_group()
        return
    kw = {} if mesh is None else {"mesh": mesh}
    from . import training

    trainer = {"cps": training.train, "reptcps": training.train_rept_cps,
               "sup": training.train_sup, "plaincps": training.train_plain_cps,
               "objcps": training.train_obj_cps, "vqpt": training.train_vqpt_cps,
               "easyhard": training.train_easyhard_cps,
               "angularv3": training.train_angularv3_cps,
               "supconcps": training.train_supcon_cps, "semiweed": training.train_semiweed,
               "selfsup": training.train_selfsup, "unimatch": training.train_unimatch,
               "salientcps": training.train_salient_cps}[mode]
    from .utils.profiling import trace

    idle = False
    if mesh is not None and mode == "selfsup":  # the JAX CLI passes selfsup no mesh
        idle, kw = not mesh.is_main, {}
        if idle:
            print(f"rank {mesh.rank}: --mode selfsup trains on the main process alone; "
                  "this one idles")
    if not idle:
        with trace(opt.trace) if opt.trace else contextlib.nullcontext():
            trainer(cfg, max_steps_per_epoch=opt.max_steps_per_epoch, device=opt.device, **kw)
        if opt.trace:
            print(f"profiler trace written to {opt.trace}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
