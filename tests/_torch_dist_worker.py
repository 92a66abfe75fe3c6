"""Worker process of the port's gloo tests (``tests/test_torch_parallel.py``
and ``tests/test_torch_parallel_driver.py``), in the pattern of
``tests/_mp_worker.py``.  It imports torch, numpy and the port only: never
``tests/conftest.py`` or JAX.

    python tests/_torch_dist_worker.py JOB RANK

``JOB`` is a ``torch.save`` file: ``{"task", "world", "store", "out",
...}``.  The process joins a gloo group of ``world`` processes through the
``file://`` store ``store`` (so that test workers never contend for a
port), runs the task with one thread and writes its result to
``{out}/rank{RANK}.pt``.
"""
import datetime
import os
import shutil
import signal
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

TIMEOUT_S = 120


def _held_tensors(state, keep):
    """{"i.name": tensor} of the held models' state entries that ``keep``
    selects, i the model's index."""
    return {f"{i}.{k}": v.detach().clone() for i, model, _ in state.held()
            for k, v in model.state_dict().items() if keep(k)}


def _grads(state):
    return {f"{i}.{n}": p.grad.detach().clone() for i, model, _ in state.held()
            for n, p in model.named_parameters() if p.grad is not None}


def _run_step(job, mesh, kind):
    """One CPS step of ``kind`` on ``mesh`` from the job's start state."""
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.models import layers
    from vq_seg_tpu_torch.parallel import opt_bytes_per_chip, shard_batch_fn
    from vq_seg_tpu_torch.training.cps import (create_cps_state, make_cps_train_step,
                                               make_cps_train_step_pairsharded)

    st = create_cps_state(job["model_cfg"], lambda step: 1.0, device="cpu", mesh=mesh,
                          zero=kind == "zero")
    differed = st.replicas_differed
    for i, model, _ in st.held():
        model.load_state_dict(job["state"][i])
    dice = make_loss("dice_loss", 3, ignore_index=255)
    if mesh.pair:
        step = make_cps_train_step_pairsharded(dice, mesh, **job["step_kw"])
    else:
        step = make_cps_train_step(dice, mesh=mesh, **job["step_kw"])
    shard = shard_batch_fn(mesh)
    l_img, l_t, ul = job["batch"]
    real_active = layers.active_group
    if kind == "local_bn":  # the losses global, each rank's BN on its own rows
        layers.active_group = lambda: None
    try:
        st, metrics, ps, pu = step(st, shard(l_img), shard(l_t), shard(ul))
    finally:
        layers.active_group = real_active
    res = {"coords": (mesh.data_index, mesh.model_index), "metrics": metrics,
           "step": st.step, "differed": differed, "preds": (ps, pu),
           "grad_sums": {k: float(g.double().abs().sum()) for k, g in _grads(st).items()},
           "running": _held_tensors(st, lambda k: "running" in k)}
    if mesh.data_index == 0:
        res["grads"] = _grads(st)
    if kind == "zero":
        res["zero"] = {"opt_bytes": sum(opt_bytes_per_chip(o) for _, _, o in st.held()),
                       "param_bytes": sum(p.numel() * p.element_size()
                                          for _, m, _ in st.held() for p in m.parameters()),
                       "local_lr": [g["lr"] for _, _, o in st.held()
                                    for g in o.optim.param_groups],
                       "params_after": _held_tensors(st, lambda k: "running" not in k)}
    return res


def _run_init(job, mesh):
    from vq_seg_tpu_torch.parallel import shard_batch_fn
    from vq_seg_tpu_torch.training.cps import cps_init_phase, create_cps_state

    st = create_cps_state(job["model_cfg"], lambda step: 1.0, device="cpu", mesh=mesh)
    for i, model, _ in st.held():
        model.load_state_dict(job["pre_state"][i])
    shard = shard_batch_fn(mesh)
    l_img, l_t, _ = job["batch"]
    cps_init_phase(st, shard(l_img), shard(l_t), job["step_kw"]["confidence_threshold"],
                   seed=0, mesh=mesh)
    return {"coords": (mesh.data_index, mesh.model_index),
            "tables": _held_tensors(st, lambda k: "codebooks" in k or "prototype_loss" in k
                                    or "running" in k)}


def _ema_cfg(model_cfg):
    """The model config with the VQ EMA update and a restart threshold at
    which a code unused in a pass is revived."""
    import copy

    cfg = copy.deepcopy(model_cfg)
    cfg["params"]["vq_cfg"].update(ema=True, restart_threshold=0.9)
    return cfg


def run_ema(model_cfg, batch, step_kw, mesh=None):
    """A fresh EMA flagship (seed 0), its init phase and one CPS step, on
    ``mesh`` (this rank's shard) or in one process: the codebook state of
    each model and the metrics."""
    from vq_seg_tpu_torch.losses import make_loss
    from vq_seg_tpu_torch.parallel import shard_batch_fn
    from vq_seg_tpu_torch.training.cps import (cps_init_phase, create_cps_state,
                                               make_cps_train_step)

    st = create_cps_state(_ema_cfg(model_cfg), lambda step: 1.0, device="cpu", mesh=mesh)
    shard = shard_batch_fn(mesh) if mesh is not None else (lambda x: x)
    l_img, l_t, ul = (shard(t) for t in batch)
    cps_init_phase(st, l_img, l_t, step_kw["confidence_threshold"], seed=0, mesh=mesh)
    step = make_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), mesh=mesh,
                               **step_kw)
    st, metrics, _, _ = step(st, l_img, l_t, ul)
    return {"codebooks": _held_tensors(st, lambda k: "codebooks" in k), "metrics": metrics}


def _run_gathered_reductions(job, mesh):
    """The module-level reductions inside ``data_parallel`` on this rank's
    rows against the same functions without a group on all the rows, in
    the same process: k-means inits of a codebook and a prototype table,
    the class means and the percentile."""
    from vq_seg_tpu_torch.models.modules.prototype import (ReliablePrototypeLossv2,
                                                          class_mean_features, percentile)
    from vq_seg_tpu_torch.models.modules.vector_quantizer import VectorQuantizer
    from vq_seg_tpu_torch.parallel import data_parallel, shard_batch_fn

    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 16, 6, 6, generator=g)
    labels = torch.randint(0, 3, (4 * 36,), generator=g)
    shard = shard_batch_fn(mesh)
    mine = shard(x)
    rows = mine.permute(0, 2, 3, 1).reshape(-1, 16)
    my_labels = shard(labels.reshape(4, 36)).reshape(-1)
    out = {}
    for tag, group, xx, rr, ll in (("sharded", mesh.data_group, mine, rows, my_labels),
                                   ("single", None, x, x.permute(0, 2, 3, 1).reshape(-1, 16),
                                    labels)):
        vq = VectorQuantizer(16, 8, kmeans_init=True)
        proto = ReliablePrototypeLossv2(num_classes=3, embedding_dim=16, pt_init="kmeans")
        with data_parallel(group):
            vq.init_codebook_(xx, torch.Generator().manual_seed(1))
            proto._init_table(rr, ll, torch.Generator().manual_seed(2))
            out[tag] = {"codebook": vq.embedding.clone(), "table": proto.embedding.detach().clone(),
                        "class_means": class_mean_features(rr, ll, 3),
                        "percentile": percentile(rr[:, 0], 37.5)}
    return out


def task_steps(job, rank):
    """Rounds of meshes on disjoint rank sets; every rank builds every mesh
    of a round (group creation is collective) and runs the one it is in."""
    from vq_seg_tpu_torch.parallel import make_mesh

    out = {}
    for round_ in job["rounds"]:
        meshes = [(name, kind, make_mesh(n_data, n_model, ranks=ranks))
                  for name, kind, n_data, n_model, ranks in round_]
        for name, kind, mesh in meshes:
            if mesh is None:
                continue
            if kind == "init":
                out[name] = _run_init(job, mesh)
            elif kind == "reductions":
                out[name] = _run_gathered_reductions(job, mesh)
            elif kind == "ema":
                out[name] = run_ema(job["model_cfg"], job["batch"], job["step_kw"], mesh)
            else:
                out[name] = _run_step(job, mesh, kind)
    return out


def task_train(job, rank):
    """``cps.train`` on a data-parallel mesh of every rank; the rank
    ``sigterm_rank`` sends itself SIGTERM after its first step."""
    from vq_seg_tpu_torch.config import Config
    from vq_seg_tpu_torch.parallel import make_mesh
    from vq_seg_tpu_torch.training import cps
    from vq_seg_tpu_torch.utils.preemption import PreemptionGuard

    mesh = make_mesh(job["n_data"], job["n_model"])
    if rank == job["sigterm_rank"]:
        build = cps.make_cps_train_step

        def with_sigterm(*a, **k):
            step = build(*a, **k)

            def run(*args):
                out = step(*args)
                if out[0].step == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out
            return run
        cps.make_cps_train_step = with_sigterm
    history = []
    state = cps.train(Config(job["cfg"]), device="cpu", mesh=mesh, preempt=PreemptionGuard(),
                      history=history)
    return {"history": history, "step": state.step}


TASKS = {"steps": task_steps, "train": task_train}


def start(task: str, world: int, tmp_dir: str, **job):
    """Start ``task`` in ``world`` worker processes; returns ``wait()``,
    which returns their results in rank order and fails with the output of
    every worker that exited non-zero."""
    import subprocess

    os.makedirs(tmp_dir, exist_ok=True)
    job_path = os.path.join(tmp_dir, f"{task}_job.pt")
    torch.save({"task": task, "world": world, "store": os.path.join(tmp_dir, f"{task}_store"),
                "out": tmp_dir, **job}, job_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job_path, str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]

    def wait() -> list:
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
                  for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
        assert not failed, "\n".join(failed)
        results = [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
                   for r in range(world)]
        shutil.rmtree(tmp_dir, ignore_errors=True)  # the results are in memory now
        return results

    return wait


def main(job_path, rank):
    rank = int(rank)
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{job['store']}", rank=rank,
                            world_size=job["world"],
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = TASKS[job["task"]](job, rank)
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
