"""Worker process of the port's gloo tests (``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_driver.py`` and
``tests/test_torch_parallel_modes*.py``), in the pattern of
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


def _run_mode(job, mesh, mode, compare=True):
    """``mode``'s step on ``mesh`` (this rank's shard of the job's global
    batch), then, on the rank (0, 0) of the mesh, the single-process step
    from the same start on the whole batch and their distances
    (``_parallel_modes.compare``).  Every rank returns its metrics and a
    digest of its parameters after the step."""
    import _parallel_modes as pm

    cfg = pm.tiny_cfg(mode)
    batch = job["batch"]
    start = job.get("start", {}).get(mode)
    masks = job.get("masks", {}).get(mode)
    state = pm.make_state(mode, cfg, batch, mesh, start)
    metrics = pm.run_step(mode, cfg, state, pm.make_step(mode, cfg, state, mesh), batch, mesh,
                          masks)
    res = {"coords": (mesh.data_index, mesh.model_index), "metrics": metrics,
           "digest": pm.param_digest(state), "step": state.step}
    if mode in job.get("keep_grads", ()) and mesh.data_index == 0 and mesh.model_index == 0:
        res["grads"] = {k: g.float() for k, g in pm.snapshot(state)["grads"].items()}
    if compare and mesh.rank == mesh.ranks[0]:
        snap = pm.snapshot(state)
        del state
        single = pm.make_state(mode, cfg, batch, None, start)
        want_m = pm.run_step(mode, cfg, single, pm.make_step(mode, cfg, single), batch,
                             None, masks)
        res["single_metrics"] = want_m
        res["compare"] = pm.compare(metrics, snap, want_m, pm.snapshot(single))
    return res


def _run_cross(mesh):
    """The cross-item operations inside ``data_parallel`` on this rank's
    rows against the same functions on the whole batch in this process:
    values, and each input's gradient (divided by the ranks, the mean that
    ``average_gradients`` takes) against the single process's rows."""
    from vq_seg_tpu_torch.data.augmentations import cutmix, make_cutout_mask
    from vq_seg_tpu_torch.losses import dc_loss, supcon_loss
    from vq_seg_tpu_torch.parallel import data_parallel, shard_batch_fn
    from vq_seg_tpu_torch.parallel.collectives import batch_sum
    from vq_seg_tpu_torch.parallel.mesh import shard_draw

    shard = shard_batch_fn(mesh)
    r = mesh.n_data
    g = torch.Generator().manual_seed(11)
    out = {}

    def both(name, fn, *inputs):
        """fn(*inputs) -> scalar, on the whole batch and on the shards."""
        vals, grads = [], []
        for group, xs in ((None, inputs), (mesh.data_group, [shard(x) for x in inputs])):
            xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in xs]
            with data_parallel(group):
                v = fn(*xs)
            v.backward()
            vals.append(float(v))
            grads.append([None if x.grad is None else x.grad / (1 if group is None else r)
                          for x in xs])
        out[name] = {"value": vals[1], "single": vals[0],
                     "grad_err": max(float((gm - shard(gs)).abs().max())
                                     for gs, gm in zip(*grads) if gs is not None)}

    for n in (r, 2 * r):  # one item per rank, then two
        x = torch.randn(n, 3, 8, 8, generator=g, dtype=torch.float64)
        w = torch.randn(n, 3, 8, 8, generator=g, dtype=torch.float64)
        labels = torch.randint(0, 3, (n, 8, 8), generator=g)
        mask = make_cutout_mask(g, (8, 8), 0.5)
        both(f"cutmix_{n}", lambda xx, ww: batch_sum(torch.sum(cutmix(xx, mask) * ww)), x, w)
        mixed = cutmix(labels, mask)
        with data_parallel(mesh.data_group):
            out[f"cutmix_labels_{n}"] = bool(torch.equal(cutmix(shard(labels), mask),
                                                         shard(mixed)))
        feats = torch.randn(n, 4, 8, 8, generator=g, dtype=torch.float64)
        both(f"supcon_{n}", lambda f, lab: supcon_loss(f, lab, block_rows=16), feats, labels)
        phi1 = torch.rand(n, 5, generator=g, dtype=torch.float64)
        phi2 = torch.rand(n, 5, generator=g, dtype=torch.float64)
        both(f"dc_{n}", dc_loss, phi1, phi2)
        # a draw for a 2-block batch (UniMatch's perturbed pass): this rank's rows of each block
        draw = lambda shape: torch.arange(shape[0] * 3).reshape(shape[0], 3)  # noqa: E731
        rows = n // r
        full = draw((2 * n, 3)).reshape(2, n, 3)
        want = torch.cat([shard(full[0]), shard(full[1])])
        out[f"draw_{n}"] = bool(torch.equal(shard_draw(draw, mesh, rows)((2 * rows, 3)), want))
    return out


def _run_zero_accum(mesh):
    """Item 24 on a data-parallel mesh: ZeRO-1 over ``MultiStepAdam`` (k=2)
    against a replicated ``MultiStepAdam`` on the same gradients (drawn
    alike on every rank: the averaged gradients), after 2 and 4
    micro-steps; the consolidated state after 3 micro-steps against the
    replicated one; a ZeRO resume from it and a single-process resume from
    it, each after the 4th micro-step, against the unbroken run."""
    import copy

    from vq_seg_tpu_torch.parallel import zero_adam
    from vq_seg_tpu_torch.training.cps import MultiStepAdam

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(6, 9), torch.nn.Linear(9, 7),
                              torch.nn.Linear(7, 3), torch.nn.Linear(3, 2))
    kw = dict(lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)

    def micro(params, opt, i):
        g = torch.Generator().manual_seed(100 + i)
        for p in params:
            p.grad = torch.randn(p.shape, generator=g)
        for group in opt.param_groups:
            group["lr"] = 1e-2 * (1 + i // 2)
        opt.step()

    nets = {"zero": copy.deepcopy(net), "rep": copy.deepcopy(net)}
    opts = {"zero": zero_adam(nets["zero"].parameters(), mesh.data_group, 2, **kw),
            "rep": MultiStepAdam(nets["rep"].parameters(), 2)}
    out = {"bitwise": {}, "local_accs": 0}
    snap = {}
    for i in range(4):
        for k in ("zero", "rep"):
            micro(list(nets[k].parameters()), opts[k], i)
        if i in (1, 3):
            out["bitwise"][i + 1] = all(torch.equal(a, b) for a, b in zip(
                nets["zero"].parameters(), nets["rep"].parameters()))
        if i == 2:
            out["local_accs"] = len(opts["zero"].optim.acc_grads)
            opts["zero"].consolidate_state_dict(to=0)
            sd = None
            if mesh.data_index == 0:  # (a state dict holds the live tensors: copy it)
                sd, want = copy.deepcopy(opts["zero"].state_dict()), opts["rep"].state_dict()
                out["state_equal"] = _same_tree(sd, want)
                out["mini_step"] = (sd["mini_step"], want["mini_step"])
            snap = {"params": copy.deepcopy(nets["zero"].state_dict()),
                    "sd": _from_rank0(mesh, sd)}
    final = [p.detach().clone() for p in nets["rep"].parameters()]
    # a resume after the 3rd micro-step, on the mesh and in one process
    for tag in ("zero", "rep"):
        resumed = copy.deepcopy(net)
        resumed.load_state_dict(snap["params"])
        opt = (zero_adam(resumed.parameters(), mesh.data_group, 2, **kw) if tag == "zero"
               else MultiStepAdam(resumed.parameters(), 2))
        opt.load_state_dict(copy.deepcopy(snap["sd"]))
        micro(list(resumed.parameters()), opt, 3)
        out[f"resume_{tag}"] = all(torch.equal(a, b) for a, b in zip(resumed.parameters(),
                                                                    final))
    return out


def _same_tree(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    return a == b


def _from_rank0(mesh, value):
    box = [value]
    dist.broadcast_object_list(box, mesh.ranks[0], group=mesh.group)
    return box[0]


def task_modes(job, rank):
    """Rounds of meshes on disjoint rank sets (every rank builds every mesh
    of a round); each mesh runs its list of scenarios: ``("mode", m)``
    (``("mode", m, False)``: without the single-process comparison),
    ``("cross",)`` or ``("zero_accum",)``."""
    from vq_seg_tpu_torch.parallel import make_mesh

    out = {}
    for round_ in job["rounds"]:
        meshes = [(name, runs, make_mesh(n_data, n_model, ranks=ranks))
                  for name, runs, n_data, n_model, ranks in round_]
        for name, runs, mesh in meshes:
            if mesh is None:
                continue
            for run in runs:
                key = f"{name}/{run[1] if len(run) > 1 else run[0]}"
                if run[0] == "mode":
                    out[key] = _run_mode(job, mesh, run[1], compare=len(run) < 3 or run[2])
                elif run[0] == "cross":
                    out[key] = _run_cross(mesh)
                else:
                    out[key] = _run_zero_accum(mesh)
    return out


def task_cli(job, rank):
    """``python -m vq_seg_tpu_torch.train ARGV`` for each of the job's
    ``argvs`` on every rank, the process group re-joined through a new store
    before each (the CLI destroys it when it ends).  The mode's driver is
    wrapped to record its history and the mesh it got."""
    from vq_seg_tpu_torch import train as cli
    from vq_seg_tpu_torch import training

    out = []
    for n, argv in enumerate(job["argvs"]):
        if n:
            dist.init_process_group("gloo", init_method=f"file://{job['store']}{n}", rank=rank,
                                    world_size=job["world"],
                                    timeout=datetime.timedelta(seconds=TIMEOUT_S))
        record = {"history": [], "mesh": None, "called": False}
        name = job["drivers"][n]
        real = getattr(training, name)

        def driver(cfg, *, _real=real, _record=record, **kw):
            _record.update(called=True, mesh=None if kw.get("mesh") is None
                           else (kw["mesh"].n_data, kw["mesh"].n_model))
            return _real(cfg, history=_record["history"], **kw)
        setattr(training, name, driver)
        try:
            cli.main(argv)
        finally:
            setattr(training, name, real)
        out.append(record)
    return out


TASKS = {"steps": task_steps, "train": task_train, "modes": task_modes, "cli": task_cli}


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
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
