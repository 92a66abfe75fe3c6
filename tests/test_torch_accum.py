"""Port parity: gradient accumulation (``train.grad_accum_steps``), the
port's ``MultiStepAdam`` against the JAX package's ``optax.MultiSteps``, on
the CPU at resnet18 / K=8 / 64x64, batch 2, f32.

  * ``MultiStepAdam`` alone against ``optax.MultiSteps(optax.adam(schedule),
    every_k_schedule=3)`` on 7 micro-steps of random gradients: the
    parameters and the running mean within 1e-6 relative, the micro-step
    and update counters equal, and the parameters bitwise unchanged on the
    micro-steps that do not update.
  * The CPS driver with ``grad_accum_steps`` 2 (one epoch of 5 micro-steps,
    so that it ends mid-accumulation) in both packages, the port starting
    from JAX's states as ``tests/test_torch_driver.py`` does.  After each
    micro-step: ``state.step``, the running mean's micro-step count and the
    updates applied equal; the LR Adam applied equal to JAX's
    ``schedule(updates)`` (1e-6 relative); the loss terms within 1e-3
    relative and the mIoU within 1e-3 (``tests/test_torch_training.py``'s
    bounds for Adam steps); the parameters of both models bitwise as before
    on a micro-step that does not update, and moved on one that does.
    Adam's first updates move each parameter by about +-LR (1e-4), and an
    element whose gradient is near zero can take opposite signs in the two
    packages' f32 arithmetic, so every parameter lies within 2 LR per
    update of JAX's, and after the first update at most 1e-3 of the
    elements lie further than 1e-5 from it (3.9e-4 measured).  BN running
    statistics within 1e-5 (the step test's bound) while the forwards saw
    the same parameters, then within 1e-2 of each tensor's largest
    magnitude (statistics over 8 values per channel of parameters that
    now differ as above; 3.2e-3 measured after two updates); codebooks
    equal.  The epoch's records compared as ``tests/test_torch_driver.py``
    compares them: loss terms 1e-3 relative, IoUs 1e-3 absolute, the
    logged LR (JAX's ``schedule(micro-steps - 1)``) equal.
  * Resume mid-accumulation: JAX's ``last.ckpt`` (one micro-step into the
    running mean) converted by ``tools/jax_ckpt_to_port.py``: the running
    mean and Adam's moments equal JAX's exactly, ``state.step`` 5, 2
    updates, and the resumed epoch's first micro-step completes the mean
    and updates at ``schedule(2)``.  The port's own ``last.ckpt`` restored
    into a fresh state steps bitwise as the state that wrote it.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import copy
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import cps as jcps
from vq_seg_tpu.training.schedules import cosine_annealing as jax_cosine
from vq_seg_tpu.utils.ckpoints import load_full as jax_load_full
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.training import cps
from vq_seg_tpu_torch.training.schedules import cosine_annealing, make_lr_schedule
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import cps_state_from_flax, state_dict_from_flax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import jax_ckpt_to_port  # noqa: E402
from _slice_parity import JitModel  # noqa: E402

torch.set_num_threads(1)

NUM_EMB = [0, 0, 8, 8, 8]
K = 2
STEPS = 5
LR = 1e-4
LOSSES = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss", "prototype_loss")
IOUS = ("miou", "back_iou", "weed_iou", "crop_iou", "test_miou")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_multistep_adam_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(7)]
    schedule = cosine_annealing(1e-2, 1e-4, 4)
    tx = optax.MultiSteps(optax.adam(jax_cosine(1e-2, 1e-4, 4), b1=0.9, b2=0.999),
                          every_k_schedule=3)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = cps.MultiStepAdam(tp, 3)
    for i, g in enumerate(grads):
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        before = [p.detach().clone() for p in tp]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        for group in opt.param_groups:
            group["lr"] = schedule(i // 3)
        opt.step()
        emitted = (i + 1) % 3 == 0
        assert opt.mini_step == int(jstate.mini_step) == (i + 1) % 3
        assert int(jstate.gradient_step) == (i + 1) // 3
        for p, b, j in zip(tp, before, jp):
            assert torch.equal(p, b) != emitted, i
            assert _rel(p.detach().numpy(), np.asarray(j)) <= 1e-6, i
        for p, j in zip(tp, jstate.acc_grads):
            assert _rel(opt.acc_grads[p].numpy(), np.asarray(j)) <= 1e-6 or not np.any(j), i
    sd = opt.state_dict()
    assert sd["mini_step"] == 1 and sorted(sd["acc_grads"]) == [0, 1, 2]
    assert int(sd["state"][0]["step"]) == 2


def _tree(root):
    """A PNG tree: 4 labelled and 10 unlabelled train images, 2 test."""
    rng = np.random.default_rng(7)
    for split, n_img, n_lab in (("train", 14, 4), ("test", 2, 2)):
        for sub in ("input", "target"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n_img):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                os.path.join(root, split, "input", f"im{i:03d}.png"))
            if i < n_lab:
                mask = rng.choice([0, 128, 255], size=(40, 40)).astype(np.uint8)
                Image.fromarray(mask, mode="L").save(
                    os.path.join(root, split, "target", f"im{i:03d}.png"))


def _cfg(data_dir, save_dir, **train):
    cfg = {
        "project_name": "acc", "wandb_logging": True, "num_classes": 3,
        "pixel_to_label": {"0": 0, "128": 1, "255": 2}, "resize": 64,
        "model": {"name": "vqreptunet1x1v2", "params": {
            "encoder_name": "resnet18", "num_classes": 3, "depth": 5,
            "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True},
            "margin": 0.5, "scale": 30.0}},
        "train": {"data_dir": data_dir, "save_dir": save_dir, "num_epochs": 1, "batch_size": 2,
                  "learning_rate": 1e-4,
                  "lr_scheduler": {"name": "cosineannealing", "min_lr": 1e-7, "warmup_steps": 0},
                  "half": False, "init_weights": False, "bn_eps": 1e-5, "bn_momentum": 0.1,
                  "criterion": {"name": "dice_loss"}, "cps_loss_weight": 1,
                  "total_commitment_loss_weight": 1, "total_prototype_loss_weight": 0.01,
                  "confidence_threshold": 0.7, "resume": None, "save_img": False,
                  "save_txt": True, "test_every": 1, "light_snapshots": True,
                  "grad_accum_steps": K, "wandb_log": ["loss", "learning_rate", "miou"]},
        "test": {"data_dir": data_dir, "save_dir": os.path.join(save_dir, "..", "test"),
                 "batch_size": 1, "weights": None},
    }
    cfg["train"].update(train)
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jsonl(run_dir):
    [name] = [n for n in os.listdir(run_dir) if n.endswith(".jsonl")]
    return [json.loads(line) for line in open(os.path.join(run_dir, name))]


def _port_snapshot(state, metrics):
    return dict(metrics={k: metrics[k].numpy() for k in LOSSES + ("miou",)}, step=state.step,
                mini_step=state.opt_1.mini_step, updates=state.updates,
                lr=state.opt_1.param_groups[0]["lr"],
                models=[{k: t.clone() for k, t in m.state_dict().items()}
                        for m in (state.model_1, state.model_2)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX driver, then the port's from JAX's states, each with a
    snapshot after every micro-step."""
    base = tmp_path_factory.mktemp("accum")
    data = str(base / "data")
    _tree(data)
    captured, jsnaps = {}, []
    real_create, real_init = jcps.create_cps_state, jcps.cps_init_phase
    real_stacked = jcps.make_cps_train_step_stacked

    def jax_create(*a, **k):
        st = real_create(*a, **k)
        captured["pre"] = _np(st)
        return st

    def jax_init(*a, **k):
        st = real_init(*a, **k)
        captured["post"] = _np(st)
        return st

    def jax_stacked(*a, **k):
        step = real_stacked(*a, **k)

        def run(state, *batch):
            out = step(state, *batch)
            st = out[0]
            inner = st.opt_state_1.inner_opt_state[0]
            v = st.variables_1
            jsnaps.append(dict(
                metrics={k: np.asarray(out[1][k]) for k in LOSSES + ("miou",)},
                step=int(st.step), mini_step=int(st.opt_state_1.mini_step),
                updates=int(st.opt_state_1.gradient_step), count=int(inner.count),
                models=[_np(jax.tree_util.tree_map(lambda x: x[i], v)) for i in range(2)]))
            return out

        return run

    jfastimg.load()  # see tests/test_torch_driver.py: the decoder loads before the loader runs
    mp = pytest.MonkeyPatch()
    mp.setattr(jcps, "create_cps_state", jax_create)
    mp.setattr(jcps, "make_model", lambda model_cfg: JitModel(jax_make_model(model_cfg)))
    mp.setattr(jcps, "cps_init_phase", jax_init)
    mp.setattr(jcps, "make_cps_train_step_stacked", jax_stacked)
    try:
        jcps.train(JaxConfig(_cfg(data, str(base / "jax"))), max_steps_per_epoch=STEPS)
    finally:
        mp.undo()

    psnaps = []
    real_port_create, real_step = cps.create_cps_state, cps.make_cps_train_step

    def port_create(model_cfg, schedule, **k):
        return cps_state_from_flax(real_port_create(model_cfg, schedule, **k), captured["pre"],
                                   NUM_EMB)

    def port_init(state, *a, **k):
        return cps_state_from_flax(state, captured["post"], NUM_EMB)

    def port_step(*a, **k):
        step = real_step(*a, **k)

        def run(state, *batch):
            out = step(state, *batch)
            psnaps.append(_port_snapshot(out[0], out[1]))
            return out

        return run

    mp.setattr(cps, "create_cps_state", port_create)
    mp.setattr(cps, "cps_init_phase", port_init)
    mp.setattr(cps, "make_cps_train_step", port_step)
    history = []
    try:
        state = cps.train(Config(_cfg(data, str(base / "port"))), max_steps_per_epoch=STEPS,
                          device="cpu", history=history)
    finally:
        mp.undo()
    pre_models = [state_dict_from_flax(captured["post"].variables_1, NUM_EMB),
                  state_dict_from_flax(captured["post"].variables_2, NUM_EMB)]
    yield dict(base=base, data=data, jsnaps=jsnaps, psnaps=psnaps, state=state,
               history=history, pre=pre_models,
               jax_run=str(base / "jax" / "acc_hybrid_0"),
               port_run=str(base / "port" / "acc_hybrid_0"))
    shutil.rmtree(base, ignore_errors=True)


def test_micro_steps_match_jax(runs):
    jsnaps, psnaps = runs["jsnaps"], runs["psnaps"]
    assert len(jsnaps) == len(psnaps) == STEPS
    schedule = cosine_annealing(1e-4, 1e-7, 5)  # the schedule spans the epoch's 5 batches
    before = runs["pre"]
    for i, (j, p) in enumerate(zip(jsnaps, psnaps)):
        emitted = (i + 1) % K == 0
        assert p["step"] == j["step"] == i + 1
        assert p["mini_step"] == j["mini_step"] == (i + 1) % K
        assert p["updates"] == j["updates"] == j["count"] == (i + 1) // K
        if emitted:  # the rate of the update this micro-step applied
            np.testing.assert_allclose(p["lr"], float(jax_cosine(1e-4, 1e-7, 5)(j["count"] - 1)),
                                       rtol=1e-6)
            assert p["lr"] == schedule(j["count"] - 1)
        for k in LOSSES:
            np.testing.assert_allclose(p["metrics"][k], j["metrics"][k], rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(p["metrics"]["miou"], j["metrics"]["miou"], atol=1e-3)
        params = {n for n, _ in runs["state"].model_1.named_parameters()}
        dev = []
        for m, (sd, jv) in enumerate(zip(p["models"], j["models"])):
            want = state_dict_from_flax(jv, NUM_EMB)
            moved = False
            for k, t in sd.items():
                if k in params:
                    same = torch.equal(t, before[m][k])
                    moved |= not same
                    if not emitted:
                        assert same, (i, m, k)
                    dev.append(np.abs(t.numpy() - want[k].numpy()).ravel())
                elif "codebooks" in k:
                    np.testing.assert_array_equal(t.numpy(), want[k].numpy(), err_msg=k)
                elif "running" in k and p["updates"] == 0:
                    np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                               err_msg=f"micro-step {i}: {k}")
                elif "running" in k:
                    ref = want[k].numpy()
                    assert np.abs(t.numpy() - ref).max() <= 1e-2 * np.abs(ref).max(), (i, k)
            assert moved == emitted, (i, m)
        dev = np.concatenate(dev)
        assert dev.max() <= 2 * LR * p["updates"], (i, dev.max())
        if p["updates"] == 1:
            assert (dev > 1e-5).mean() <= 1e-3, (i, (dev > 1e-5).mean())
        before = p["models"]


def test_epoch_record_matches_jax(runs):
    [jrec] = _jsonl(runs["jax_run"])
    [rec] = _jsonl(runs["port_run"])
    assert set(jrec) == set(rec)
    for k in LOSSES:
        np.testing.assert_allclose(rec[k], jrec[k], rtol=1e-3, err_msg=k)
    for k in IOUS:
        np.testing.assert_allclose(rec[k], jrec[k], atol=1e-3, err_msg=k)
    # logged over micro-steps, as JAX logs it: schedule(5 - 1), not schedule(2 updates)
    np.testing.assert_allclose(rec["learning_rate"], jrec["learning_rate"], rtol=1e-6)
    assert rec["learning_rate"] == cosine_annealing(1e-4, 1e-7, 5)(STEPS - 1)
    [h] = runs["history"]
    assert h["step_start"] == 0 and h["step"] == STEPS
    assert h["lr_start"] == cosine_annealing(1e-4, 1e-7, 5)(0)


def test_resume_mid_accumulation_from_jax(runs, tmp_path):
    jlast = os.path.join(runs["jax_run"], "ckpoints", "last.ckpt")
    dst = str(tmp_path / "last.ckpt")
    cfg = _cfg(runs["data"], str(tmp_path / "runs"), num_epochs=2, resume=dst, test_every=0)
    jax_ckpt_to_port.convert(jlast, dst, cfg["model"])
    ck = ckpoints.load_full(dst)
    jck = jax_load_full(jlast)
    names = [n for n, _ in runs["state"].model_1.named_parameters()]
    for i in (1, 2):
        opt, jopt = ck[f"optimizer_{i}"], jck[f"optimizer_{i}"]
        assert opt["mini_step"] == int(jopt["mini_step"]) == STEPS % K
        jvars = jck[f"model_{i}"]
        for key, tree in (("acc_grads", jopt["acc_grads"]),
                          ("exp_avg", jopt["inner_opt_state"][0]["mu"]),
                          ("exp_avg_sq", jopt["inner_opt_state"][0]["nu"])):
            want = state_dict_from_flax({**jvars, "params": tree}, NUM_EMB)
            for idx, name in enumerate(names):
                got = opt["acc_grads"][idx] if key == "acc_grads" else opt["state"][idx][key]
                np.testing.assert_array_equal(got.numpy(), want[name].numpy(), err_msg=name)
        assert {int(s["step"]) for s in opt["state"].values()} == {STEPS // K}

    state = cps.create_cps_state(cfg["model"], cosine_annealing(1e-4, 1e-7, 10),
                                 grad_accum_steps=K, device="cpu")
    cps.restore_cps_state(state, ck)
    assert state.step == STEPS and state.updates == STEPS // K
    assert state.opt_1.mini_step == STEPS % K

    history, seen = [], []
    real_step = cps.make_cps_train_step

    def spy(*a, **k):
        step = real_step(*a, **k)

        def run(st, *batch):
            before = next(st.model_1.parameters()).detach().clone()
            out = step(st, *batch)
            seen.append((st.opt_1.param_groups[0]["lr"],
                         not torch.equal(before, next(st.model_1.parameters()))))
            return out

        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(cps, "make_cps_train_step", spy)
    try:
        cps.train(Config(cfg), max_steps_per_epoch=1, device="cpu", history=history)
    finally:
        mp.undo()
    [h] = history
    schedule = make_lr_schedule(Config(cfg).train, 5)
    assert h["epoch"] == 1 and h["step_start"] == STEPS and h["step"] == STEPS + 1
    assert h["lr_start"] == schedule(STEPS // K)
    assert seen == [(schedule(STEPS // K), True)]  # the mean completes and Adam updates


def test_port_resume_round_trip_mid_accumulation(runs):
    last = os.path.join(runs["port_run"], "ckpoints", "last.ckpt")
    ck = ckpoints.load_full(last)
    assert ck["optimizer_1"]["mini_step"] == STEPS % K
    cfg = _cfg("", "")
    trained = runs["state"]
    fresh = cps.create_cps_state(cfg["model"], trained.schedule, grad_accum_steps=K, device="cpu")
    cps.restore_cps_state(fresh, ck)
    assert fresh.step == trained.step == STEPS
    for a, b in ((trained.opt_1, fresh.opt_1), (trained.opt_2, fresh.opt_2)):
        for p, q in zip(a._params(), b._params()):
            assert torch.equal(a.acc_grads[p], b.acc_grads[q])
    rng = np.random.default_rng(3)
    l_img = torch.from_numpy(rng.uniform(size=(2, 3, 64, 64)).astype(np.float32))
    l_t = torch.from_numpy(rng.integers(0, 3, size=(2, 64, 64)))
    ul = torch.from_numpy(rng.uniform(size=(2, 3, 64, 64)).astype(np.float32))
    step = cps.make_cps_train_step(cps.make_loss("dice_loss", 3, ignore_index=255),
                                   num_classes=3)
    copy_of_trained = copy.deepcopy(trained)
    for st in (copy_of_trained, fresh):
        step(st, l_img, l_t, ul)
    assert fresh.step == STEPS + 1 and fresh.opt_1.mini_step == 0
    for m, n in ((copy_of_trained.model_1, fresh.model_1),
                 (copy_of_trained.model_2, fresh.model_2)):
        for (k, t), u in zip(m.state_dict().items(), n.state_dict().values()):
            assert torch.equal(t, u), k
