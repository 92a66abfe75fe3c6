"""Port parity: the CPS driver (``training/cps.py::train``, ``evaluate``,
resume, preemption) and the two CLIs, on the CPU at resnet18 / K=8 /
64x64, batch 2, over a PNG tree made as ``tests/conftest.py`` makes it.

The JAX package's ``cps.train`` and the port's ``train`` run once each (a
module fixture: the JAX driver's CPU compile is most of this file's time)
on the same tree and config: f32, 1 epoch, ``max_steps_per_epoch=2``,
``init_weights``, a ``save_dir`` and the JSONL logger.  JAX's random draws
cannot be matched, so the port starts where JAX does: its state factory
returns JAX's state mapped by ``cps_state_from_flax``, and its init phase
takes JAX's post-init state (the k-means draws differ between the
packages); both are captured from the JAX run itself.  Then:

  * the epoch's averaged loss terms within 1e-3 relative, IoUs within 1e-3
    absolute, the LR equal;
  * every parameter of both models within 3e-4 (the JAX package's own
    scan-vs-plain driver bound); the BN running statistics, which are
    statistics of activations of those parameters over as few as 8 values
    per channel at stage 5, within 3e-3 of each tensor's largest magnitude
    (1.2e-3 measured); codebooks equal;
  * the same run directory, checkpoint files and contract keys.

Port-only: resume ("auto" continues at the saved epoch + 1 with models and
optimizers restored bitwise and the LR at ``schedule(step)``), preemption
(a full-contract ``last.ckpt``, then a stop), ``evaluate`` against JAX's
``evaluate`` on mapped weights (1e-6), the test CLI's sweep, the train CLI
in a subprocess, and what is not ported (the test CLI's ``--crf``)
raising.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.data import dataset as jds
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import cps as jcps
from vq_seg_tpu.utils.ckpoints import load_full as jax_load_full
from vq_seg_tpu_torch import test as test_cli
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.data import BaseDataset, Loader
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.training import cps
from vq_seg_tpu_torch.training.schedules import make_lr_schedule
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import cps_state_from_flax, state_dict_from_flax
from vq_seg_tpu_torch.utils.preemption import PreemptionGuard

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_EMB = [0, 0, 8, 8, 8]
CONTRACT = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
LOSSES = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss", "prototype_loss")
IOUS = ("miou", "back_iou", "weed_iou", "crop_iou", "test_miou")


def _cfg(data_dir, save_dir, **train):
    cfg = {
        "project_name": "drv", "wandb_logging": True, "num_classes": 3,
        "pixel_to_label": {"0": 0, "128": 1, "255": 2}, "resize": 64,
        "model": {"name": "vqreptunet1x1v2", "params": {
            "encoder_name": "resnet18", "num_classes": 3, "depth": 5,
            "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True},
            "margin": 0.5, "scale": 30.0}},
        "train": {"data_dir": data_dir, "save_dir": save_dir, "num_epochs": 1, "batch_size": 2,
                  "learning_rate": 1e-4,
                  "lr_scheduler": {"name": "cosineannealing", "min_lr": 1e-7, "warmup_steps": 0},
                  "half": False, "init_weights": True, "bn_eps": 1e-5, "bn_momentum": 0.1,
                  "criterion": {"name": "dice_loss"}, "cps_loss_weight": 1,
                  "total_commitment_loss_weight": 1, "total_prototype_loss_weight": 0.01,
                  "confidence_threshold": 0.7, "resume": None, "save_img": True,
                  "save_txt": True, "save_as_tar": False, "test_every": 1,
                  "wandb_log": ["loss", "learning_rate", "miou"]},
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


def _listing(run_dir):
    return sorted(os.path.relpath(os.path.join(d, n), run_dir)
                  for d, dirs, files in os.walk(run_dir) for n in dirs + files
                  if "ckpoints/" not in os.path.relpath(os.path.join(d, n), run_dir))


@pytest.fixture(scope="module")
def runs(synthetic_dataset, tmp_path_factory):
    """The JAX driver, then the port's from JAX's states."""
    base = tmp_path_factory.mktemp("driver")
    captured = {}
    real_create, real_init = jcps.create_cps_state, jcps.cps_init_phase

    # numpy copies: the driver's step donates the state's buffers
    def jax_create(*a, **k):
        st = real_create(*a, **k)
        captured["pre"] = _np(st)
        return st

    def jax_init(model, state, l_img, l_target, th, *a, **k):
        captured["batch"] = (np.asarray(l_img), np.asarray(l_target))
        st = real_init(model, state, l_img, l_target, th, *a, **k)
        captured["post"] = _np(st)
        return st

    # the JAX package's fastimg.load() gives None to a decode thread that
    # asks while another thread loads the library, and that item then
    # decodes through PIL (up to 2/255 off): load it before its loader runs
    jfastimg.load()
    mp = pytest.MonkeyPatch()
    mp.setattr(jcps, "create_cps_state", jax_create)
    mp.setattr(jcps, "cps_init_phase", jax_init)
    jcfg = JaxConfig(_cfg(synthetic_dataset, str(base / "jax")))
    try:
        jstate = jcps.train(jcfg, max_steps_per_epoch=2)
    finally:
        mp.undo()
    v1, v2 = jcps.unstack_cps_state(jstate)
    pre, post = captured["pre"], captured["post"]

    port_batches = []
    real_port_create = cps.create_cps_state

    def port_create(model_cfg, schedule, **k):
        return cps_state_from_flax(real_port_create(model_cfg, schedule, **k), pre, NUM_EMB)

    def port_init(state, l_img, l_target, th, **k):
        port_batches.append((l_img.clone(), l_target.clone()))
        return cps_state_from_flax(state, post, NUM_EMB)

    mp.setattr(cps, "create_cps_state", port_create)
    mp.setattr(cps, "cps_init_phase", port_init)
    history = []
    try:
        state = cps.train(Config(_cfg(synthetic_dataset, str(base / "port"))),
                          max_steps_per_epoch=2, device="cpu", history=history)
    finally:
        mp.undo()
    yield dict(base=base, jax_vars=(_np(v1), _np(v2)), jax_batch=captured["batch"],
               port_batches=port_batches, state=state, history=history,
               jax_run=str(base / "jax" / "drv_hybrid_0"),
               port_run=str(base / "port" / "drv_hybrid_0"))
    shutil.rmtree(base, ignore_errors=True)  # two runs of full checkpoints


@pytest.fixture(autouse=True)
def _delete_what_the_test_wrote(request):
    """Each test's ``tmp_path`` (runs of full checkpoints, 335 MB each at
    resnet18) is removed when the test is done."""
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def test_init_phase_sees_the_same_first_batch(runs):
    [(img, target)] = runs["port_batches"]  # once, on the first labelled batch
    j_img, j_target = runs["jax_batch"]
    np.testing.assert_allclose(img.permute(0, 2, 3, 1).numpy(), j_img, atol=1.0 / 255.0)
    np.testing.assert_array_equal(target.numpy(), j_target)


def test_epoch_averages_match_jax(runs):
    [jrec] = _jsonl(runs["jax_run"])
    [rec] = _jsonl(runs["port_run"])
    assert set(jrec) == set(rec)
    for k in LOSSES:
        np.testing.assert_allclose(rec[k], jrec[k], rtol=1e-3, err_msg=k)
    for k in IOUS:
        np.testing.assert_allclose(rec[k], jrec[k], atol=1e-3, err_msg=k)
    np.testing.assert_allclose(rec["learning_rate"], jrec["learning_rate"], rtol=1e-6)
    for k in (k for k in rec if k.startswith("code_usage")):
        np.testing.assert_allclose(rec[k], jrec[k], atol=1e-6, err_msg=k)
    [h] = runs["history"]
    assert h["epoch"] == 0 and h["step_start"] == 0 and h["step"] == 2
    for k in LOSSES + ("miou", "test_miou"):
        assert h[k] == pytest.approx(rec[k], rel=1e-9)


def test_parameters_match_jax(runs):
    st = runs["state"]
    assert st.step == 2
    for model, jv in ((st.model_1, runs["jax_vars"][0]), (st.model_2, runs["jax_vars"][1])):
        want = state_dict_from_flax(jv, NUM_EMB)
        sd = model.state_dict()
        params = dict(model.named_parameters())
        assert params
        for k, t in sd.items():
            if k in params:
                np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0, atol=3e-4,
                                           err_msg=k)
            elif "codebooks" in k:
                np.testing.assert_array_equal(t.numpy(), want[k].numpy(), err_msg=k)
            elif "running" in k:  # statistics of activations of those parameters
                ref = want[k].numpy()
                assert np.abs(t.numpy() - ref).max() <= 3e-3 * np.abs(ref).max(), k


def test_same_run_directory_and_checkpoints(runs):
    jrun, prun = runs["jax_run"], runs["port_run"]
    assert _listing(jrun) == _listing(prun)
    assert "log_txt" in _listing(prun) and "imgs/output_0ep.png" in _listing(prun)
    names = sorted(os.listdir(os.path.join(prun, "ckpoints")))
    assert names == sorted(os.listdir(os.path.join(jrun, "ckpoints"))) == ["0ep.ckpt", "last.ckpt"]
    for name in names:
        ck = ckpoints.load_full(os.path.join(prun, "ckpoints", name))
        jck = jax_load_full(os.path.join(jrun, "ckpoints", name))
        assert set(ck) == set(jck) == CONTRACT
        assert ck["epoch"] == int(jck["epoch"]) == 0 and ck["batch_idx"] == int(jck["batch_idx"]) == 1
        for k, t in ck["model_1"].items():
            assert torch.equal(t, runs["state"].model_1.state_dict()[k]), k
    log = open(os.path.join(prun, "log_txt")).read().splitlines()
    assert len(log) == 1 and log[0].startswith("[Epoch0] miou=")


def test_evaluate_matches_jax(runs, synthetic_dataset):
    jv = runs["jax_vars"][0]
    test_dir = os.path.join(synthetic_dataset, "test")
    p2l = {"0": 0, "128": 1, "255": 2}
    jloader = jds.Loader(jds.BaseDataset(test_dir, "labelled", batch_size=1, resize=64,
                                         target_resize=False), 1)
    want = jcps.evaluate(jax_make_model(_cfg("", "")["model"]), jv, jloader, p2l, 3)
    model = make_model(_cfg("", "")["model"], device="cpu")
    model.load_state_dict(state_dict_from_flax(jv, NUM_EMB))
    loader = Loader(BaseDataset(test_dir, "labelled", batch_size=1, resize=64,
                                target_resize=False), 1, device="cpu")
    got = cps.evaluate(model, loader, p2l, 3, device="cpu")
    assert 0.0 < got < 1.0
    assert abs(got - want) <= 1e-6
    # host numpy batches go through the same way
    numpy_loader = Loader(loader.dataset, 1, device=None)
    assert cps.evaluate(model, numpy_loader, p2l, 3, device="cpu") == pytest.approx(got, abs=1e-12)
    assert not model.training  # left as it was found (make_model returns eval mode)


def test_resume_continues_where_it_stopped(synthetic_dataset, tmp_path):
    save = str(tmp_path / "runs")
    first = cps.train(Config(_cfg(synthetic_dataset, save, init_weights=False)),
                      max_steps_per_epoch=2, device="cpu")
    last = os.path.join(save, "drv_hybrid_0", "ckpoints", "last.ckpt")
    ck = ckpoints.load_full(last)
    assert ck["epoch"] == 0 and first.step == 2

    # nothing left to run: the state comes back exactly as saved
    cfg = Config(_cfg(synthetic_dataset, save, resume="auto"))
    restored = cps.train(cfg, max_steps_per_epoch=2, device="cpu")
    for model, key in ((restored.model_1, "model_1"), (restored.model_2, "model_2")):
        for k, t in model.state_dict().items():
            assert torch.equal(t, ck[key][k]), k
    for opt, key in ((restored.opt_1, "optimizer_1"), (restored.opt_2, "optimizer_2")):
        sd = opt.state_dict()
        assert sd["param_groups"] == ck[key]["param_groups"]
        for i, s in sd["state"].items():
            for name, t in s.items():
                assert torch.equal(t, ck[key]["state"][i][name]), (key, i, name)
    assert restored.step == 2
    schedule = make_lr_schedule(cfg.train, 2)
    assert restored.schedule(restored.step) == schedule(2)

    # one more epoch: only epoch 1 runs, from step 2
    history = []
    cps.train(Config(_cfg(synthetic_dataset, save, resume="auto", num_epochs=2)),
              max_steps_per_epoch=2, device="cpu", history=history)
    assert [h["epoch"] for h in history] == [1]
    assert history[0]["step_start"] == 2 and history[0]["step"] == 4
    assert history[0]["lr_start"] == make_lr_schedule(Config({**cfg.train, "num_epochs": 2}), 2)(2)
    run = os.path.join(save, "drv_hybrid_2")
    assert ckpoints.load_full(os.path.join(run, "ckpoints", "last.ckpt"))["epoch"] == 1
    assert open(os.path.join(run, "log_txt")).read().startswith("[Epoch1] ")


def test_preemption_writes_a_full_last_ckpt_and_stops(synthetic_dataset, tmp_path):
    guard = PreemptionGuard()
    guard.request_stop()
    history = []
    cfg = _cfg(synthetic_dataset, str(tmp_path / "runs"), num_epochs=3, light_snapshots=True,
               init_weights=False, test_every=0)
    cps.train(Config(cfg), max_steps_per_epoch=1, preempt=guard, device="cpu", history=history)
    assert [h["epoch"] for h in history] == [0]
    d = tmp_path / "runs" / "drv_hybrid_0" / "ckpoints"
    assert set(ckpoints.load_full(str(d / "last.ckpt"))) == CONTRACT
    assert set(ckpoints.load_full(str(d / "0ep.ckpt"))) == {"model_1", "model_2", "epoch",
                                                            "batch_idx"}


def test_test_cli_sweep_picks_the_best(runs, synthetic_dataset, tmp_path):
    sweep = tmp_path / "ckpoints"
    sweep.mkdir()
    trained = runs["state"]
    ckpoints.save_ckpoints(trained.model_1, trained.model_2, 0, 1, trained.opt_1, trained.opt_2,
                           str(sweep / "a.ckpt"), async_save=False)
    other = make_model(_cfg("", "")["model"], device="cpu",
                       generator=torch.Generator().manual_seed(5))
    torch.save({"model_1": other.state_dict()}, str(sweep / "b.ckpt"))
    (sweep / "c.ckpt").write_bytes(b"not a checkpoint")
    cfg = _cfg(synthetic_dataset, str(tmp_path / "runs"))
    cfg["test"].update(weights=str(sweep), save_dir=str(tmp_path / "test"))
    cfg["wandb_logging"] = False
    cfg = Config(cfg)
    loader = Loader(BaseDataset(os.path.join(synthetic_dataset, "test"), "labelled", batch_size=1,
                                resize=64, target_resize=False), 1, device="cpu")
    mious = {}
    for name, model in (("a.ckpt", trained.model_1), ("b.ckpt", other)):
        mious[name] = cps.evaluate(model, loader, cfg.pixel_to_label, 3, device="cpu")
    best_path, best = test_cli.test(cfg, device="cpu")
    assert os.path.basename(best_path) == max(mious, key=mious.get)
    assert best["test_miou"] == pytest.approx(max(mious.values()), abs=1e-6)
    results = open(tmp_path / "test" / "ckpoints" / "results.txt").read()
    assert results.count(".ckpt\n") == 2 and "c.ckpt" not in results  # the corrupt one skipped
    assert len(os.listdir(tmp_path / "test" / "ckpoints" / "imgs")) == 2 * 3


def test_train_cli_runs_on_the_cpu(synthetic_dataset, tmp_path):
    cfg = _cfg(synthetic_dataset, str(tmp_path / "runs"), init_weights=False, test_every=0)
    cfg["wandb_logging"] = False
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    out = subprocess.run([sys.executable, "-m", "vq_seg_tpu_torch.train", "--config_path",
                          str(path), "--max_steps_per_epoch", "1", "--device", "cpu"],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[Epoch0] miou=" in out.stdout
    assert os.listdir(tmp_path / "runs" / "drv_hybrid_0" / "ckpoints") != []


@pytest.mark.parametrize("knob,value", [("scan_steps", 2), ("fused_step", True),
                                        ("zero_opt", True), ("grad_accum_steps", 2),
                                        ("mesh", object())])
def test_unported_knobs_raise(synthetic_dataset, tmp_path, knob, value):
    kw = {"mesh": value} if knob == "mesh" else {}
    cfg = _cfg(synthetic_dataset, str(tmp_path / "runs"), **({} if kw else {knob: value}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cps.train(Config(cfg), device="cpu", **kw)


def test_unported_modes_and_options_raise(synthetic_dataset, tmp_path):
    """Every mode trains now (``tests/test_torch_slice_cli.py`` runs the
    last two); the test CLI's ``--crf`` is not ported."""
    cfg = _cfg(synthetic_dataset, str(tmp_path / "runs"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert set(train_cli.PORTED) == set(train_cli.MODES)
    with pytest.raises(NotImplementedError, match="item 13"):
        test_cli.main(["--config_path", str(path), "--crf", "--device", "cpu"])
    if not torch.cuda.is_available():  # every entry point defaults to the card
        for call in (lambda: cps.train(Config(cfg)),
                     lambda: cps.evaluate(None, [], {}, 3),
                     lambda: test_cli.test(Config(cfg)),
                     lambda: train_cli.main(["--config_path", str(path), "--mode", "cps"])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert not os.path.exists(tmp_path / "runs")  # nothing ran
