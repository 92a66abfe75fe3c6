"""Port parity: the test CLI against ``scripts/test.py`` on the same
checkpoints, through ``tools/jax_ckpt_to_port.py``, on the CPU.

A tiny flagship run in the JAX package (resnet18, K=8, 64x64, batch 2,
one epoch of two steps, light snapshots) writes ``0ep.ckpt`` (light) and
``last.ckpt`` (full); a third, ``init.ckpt``, holds the run's models as
drawn, before the init phase.  The tool converts the directory.  Then:

  * both CLIs sweep their directory, with and without ``use_crf``: each
    checkpoint's ``results.txt`` accuracy, mIoU, precision, recall, F1 and
    ``iou_by_class`` agree within 1e-3 (the evaluation bound of
    ``tests/test_torch_driver.py``), and both pick the same best
    checkpoint;
  * a light and a full checkpoint convert: the models equal the JAX
    package's mapped variables exactly, the light one holds no optimizer,
    and the full one's Adam moments and step counts equal JAX's ``mu``,
    ``nu`` and ``count`` exactly;
  * the port's driver resumes from the converted ``last.ckpt`` at JAX's
    update count and its LR.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import importlib.util
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import cps as jcps
from vq_seg_tpu.training.schedules import cosine_annealing as jax_cosine
from vq_seg_tpu.utils.ckpoints import load_full as jax_load_full
from vq_seg_tpu.utils.ckpoints import save_ckpoints as jax_save_ckpoints
from vq_seg_tpu_torch import test as port_test_cli
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.training import cps
from vq_seg_tpu_torch.training.schedules import make_lr_schedule
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import jax_ckpt_to_port  # noqa: E402
from _slice_parity import JitModel  # noqa: E402

torch.set_num_threads(1)

NUM_EMB = [0, 0, 8, 8, 8]
METRICS = ("test_acc", "test_miou", "test_precision", "test_recall", "test_f1score")


def _load_jax_test_cli():
    spec = importlib.util.spec_from_file_location("jax_test_cli",
                                                  os.path.join(ROOT, "scripts", "test.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfg(data_dir, save_dir, **train):
    """``tests/test_torch_driver.py``'s run, without evaluation."""
    cfg = {
        "project_name": "cli", "wandb_logging": False, "num_classes": 3,
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
                  "save_txt": True, "save_as_tar": False, "test_every": 0,
                  "light_snapshots": True},
        "test": {"data_dir": data_dir, "save_dir": os.path.join(save_dir, "..", "test"),
                 "batch_size": 1, "weights": None, "save_img": False},
    }
    cfg["train"].update(train)
    return cfg


@pytest.fixture(scope="module")
def run(synthetic_dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("testcli")
    captured = {}
    real_create = jcps.create_cps_state

    def jax_create(*a, **k):
        st = real_create(*a, **k)
        captured["pre"] = jax.tree_util.tree_map(np.asarray, st)
        return st

    jfastimg.load()  # see tests/test_torch_driver.py
    mp = pytest.MonkeyPatch()
    mp.setattr(jcps, "create_cps_state", jax_create)
    mp.setattr(jcps, "make_model", lambda model_cfg: JitModel(jax_make_model(model_cfg)))
    try:
        jcps.train(JaxConfig(_cfg(synthetic_dataset, str(base / "runs"))), max_steps_per_epoch=2)
    finally:
        mp.undo()
    jdir = str(base / "runs" / "cli_hybrid_0" / "ckpoints")
    pre = captured["pre"]
    jax_save_ckpoints(pre.variables_1, pre.variables_2, 0, 0, None, None,
                      os.path.join(jdir, "init.ckpt"), async_save=False,
                      include_optimizers=False)
    pdir = str(base / "port_ckpoints")
    jax_ckpt_to_port.main(["--config_path", _write_cfg(base, synthetic_dataset), "--src", jdir,
                           "--dst", pdir])
    yield dict(base=base, jdir=jdir, pdir=pdir, data=synthetic_dataset)
    shutil.rmtree(base, ignore_errors=True)


def _write_cfg(base, data):
    path = str(base / "cfg.json")
    with open(path, "w") as f:
        json.dump(_cfg(data, str(base / "runs")), f)
    return path


def _results(path):
    """``results.txt`` -> {checkpoint basename: {metric: value}}."""
    out, current = {}, None
    for line in open(path).read().splitlines():
        if not line.startswith("  "):
            current = out.setdefault(os.path.basename(line), {})
        else:
            key, value = line.strip().split(": ", 1)
            current[key] = [float(v) for v in value.strip("[]").split(",")] if "[" in value \
                else float(value)
    return out


@pytest.mark.parametrize("use_crf", [False, True], ids=["plain", "crf"])
def test_test_cli_matches_scripts_test(run, use_crf):
    jcli = _load_jax_test_cli()
    jcfg = JaxConfig(_cfg(run["data"], str(run["base"] / "runs")))
    jcfg["test"].update(weights=run["jdir"], save_dir=str(run["base"] / f"jax_out_{use_crf}"))
    jbest = jcli.test(jcfg, use_crf=use_crf)
    cfg = Config(_cfg(run["data"], str(run["base"] / "runs")))
    cfg["test"].update(weights=run["pdir"], save_dir=str(run["base"] / f"port_out_{use_crf}"))
    best = port_test_cli.test(cfg, use_crf=use_crf, device="cpu")
    assert os.path.basename(best[0]) == os.path.basename(jbest[0])
    want = _results(os.path.join(jcfg.test.save_dir, "ckpoints", "results.txt"))
    got = _results(os.path.join(cfg.test.save_dir, "port_ckpoints", "results.txt"))
    assert set(got) == set(want) == {"0ep.ckpt", "init.ckpt", "last.ckpt"}
    for name in want:
        for k in METRICS:
            assert abs(got[name][k] - want[name][k]) <= 1e-3, (name, k, got[name][k],
                                                              want[name][k])
            assert 0.0 <= got[name][k] <= 1.0
        np.testing.assert_allclose(got[name]["iou_by_class"], want[name]["iou_by_class"],
                                   atol=1e-3, err_msg=name)
    # the drawn models score otherwise than the trained ones
    assert got["init.ckpt"]["test_miou"] != got["last.ckpt"]["test_miou"]


def test_light_and_full_checkpoints_convert(run):
    light = ckpoints.load_full(os.path.join(run["pdir"], "0ep.ckpt"))
    full = ckpoints.load_full(os.path.join(run["pdir"], "last.ckpt"))
    assert set(light) == {"model_1", "model_2", "epoch", "batch_idx"}
    assert set(full) == {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
    jfull = jax_load_full(os.path.join(run["jdir"], "last.ckpt"))
    assert full["epoch"] == int(jfull["epoch"]) == 0 and full["batch_idx"] == 1
    names = [n for n, _ in cps.create_cps_state(_cfg("", "")["model"], lambda s: 0.0,
                                                device="cpu").model_1.named_parameters()]
    for i in (1, 2):
        want = state_dict_from_flax(jfull[f"model_{i}"], NUM_EMB)
        assert set(full[f"model_{i}"]) == set(want)
        for k, t in full[f"model_{i}"].items():
            assert torch.equal(t, want[k]), k
        adam = jfull[f"optimizer_{i}"][0]
        opt = full[f"optimizer_{i}"]
        assert "mini_step" not in opt and len(opt["state"]) == len(names)
        for key, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
            moments = state_dict_from_flax({**jfull[f"model_{i}"], "params": tree}, NUM_EMB)
            for idx, name in enumerate(names):
                assert torch.equal(opt["state"][idx][key], moments[name]), (key, name)
        assert {float(s["step"]) for s in opt["state"].values()} == {float(adam["count"])} == {2.0}


def test_port_resumes_at_jax_step_and_lr(run, tmp_path):
    last = os.path.join(run["pdir"], "last.ckpt")
    cfg = Config(_cfg(run["data"], str(tmp_path / "runs"), num_epochs=2, resume=last))
    history = []
    state = cps.train(cfg, max_steps_per_epoch=1, device="cpu", history=history)
    schedule = make_lr_schedule(cfg.train, 2)  # the schedule spans both epochs' 2 batches
    [h] = history
    assert h["epoch"] == 1 and h["step_start"] == 2 and h["step"] == 3 == state.step
    assert h["lr_start"] == schedule(2)
    np.testing.assert_allclose(h["lr_start"], float(jax_cosine(1e-4, 1e-7, 4)(2)), rtol=1e-6)
