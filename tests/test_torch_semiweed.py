"""Port parity: the ``semiweed`` slice (``config/semiweednet.json``) against
the JAX package, on the CPU at resnet18 / 64x64, batch 2 labeled + 2
unlabeled, overlap 24 (crops of 32x32) (helpers in ``_slice_parity.py``
and ``_port_helpers.py``).

The port starts from the JAX driver's initial variables, mapped by
``state_dict_from_flax``; the ASPP dropout takes the masks flax drew,
recorded from the JAX driver's own compiled step (``record_dropout``).

Bounds:
  * ``overlapped_patches`` and both flips equal JAX's crops and
    ``jnp.flip`` on axis -2 (case 1, the width) and -3 (case 2, the
    height) exactly;
  * one step from the JAX driver's state (its own compiled step, cases 1
    and 2, JAX's three masks): every batch-statistics pass sees 2 to 32
    values per channel, so f32 is ill-conditioned: in f64 in both packages
    (JAX's f64 step replaying the same masks) the gradients within 1e-6
    relative, the metrics and running statistics within 1e-7 (the JAX
    package's x4 align-corners upsample keeps f32 lerp weights); the
    port's f32 within 1e-5 (1e-4 for gradients) plus twice JAX's own f32
    error of JAX's f64; IoUs within 1e-5;
  * one driver epoch of ``train_semiweed`` against JAX's on the same PNG
    tree with JAX's cases and masks: epoch averages within 1e-3 relative
    (mIoU 1e-3 absolute), the same run directory, log keys, ``last.ckpt``
    holding ``{model_1, epoch, optimizer_1}``, which the test CLI's sweep
    reads.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.losses.dc import DCLoss as JaxDCLoss
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import variants as jvariants
from vq_seg_tpu.utils import ckpoints as jck
from _port_helpers import MASKS, nchw, nhwc, rel, record_dropout, take_masks, to_np
from _port_helpers import port_f64, wide
from _slice_parity import drv_cfg, jax_f64_one_model_step, run_jax, run_port
from _vqpt_parity import _batch, _listing
from vq_seg_tpu_torch import test as test_cli
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.training.supervised import TrainState, _adam
from vq_seg_tpu_torch.training.variants import (dihedral, make_semiweed_train_step,
                                                overlapped_patches)
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

OVERLAP = 24
METRICS = ("loss", "ce_loss", "dc_loss")
KW = dict(num_classes=3, overlap_size=OVERLAP, ce_loss_weight=1.0, dc_loss_weight=0.7)


def test_overlapped_patches_and_flips_match_jax():
    rng = np.random.default_rng(1)
    for hw in ((64, 64), (70, 66)):
        x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
        jp = jvariants.overlapped_patches(jnp.asarray(x), OVERLAP)
        tp = overlapped_patches(nchw(x), OVERLAP)
        for a, b in zip(tp, jp):
            assert nhwc(a).shape == (2, 32, 32, 3)
            np.testing.assert_array_equal(nhwc(a), np.asarray(b))
        for case, axis in ((1, -2), (2, -3)):
            np.testing.assert_array_equal(nhwc(dihedral(nchw(x), case)),
                                          np.asarray(jnp.flip(jnp.asarray(x), axis)))
        np.testing.assert_array_equal(nhwc(dihedral(nchw(x), 0)), x)


@pytest.fixture(scope="module")
def semiweed_runs(synthetic_dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("semiweed")
    captured = {}
    cfg_j = drv_cfg(synthetic_dataset, str(base / "jax"), "semiweednet", overlap_size=OVERLAP)
    MASKS.clear()
    with record_dropout():
        run_jax("train_semiweed", "make_semiweed_train_step", cfg_j, captured)
        jax.effects_barrier()
    steps_masks = [take_masks(3) for _ in range(2)]
    assert not MASKS  # evaluation draws none
    extras = captured["extra"]  # (case1, case2, key) per step

    def draws(cfg, device):
        queue = [(int(c1), int(c2), tuple((lambda shape, k=k: k) for k in m))
                 for (c1, c2, _), m in zip(extras, steps_masks)]
        return lambda: queue.pop(0)

    def state(cfg, schedule, device):
        model = make_model(cfg.model, device="cpu")
        model.load_state_dict(state_dict_from_flax(captured["post"].variables, None))
        return TrainState(model.train(), _adam(model.parameters()), schedule)

    port_state, history, _ = run_port(
        "train_semiweed",
        drv_cfg(synthetic_dataset, str(base / "port"), "semiweednet", overlap_size=OVERLAP),
        captured, patches={"semiweed_draws": draws, "semiweed_state": state})
    yield dict(state=port_state, history=history, captured=captured, base=base,
               data=synthetic_dataset,
               jax_run=str(base / "jax" / "semiweednet_semiweed_0"),
               port_run=str(base / "port" / "semiweednet_semiweed_0"))
    shutil.rmtree(base, ignore_errors=True)


def test_one_semiweed_step_matches_jax(semiweed_runs):
    post = semiweed_runs["captured"]["post"]
    l_img, l_t, ul = _batch(8)
    key = jax.random.PRNGKey(3)
    with record_dropout():
        jnew, jm = semiweed_runs["captured"]["step"](
            jax.tree_util.tree_map(jnp.asarray, post), jnp.asarray(l_img), jnp.asarray(l_t),
            jnp.asarray(ul), jnp.int32(1), jnp.int32(2), key)
        jax.effects_barrier()
    masks = take_masks(3)
    assert [tuple(m.shape) for m in masks] == [(2, 256, 4, 4), (2, 256, 2, 2), (2, 256, 2, 2)]
    jnew, jm = to_np(jnew), to_np(jm)
    cfg = drv_cfg("", "", "semiweednet", overlap_size=OVERLAP)
    jmodel = jax_make_model(cfg["model"])
    jcrit = jax_make_loss("dice_loss", 3, ignore_index=255)
    batch = (l_img, l_t, ul, np.int32(1), np.int32(2), np.asarray(key))
    jnew64, jm64 = jax_f64_one_model_step(lambda tx: jvariants.make_semiweed_train_step(
        jmodel, tx, jcrit, JaxDCLoss(), **KW), post, batch, replay=[nhwc(m) for m in masks])
    jgrads64, jstats64 = jnew64.opt_state, jnew64.variables["batch_stats"]

    def port(dtype):
        model = make_model(cfg["model"], device="cpu")
        model.load_state_dict(state_dict_from_flax(post.variables, None))
        model.to(dtype)
        st = TrainState(model.train(), _adam(model.parameters()), lambda s: 0.0)
        step = make_semiweed_train_step(make_loss("dice_loss", 3, ignore_index=255), **KW)
        cast = lambda t: t.to(dtype)
        with port_f64():
            _, m = step(st, cast(nchw(l_img)), torch.from_numpy(l_t).long(), cast(nchw(ul)),
                        1, 2, tuple((lambda shape, m=m: m) for m in masks))
        return st, m

    st, m = port(torch.float32)
    st64, m64 = port(torch.float64)
    for k in METRICS:
        want64 = float(jm64[k])
        assert abs(float(m64[k]) / want64 - 1) <= 1e-7, k
        own = abs(float(jm[k]) / want64 - 1)
        assert abs(float(m[k]) / want64 - 1) <= 1e-5 + 2 * own, k
    np.testing.assert_allclose(m["iou_list"].numpy(), jm["iou_list"], atol=1e-5)
    # gradients: f64 within 1e-6, f32 within 1e-4 + twice JAX's own error
    jgrads32 = jax.tree_util.tree_map(lambda mu: mu / np.float32(0.1), jnew.opt_state[0].mu)
    want32 = state_dict_from_flax({**post.variables, "params": jgrads32}, None)
    from unittest import mock
    with mock.patch("vq_seg_tpu_torch.utils.convert._t",
                    lambda a: torch.tensor(np.asarray(a, np.float64))):
        want64 = state_dict_from_flax({**wide(post.variables), "params": jgrads64}, None)
        stats64 = state_dict_from_flax({**wide(post.variables), "batch_stats": jstats64}, None)
    stats32 = state_dict_from_flax({**post.variables, "batch_stats": jnew.variables[
        "batch_stats"]}, None)
    g64 = dict(st64.model.named_parameters())
    for name, p in st.model.named_parameters():
        w64 = want64[name].numpy()
        assert rel(g64[name].grad.numpy(), w64) <= 1e-6, name
        assert rel(p.grad.numpy(), w64) <= 1e-4 + 2 * rel(want32[name].numpy(), w64), name
    sd64 = st64.model.state_dict()
    for key_, t in st.model.state_dict().items():
        if "running" in key_:
            w64 = stats64[key_].numpy()
            # past the decoder's x4 upsample, whose JAX lerp weights are f32
            assert rel(sd64[key_].numpy(), w64) <= 1e-7, key_
            assert rel(t.numpy(), w64) <= 1e-5 + 2 * rel(stats32[key_].numpy(), w64), key_
    assert st.step == 1


def test_semiweed_driver_epoch_and_sweep(semiweed_runs):
    jrun, prun = semiweed_runs["jax_run"], semiweed_runs["port_run"]
    log = os.path.basename(prun) + ".jsonl"
    assert _listing(jrun) == _listing(prun) == sorted(
        ["ckpoints", "ckpoints/last.ckpt", "log_txt", log])
    [jrec] = [json.loads(line) for line in open(os.path.join(jrun, log))]
    [rec] = [json.loads(line) for line in open(os.path.join(prun, log))]
    assert set(rec) == set(jrec) >= {"ce_loss", "dc_loss", "loss", "miou"}
    for k in rec:
        tol = dict(atol=1e-3) if k == "miou" else dict(rtol=1e-3)
        np.testing.assert_allclose(rec[k], jrec[k], err_msg=k, **tol)
    [line] = open(os.path.join(prun, "log_txt")).read().splitlines()
    assert line.startswith("[semiweed][Epoch0] ")
    last = os.path.join(prun, "ckpoints", "last.ckpt")
    ck = ckpoints.load_full(last)
    jckpt = jck.load_full(os.path.join(jrun, "ckpoints", "last.ckpt"))
    assert set(ck) == set(jckpt) == {"model_1", "epoch", "optimizer_1"}
    assert ck["epoch"] == 0
    [h] = semiweed_runs["history"]
    assert h["step"] == 2 and 0.0 <= h["test_miou"] <= 1.0 and h["ckpt_files"] == ["last.ckpt"]
    cfg = drv_cfg(semiweed_runs["data"], str(semiweed_runs["base"] / "port"), "semiweednet")
    cfg["test"].update(weights=os.path.dirname(last), save_dir=str(semiweed_runs["base"] / "t"))
    best_path, best = test_cli.test(Config(cfg), save_img=False, device="cpu")
    assert best_path == last and 0.0 <= best["test_miou"] <= 1.0
