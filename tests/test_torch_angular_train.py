"""Port parity: the ``angularv3`` step and driver
(``config/vqreptunetangularv3.json``) against the JAX package, on the CPU
at resnet18 / K=8 / 64x64, batch 2 labeled + 2 unlabeled (helpers in
``_slice_parity.py`` and ``_vqpt_parity.py``; the head and the networks
are in ``test_torch_angular.py``).

JAX's random draws cannot be matched, so the port starts from the JAX
driver's post-init state, mapped by ``state_dict_from_flax``.  ``scale``
30 with an ArcFace margin makes the step's f32 gradients ill-conditioned.

Bounds:
  * one ``angularv3`` step (the JAX driver's own compiled step from its
    post-init state, at threshold 0.5), on zero-mean images: loss terms
    within 1e-5 relative (IoUs 1e-5 absolute), running statistics within
    1e-5, codebooks unchanged; gradients in f64 within 1e-6 of JAX's f64,
    in f32 within 1e-4 plus twice JAX's own f32 error; every forward sees
    TF32 off;
  * one driver epoch of ``train_angularv3_cps`` against JAX's: epoch
    averages within 1e-3 relative (mIoU 1e-3 absolute), the same run
    directory, log keys, checkpoints and contract keys; the threshold
    handed to the step is the ramp's.
"""
import shutil

import jax
import jax.numpy as jnp
import pytest
import torch

from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import variants as jvariants
from _port_helpers import nchw, to_np
from _slice_parity import drv_cfg, run_jax, run_port
from _vqpt_parity import (_adam_gradient, _batch, _check_epoch, _check_step, _jax_f64_step,
                          _port_step)
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.training import angularv3_threshold
from vq_seg_tpu_torch.training.variants import make_angularv3_cps_train_step

torch.set_num_threads(1)

METRICS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss", "prototype_loss",
           "code_usage", "miou", "iou_list")
STEP_KW = dict(num_classes=3, cps_loss_weight=1.0, commitment_loss_weight=1.0,
               prototype_loss_weight=0.01)


@pytest.fixture(scope="module")
def angular_runs(synthetic_dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("angularv3")
    captured = {}
    run_jax("train_angularv3_cps", "make_angularv3_cps_train_step",
            drv_cfg(synthetic_dataset, str(base / "jax"), "vqreptunetangularv3"), captured)
    state, history, seen = run_port(
        "train_angularv3_cps",
        drv_cfg(synthetic_dataset, str(base / "port"), "vqreptunetangularv3"), captured)
    yield dict(state=state, history=history, captured=captured, seen=seen,
               jax_run=str(base / "jax" / "VQRePTUnetAngularv3_angularv3_0"),
               port_run=str(base / "port" / "VQRePTUnetAngularv3_angularv3_0"))
    shutil.rmtree(base, ignore_errors=True)


def test_one_angularv3_step_matches_jax(angular_runs):
    post = angular_runs["captured"]["post"]
    batch = _batch(8)
    th = 0.5
    jnew, jm = angular_runs["captured"]["step"](jax.tree_util.tree_map(jnp.asarray, post),
                                                *map(jnp.asarray, batch), jnp.float32(th))
    jnew, jm = to_np(jnew), to_np(jm)
    cfg = drv_cfg("", "", "vqreptunetangularv3")
    step = make_angularv3_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)
    l_img, l_t, ul = batch
    args = (nchw(l_img), torch.from_numpy(l_t).long(), nchw(ul), th)
    st, m = _port_step(cfg["model"], post, step, args)
    st64, _ = _port_step(cfg["model"], post, step, args, torch.float64)
    jmodel = jax_make_model(cfg["model"])
    jnew64 = _jax_f64_step(lambda tx: jvariants.make_angularv3_cps_train_step(
        jmodel, tx, jax_make_loss("dice_loss", 3, ignore_index=255), **STEP_KW),
        post, (*batch, th))
    _check_step(st, m, post, jnew, jm, (_adam_gradient(jnew.opt_state_1),
                                        _adam_gradient(jnew.opt_state_2)), METRICS,
                f64=(st64, (jnew64.opt_state_1, jnew64.opt_state_2)))


def test_angularv3_driver_epoch_matches_jax(angular_runs):
    rec = _check_epoch(angular_runs["jax_run"], angular_runs["port_run"], "angularv3")
    assert {"sup_loss_1", "prototype_loss", "commitment_loss"} <= set(rec)
    assert angular_runs["seen"]["tf32_in_driver"] == (False, False)  # full f32
    assert angular_runs["seen"]["init_kw"] == {"extra": ("labeled", 0.0)}
    [h] = angular_runs["history"]
    assert h["th"] == angularv3_threshold(0, 1) == 1.0
    assert h["step"] == 2 and 0.0 <= h["test_miou"] <= 1.0
    assert [float(e[0]) for e in angular_runs["captured"]["extra"]] == [1.0, 1.0]
