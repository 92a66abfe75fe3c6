"""Port parity: the ``supconcps`` step and driver
(``config/sup_con_loss.json``) against the JAX package, on the CPU at
resnet18 / K=8 / 64x64, batch 2 labeled + 2 unlabeled (helpers in
``_slice_parity.py`` and ``_vqpt_parity.py``; the loss and the network
are in ``test_torch_supcon.py``).

JAX's random draws cannot be matched, so the port starts from the JAX
driver's post-init state, mapped by ``state_dict_from_flax``.

Bounds:
  * one ``supconcps`` step, the JAX package's own (its own
    ``supcon_loss``) compiled as its driver compiles it, from the driver's
    post-init state on zero-mean images: loss terms within 1e-5 relative
    (IoUs 1e-5 absolute), running statistics within 1e-5, codebooks
    unchanged; gradients in f64 in both packages within 1e-6, the port's
    f32 within 1e-4 plus twice JAX's own f32 error of JAX's f64; every
    forward sees TF32 off;
  * one driver epoch of ``train_supcon_cps`` against JAX's on the same PNG
    tree, the port from JAX's post-init state: epoch averages within 1e-3
    relative (mIoU 1e-3 absolute), the same run directory, log keys,
    checkpoint files and contract keys.  On this tree the JAX package's
    f32 contrastive loss underflows within two steps (+inf, then NaN),
    so JAX's driver runs with the same loss in the port's log form
    (``_log_form_supcon``), itself held to the JAX package's loss and
    gradient within 1e-5 where that is finite.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.losses.contrastive import supcon_loss as jax_supcon_loss
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import variants as jvariants
from _port_helpers import nchw, rel, to_np
from _slice_parity import drv_cfg, jax_decoder_bn, run_jax, run_port
from _vqpt_parity import (_adam_gradient, _batch, _check_epoch, _check_step, _jax_f64_step,
                          _port_step)
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.training.cps import model_cfg_with_bn
from vq_seg_tpu_torch.training.variants import make_supcon_cps_train_step

torch.set_num_threads(1)

SUPCON_METRICS = ("loss", "cps_loss", "sup_loss", "sup_con_loss", "commitment_loss",
                  "code_usage", "miou", "iou_list")


def _log_form_supcon(x, label, temperature=0.04):
    """The JAX package's ``supcon_loss`` in the port's log form: the same
    function, ``log(1 + neg / pos) / hw^2`` from two log-sum-exps."""
    n, h, w, c = x.shape
    if label.shape[1:] != (h, w):
        label = jax.image.resize(label.astype(jnp.float32), (label.shape[0], h, w),
                                 method="nearest")
    f1, f2 = x[0].reshape(-1, c), x[1].reshape(-1, c)
    g1, g2 = label[0].reshape(-1), label[1].reshape(-1)
    logits = (f1 @ f2.T) / temperature
    pos = g1[:, None] == g2[None, :]
    lse_pos = jax.nn.logsumexp(jnp.where(pos, logits, -jnp.inf))
    lse_neg = jax.nn.logsumexp(jnp.where(pos, -jnp.inf, logits))
    return jax.nn.softplus(lse_neg - lse_pos) / (h * w * h * w)


def test_log_form_reference_matches_jax_where_jax_is_finite():
    rng = np.random.default_rng(12)
    x = jnp.asarray((rng.standard_normal((2, 8, 8, 4)) * 0.2).astype(np.float32))
    label = jnp.asarray(rng.integers(0, 3, size=(2, 8, 8)).astype(np.int32))
    (jl, jg), (ll, lg) = (jax.value_and_grad(f)(x, label)
                          for f in (jax_supcon_loss, _log_form_supcon))
    np.testing.assert_allclose(float(ll), float(jl), rtol=1e-5)
    assert rel(lg, jg) <= 1e-5


@pytest.fixture(scope="module")
def supcon_runs(synthetic_dataset, tmp_path_factory):
    """Both drivers for one epoch; JAX's with its contrastive loss in the
    log form (``_log_form_supcon``): on this tree the JAX package's own f32
    ``exp`` underflows within two steps (loss +inf, then NaN everywhere),
    which the port's log form does not (``losses/contrastive.py``)."""
    from vq_seg_tpu.models.networks import unet as junet

    base = tmp_path_factory.mktemp("supcon")
    captured = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(junet, "supcon_loss", _log_form_supcon)
    try:
        run_jax("train_supcon_cps", "make_supcon_cps_train_step",
                drv_cfg(synthetic_dataset, str(base / "jax"), "sup_con_loss"), captured)
    finally:
        mp.undo()
    state, history, seen = run_port(
        "train_supcon_cps", drv_cfg(synthetic_dataset, str(base / "port"), "sup_con_loss"),
        captured)
    yield dict(state=state, history=history, captured=captured, seen=seen,
               jax_run=str(base / "jax" / "sup_con_loss_supconcps_0"),
               port_run=str(base / "port" / "sup_con_loss_supconcps_0"))
    shutil.rmtree(base, ignore_errors=True)


def test_one_supcon_step_matches_jax(supcon_runs):
    """The JAX package's own step (its own ``supcon_loss``), compiled as its
    driver compiles it, from the driver's post-init state with a fresh
    Adam (the state's own is fresh too)."""
    post = supcon_runs["captured"]["post"]
    tx = optax.adam(1e-4)
    post = post.replace(opt_state_1=to_np(tx.init(post.variables_1["params"])),
                        opt_state_2=to_np(tx.init(post.variables_2["params"])))
    # seed 9: seed 8 puts one of model 2's pre-ReLU activations (layer3.1,
    # unlabeled pass) 8e-7 from zero, where the port's f32 and f64 runs
    # round to opposite sides: its f32 encoder gradients below that ReLU
    # then move by 3e-3 (a kink, not the semantics, which f64 holds)
    batch = _batch(9)
    cfg = drv_cfg("", "", "sup_con_loss")
    kw = dict(num_classes=3, cps_loss_weight=1.0, commitment_loss_weight=1.0,
              sup_con_loss_weight=cfg["train"]["total_sup_con_loss_weight"])
    with jax_decoder_bn(cfg):
        jmodel = jax_make_model(cfg["model"])
        jstep = jvariants.make_supcon_cps_train_step(
            jmodel, tx, jax_make_loss("dice_loss", 3, ignore_index=255), **kw)
        jnew, jm = jstep(jax.tree_util.tree_map(jnp.asarray, post), *map(jnp.asarray, batch))
    jnew, jm = to_np(jnew), to_np(jm)
    step = make_supcon_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), **kw)
    l_img, l_t, ul = batch
    args = (nchw(l_img), torch.from_numpy(l_t).long(), nchw(ul))
    model_cfg = model_cfg_with_bn(Config(cfg))  # the config's decoder BN eps 1e-4
    st, m = _port_step(model_cfg, post, step, args)
    st64, _ = _port_step(model_cfg, post, step, args, torch.float64)
    with jax_decoder_bn(cfg):
        jnew64 = _jax_f64_step(lambda tx: jvariants.make_supcon_cps_train_step(
            jmodel, tx, jax_make_loss("dice_loss", 3, ignore_index=255), **kw), post, batch)
    assert float(jm["sup_con_loss"]) > 0.0
    _check_step(st, m, post, jnew, jm, (_adam_gradient(jnew.opt_state_1),
                                        _adam_gradient(jnew.opt_state_2)), SUPCON_METRICS,
                f64=(st64, (jnew64.opt_state_1, jnew64.opt_state_2)))


def test_supcon_driver_epoch_matches_jax(supcon_runs):
    rec = _check_epoch(supcon_runs["jax_run"], supcon_runs["port_run"], "supconcps")
    assert {"sup_loss", "sup_con_loss", "commitment_loss"} <= set(rec)
    assert supcon_runs["seen"]["tf32_in_driver"] == (False, False)  # full f32
    assert supcon_runs["seen"]["init_kw"] == {"extra": ("label",), "init_protos": False}
    [h] = supcon_runs["history"]
    assert h["step"] == 2 and 0.0 <= h["test_miou"] <= 1.0
    assert h["ckpt_files"] == ["0ep.ckpt", "last.ckpt"]
