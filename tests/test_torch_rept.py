"""Port parity: the ``reptcps`` slice against the JAX package, f32 on the
CPU, at resnet18 / K=8 / 64x64, batch 2 labeled + 2 unlabeled.

JAX's random draws (weights, k-means) cannot be matched, so the port
starts from JAX's variables, mapped by ``state_dict_from_flax``.

Bounds:
  * ``entropy_mask`` and ``regularized_pseudo`` (the JAX step's own
    closure): masks and labels exactly equal.
  * each prototype loss of the family, at three percents and both margins
    where the loss uses one: the loss within 1e-5 relative, its gradients
    w.r.t. the features and the table within 1e-5 relative L2 (the
    detached table of ``ReliablePrototypeLoss`` gets none, where JAX's is
    zero).
  * each network's eval forward (out within 1e-4, usage equal) and train
    forward with gt at percent 80 (out within 1e-4, commit and proto
    within 1e-5 relative, usage equal, BN running stats within 1e-5).
    ``vqreeuptunet``'s train forward raises in the JAX package (it passes
    ``pt_init`` twice), so it is held piece by piece: its eval forward, its
    loss applied directly in JAX, and its train forward against JAX's train
    forward without gt plus JAX's loss on the decoder output that flax's
    ``capture_intermediates`` returns.
  * one ``reptcps`` step against ``make_rept_cps_train_step``: JAX's step
    runs with an optax transformation that keeps the gradient as its state
    and updates nothing.  Metrics within 1e-4 relative, predictions'
    pseudo-labels by construction of the same inputs, BN running stats
    within 1e-5, codebooks unchanged; gradients of every tensor of both
    models: the port's f64 step within 1e-6 relative L2 of JAX's f64 step,
    the port's f32 step within 1e-4 of it and within 1e-4 of JAX's f32 step
    plus that tensor's own distance between JAX's f32 and f64 steps (the
    bounds of ``tests/test_torch_training.py``).  Each forward of the step,
    and the driver's init phase, sees cuDNN's and cuBLAS's TF32 off, and
    the caller's settings are back after them.
  * one driver epoch of ``train_rept_cps`` against JAX's on the same PNG
    tree, the port starting from JAX's post-init state: epoch averages
    within 1e-3 relative (IoUs 1e-3 absolute), the same run directory,
    checkpoint files and contract keys.
  * each shipped ``reptcps`` config through the train CLI with ``--device
    cpu`` at 64x64, one step (resnet18 and K=8 in place of the configs'
    resnet50 and K=512, whose widths the card runs in ``chip_smoke.py``);
    the ``last.ckpt`` of each network served by
    ``Predictor.from_checkpoint`` and swept by the test CLI.

JAX's weights come from a numpy seed (``_seeded_flax``) in the forward
tests, and from flax's init compiled once (``_jit_dual_state``) for the
step and the driver: op by op, flax's init compiles each random draw on
its own.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import copy
import json
import os
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.models.modules import prototype as jproto
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.models.networks import vq_unet as jnets
from vq_seg_tpu.training import variant_drivers as jvd
from vq_seg_tpu.training import variants as jvariants
from vq_seg_tpu.utils.ckpoints import load_full as jax_load_full
from _seeded_flax import seeded_variables
from vq_seg_tpu_torch import test as test_cli
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.models.modules import prototype as tproto
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.serving import Predictor
from vq_seg_tpu_torch.training import create_cps_state, variant_drivers
from vq_seg_tpu_torch.training.variants import make_rept_cps_train_step, regularized_pseudo
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import cps_state_from_flax, state_dict_from_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, B, PERCENT = 64, 2, 80.0
STEP_SEED = 8
NUM_EMB = [0, 0, 8, 8, 8]
NETS = {"vqreptunet1x1": {"margin": 0.0, "scale": 1.0},
        "vqreptunetdouble1x1": {"margin": 0.5, "scale": 30.0},
        "vqreptunet": {"margin": 0.5, "scale": 30.0},
        "vqretemptunet": {"t": 0.1},
        "vqonlyptunet1x1": {"margin": 0.5, "scale": 30.0}}
STEP_KW = dict(num_classes=3, cps_loss_weight=1.0, commitment_loss_weight=1.0,
               prototype_loss_weight=0.01)
METRICS = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss",
           "prototype_loss", "miou", "iou_list", "code_usage")
CONTRACT = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
REPTCPS_CONFIGS = ("vqreptunet1x1", "vqreptunet1x1_IJRR2017", "vqreptunet1x1_rice_s_n_w",
                   "vqreptunet", "vqreeuptunet", "vqretemptunet", "vqreptunetdouble1x1")
# configs that differ from vqreptunet1x1 only in paths, project name and
# learning rate: the CLI trains them, serving and the sweep run once
DATA_VARIANTS = ("vqreptunet1x1_IJRR2017", "vqreptunet1x1_rice_s_n_w")


def _model_cfg(name, **params):
    return {"name": name, "params": {
        "encoder_name": "resnet18", "num_classes": 3,
        "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True},
        **params}}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batch(rng):
    img = rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)
    # every class present: stripes of 0/1/2 with noise
    lab = ((np.arange(HW)[None, :, None] // 8 + rng.integers(0, 2, size=(B, HW, HW))) % 3)
    return img, lab.astype(np.int32), rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)


def _closure_fn(fn, name, depth=0):
    """The function ``name`` defined inside ``fn`` (through its closures)."""
    for cell in fn.__closure__ or ():
        v = cell.cell_contents
        if callable(v) and getattr(v, "__name__", "") == name:
            return v
        if callable(v) and getattr(v, "__closure__", None) and depth < 3:
            found = _closure_fn(v, name, depth + 1)
            if found is not None:
                return found
    return None


# -- the entropy filters ---------------------------------------------------------------


@pytest.mark.parametrize("percent", [100.0, 80.0, 37.5, 0.0])
def test_entropy_mask_matches_jax(percent):
    entropy = np.random.default_rng(1).uniform(0.0, 1.1, size=(2, 32, 32)).astype(np.float32)
    want = np.asarray(jproto.entropy_mask(jnp.asarray(entropy), percent))
    got = tproto.entropy_mask(torch.from_numpy(entropy), percent)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tproto.percentile(torch.from_numpy(entropy), percent).item(),
                               float(jnp.percentile(jnp.asarray(entropy), percent)), rtol=1e-6)


@pytest.mark.parametrize("percent", [100.0, 80.0, 84.0])
def test_regularized_pseudo_matches_jax(percent):
    step = jvariants.make_rept_cps_train_step(None, None, None, num_classes=3)
    jax_fn = _closure_fn(step.__wrapped__, "regularized_pseudo")
    pred = (np.random.default_rng(2).standard_normal((4, 32, 32, 3)) * 2).astype(np.float32)
    want = np.asarray(jax_fn(jnp.asarray(pred), jnp.float32(percent)))
    got = regularized_pseudo(_nchw(pred), percent)
    np.testing.assert_array_equal(got.numpy(), want)
    share = float((want == 255).mean())
    assert abs(share - (1.0 - percent / 100.0)) <= 0.01 or percent == 100.0


# -- the prototype losses ---------------------------------------------------------------

LOSS_CASES = [
    ("reliable", "ReliablePrototypeLoss", dict(margin=0.0, scale=1.0)),
    ("reliable-margin", "ReliablePrototypeLoss", dict(margin=0.5, scale=30.0)),
    ("reliable-hard-orth", "ReliablePrototypeLoss",
     dict(margin=0.5, scale=30.0, easy_margin=False, orthogonal_reg_weight=0.1)),
    ("euclidean", "ReliableEuclideanPrototypeLoss", {}),
    ("temperatured", "StableTemperaturedPrototypeLoss", dict(t=0.1)),
    ("temperatured-orth", "StableTemperaturedPrototypeLoss", dict(t=0.5, orthogonal_reg_weight=0.1)),
    ("only-cw", "OnlyCWPrototypeLoss", dict(margin=0.5, scale=30.0)),
    ("only-cw-orth", "OnlyCWPrototypeLoss", dict(scale=1.0, orthogonal_reg_weight=0.1)),
]


@pytest.mark.parametrize("percent", [100.0, 80.0, 37.5])
@pytest.mark.parametrize("case,cls,kw", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_prototype_loss_matches_jax(case, cls, kw, percent):
    rng = np.random.default_rng(3)
    n, h, w, c, k = 2, 16, 16, 8, 3
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    gt = rng.integers(0, k, size=(n, 2 * h, 2 * w)).astype(np.int32)  # resized nearest
    entropy = rng.uniform(0.0, 1.1, size=(n * h * w,)).astype(np.float32)
    rows = k - 1 if cls == "OnlyCWPrototypeLoss" else k
    table = rng.standard_normal((rows, c)).astype(np.float32)
    jmod = getattr(jproto, cls)(num_classes=k, embedding_dim=c, **kw)

    def jfn(xx, tt):
        return jmod.apply({"params": {"embedding": tt}}, xx, jnp.asarray(gt), percent,
                          jnp.asarray(entropy))

    jl, (jgx, jgt) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    mod = getattr(tproto, cls)(num_classes=k, embedding_dim=c, **kw)
    assert tuple(mod.embedding.shape) == (rows, c)
    with torch.no_grad():
        mod.embedding.copy_(torch.from_numpy(table))
    xt = _nchw(x).requires_grad_(True)
    loss = mod(xt, torch.from_numpy(gt).long(), percent, torch.from_numpy(entropy))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert _rel(xt.grad.permute(0, 2, 3, 1).numpy(), jgx) <= 1e-5
    if not np.any(np.asarray(jgt)):  # JAX's detached table: a zero gradient
        assert mod.embedding.grad is None or not mod.embedding.grad.any()
    else:
        assert _rel(mod.embedding.grad.numpy(), jgt) <= 1e-5


# -- the networks ---------------------------------------------------------------------


def _net_inputs():
    rng = np.random.default_rng(4)
    return _batch(rng)[:2]


@pytest.mark.parametrize("name", list(NETS))
def test_network_forwards_match_jax(name):
    x, gt = _net_inputs()
    cfg = _model_cfg(name, **NETS[name])
    jmodel = jax_make_model(cfg)
    v = seeded_variables(jmodel, (jnp.asarray(x), jnp.asarray(gt), 100.0), train=True)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    # eval forward
    jout, _, jusage, _ = jmodel.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        out, commit, usage, proto = model.eval()(_nchw(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(jout), atol=1e-4)
    np.testing.assert_array_equal(usage.numpy(), np.asarray(jusage))
    assert commit.item() == 0.0 and proto.item() == 0.0
    # train forward with gt
    (jout, jcommit, jusage, jprotol), mut = jmodel.apply(
        v, jnp.asarray(x), jnp.asarray(gt), PERCENT, train=True, mutable=["batch_stats"])
    out, commit, usage, proto = model.train()(_nchw(x), torch.from_numpy(gt).long(), PERCENT,
                                              train=True)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jout),
                               atol=1e-4)
    np.testing.assert_allclose(commit.item(), float(jcommit), rtol=1e-5)
    np.testing.assert_array_equal(usage.numpy(), np.asarray(jusage))
    assert proto.item() != 0.0
    np.testing.assert_allclose(proto.item(), float(jprotol), rtol=1e-5)
    want = state_dict_from_flax({**v, "batch_stats": _np(mut["batch_stats"])}, NUM_EMB)
    for key, t in model.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def test_vqreeuptunet_piece_by_piece():
    x, gt = _net_inputs()
    cfg = _model_cfg("vqreeuptunet")
    jmodel = jax_make_model(cfg)
    # the JAX package's train forward with gt passes pt_init twice
    with pytest.raises(TypeError, match="pt_init"):
        seeded_variables(jmodel, (jnp.asarray(x), jnp.asarray(gt), 100.0), train=True)
    v = seeded_variables(jmodel, (jnp.asarray(x),), train=False)
    assert "prototype_loss" not in v["params"]  # created only by a forward with gt
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))  # keeps its drawn table
    jout, _, jusage, _ = jmodel.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        out, _, usage, _ = model.eval()(_nchw(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(jout), atol=1e-4)
    np.testing.assert_array_equal(usage.numpy(), np.asarray(jusage))

    # train forward: JAX's without gt, then JAX's loss on the decoder output
    (jout, jcommit, jusage, _), state = jmodel.apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True)
    inter = state["intermediates"]
    dec = inter["core"]["__call__"][0][0]
    logits = inter["segmentation_head"]["__call__"][0]
    table = model.prototype_loss.embedding.detach().numpy()
    jloss = jproto.ReliableEuclideanPrototypeLoss(
        num_classes=3, embedding_dim=table.shape[1]).apply(
        {"params": {"embedding": jnp.asarray(table)}}, dec, jnp.asarray(gt), PERCENT,
        jnets.self_entropy(logits))
    out, commit, usage, proto = model.train()(_nchw(x), torch.from_numpy(gt).long(), PERCENT,
                                              train=True)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jout),
                               atol=1e-4)
    np.testing.assert_allclose(commit.item(), float(jcommit), rtol=1e-5)
    np.testing.assert_array_equal(usage.numpy(), np.asarray(jusage))
    np.testing.assert_allclose(proto.item(), float(jloss), rtol=1e-5)
    proto.backward()
    assert model.prototype_loss.embedding.grad.abs().sum() > 0  # the live table learns
    want = state_dict_from_flax({**v, "batch_stats": _np(state["batch_stats"])}, NUM_EMB)
    for key, t in model.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def test_flagship_state_dict_keys_unchanged():
    model = make_model(_model_cfg("vqreptunet1x1v2", margin=0.5, scale=30.0), device="cpu")
    keys = [k for k in model.state_dict() if not k.startswith("core.")]
    assert keys == ["segmentation_head.weight", "prototype_loss.embedding"]
    double = make_model(_model_cfg("vqreptunetdouble1x1"), device="cpu")
    assert [k for k in double.state_dict() if k.startswith("segmentation_head")] == [
        "segmentation_head.0.weight", "segmentation_head.1.weight"]
    only = make_model(_model_cfg("vqonlyptunet1x1"), device="cpu")
    assert tuple(only.prototype_loss.embedding.shape) == (2, 32)


# -- the driver -------------------------------------------------------------------------


def _drv_cfg(data_dir, save_dir, name="vqreptunet1x1", **train):
    cfg = json.load(open(os.path.join(ROOT, "config", f"{name}.json")))
    cfg["resize"] = HW
    params = cfg["model"]["params"]
    params.update(encoder_name="resnet18", encoder_weights=None)
    params["vq_cfg"]["num_embeddings"] = NUM_EMB
    cfg["train"].update(data_dir=data_dir, save_dir=save_dir, num_epochs=1, batch_size=2,
                        **{"test_every": 1, **train})
    cfg["test"].update(data_dir=data_dir, save_dir=os.path.join(save_dir, "..", "test"))
    return cfg


def _listing(run_dir):
    """Paths under ``run_dir``, a checkpoint counted once (the JAX package
    writes each as a directory)."""
    return sorted(os.path.relpath(os.path.join(d, n), run_dir)
                  for d, dirs, files in os.walk(run_dir) for n in dirs + files
                  if ".ckpt" not in os.path.relpath(d, run_dir))


def _jit_dual_state(model, tx, sample_args, seed=0):
    """The JAX driver's ``_dual_state`` with ``model.init`` compiled once for
    both models.  Op by op, flax's init compiles each random draw on its
    own (about 25 s on the CPU); compiled, its values are the same to
    within an ulp."""
    arrays, percent = sample_args[:2], sample_args[2]
    init = jax.jit(lambda rngs, *a: model.init(rngs, *a, percent, train=True))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    v1, v2 = (init({"params": k, "dropout": k}, *arrays) for k in (k1, k2))
    return jvd.CPSTrainState(variables_1=v1, variables_2=v2, opt_state_1=tx.init(v1["params"]),
                             opt_state_2=tx.init(v2["params"]), step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def driver_runs(synthetic_dataset, tmp_path_factory):
    """JAX's ``train_rept_cps`` for one epoch of 2 steps, then the port's
    from JAX's post-init state (captured at the JAX step's first call).
    JAX's init is compiled (``_jit_dual_state``)."""
    base = tmp_path_factory.mktemp("reptcps")
    captured = {}
    real_make = jvd.make_rept_cps_train_step

    def make_capturing(*a, **k):
        step = real_make(*a, **k)

        def capturing(state, l_img, l_target, ul_img, drop_percent):
            if "post" not in captured:  # numpy copies: the step donates the state
                captured["post"] = _np(state)
            return step(state, l_img, l_target, ul_img, drop_percent)

        captured["step"] = step
        return capturing

    # the JAX package's fastimg.load() gives None to a decode thread that
    # asks while another thread loads the library, and that item then
    # decodes through PIL (up to 2/255 off): load it before its loader runs
    jfastimg.load()
    mp = pytest.MonkeyPatch()
    mp.setattr(jvd, "make_rept_cps_train_step", make_capturing)
    mp.setattr(jvd, "_dual_state", _jit_dual_state)
    try:
        jvd.train_rept_cps(JaxConfig(_drv_cfg(synthetic_dataset, str(base / "jax"))),
                           max_steps_per_epoch=2)
    finally:
        mp.undo()

    def port_init(state, l_img, l_target, percent, **k):
        assert percent == 100.0
        captured["tf32_in_driver"] = _tf32_flags()
        return cps_state_from_flax(state, captured["post"], NUM_EMB)

    mp.setattr(variant_drivers, "cps_init_phase", port_init)
    history = []
    try:
        state = variant_drivers.train_rept_cps(
            Config(_drv_cfg(synthetic_dataset, str(base / "port"))), max_steps_per_epoch=2,
            device="cpu", history=history)
    finally:
        mp.undo()
    yield dict(state=state, history=history, captured=captured,
               jax_run=str(base / "jax" / "VQRePTUnet1x1_reptcps_0"),
               port_run=str(base / "port" / "VQRePTUnet1x1_reptcps_0"))
    shutil.rmtree(base, ignore_errors=True)  # four full contracts, 1.3 GB


# -- one reptcps step -------------------------------------------------------------------


def _gradient_tx():
    """Updates nothing and keeps the last gradient as its state."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)
    return optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _port_step(post, batch, dtype=torch.float32):
    """The port's step; also returns the TF32 flags each forward of model 1
    saw."""
    st = create_cps_state(_drv_cfg("", "")["model"], lambda step: 1.0, device="cpu")
    cps_state_from_flax(st, post, NUM_EMB)
    if dtype == torch.float64:
        st.model_1.double()
        st.model_2.double()
    step = make_rept_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)
    seen = []
    st.model_1.register_forward_pre_hook(lambda *_: seen.append(_tf32_flags()))
    l_img, l_t, ul = batch
    _, metrics = step(st, _nchw(l_img).to(dtype), torch.from_numpy(l_t).long(),
                      _nchw(ul).to(dtype), PERCENT)
    return st, metrics, seen


def _adam_gradient(tree):
    """The gradient of Adam's first update, from its first moment
    ``mu = (1 - b1) * g``."""
    return jax.tree_util.tree_map(lambda mu: mu / np.float32(0.1), tree[0].mu)


def test_one_rept_cps_step_matches_jax(driver_runs, monkeypatch):
    """One step from the JAX driver's post-init state on a seeded batch:
    JAX's f32 step is the driver's own compiled step, its gradients read
    from Adam's first moment; JAX's f64 step keeps the gradient."""
    post = driver_runs["captured"]["post"]
    # seed 8: the f32 and f64 steps take the same masks and pseudo-labels
    # (with the driver's own first batch an entropy at the percentile
    # threshold flips between the two precisions, in both packages alike)
    batch = _batch(np.random.default_rng(STEP_SEED))
    jnew, jm = driver_runs["captured"]["step"](
        jax.tree_util.tree_map(jnp.asarray, post), *map(jnp.asarray, batch),
        jnp.float32(PERCENT))
    jnew, jm = _np(jnew), _np(jm)
    tx = _gradient_tx()
    jpost = post.replace(opt_state_1=_np(tx.init(post.variables_1["params"])),
                         opt_state_2=_np(tx.init(post.variables_2["params"])))
    jmodel = jax_make_model(_drv_cfg("", "")["model"])
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        step = jvariants.make_rept_cps_train_step(
            jmodel, tx, jax_make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)
        wide = lambda a: jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
        l_img, l_t, ul = batch
        jnew64, _ = step(jax.tree_util.tree_map(wide, jpost), wide(l_img), jnp.asarray(l_t),
                         wide(ul), jnp.asarray(PERCENT, np.float64))
        jnew64 = _np(jnew64)
    assert jnew64.opt_state_1["segmentation_head"]["Conv_0"]["kernel"].dtype == np.float64

    flags = _tf32_flags()
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, which the step must override
    try:
        st, m, seen = _port_step(post, batch)
        # cuDNN and cuBLAS in full f32 in every forward of the step, and the
        # caller's setting back after it
        assert seen == [(False, False)] * 3 and _tf32_flags() == (True, flags[1])
    finally:
        torch.backends.cudnn.allow_tf32 = flags[0]
    for key in METRICS:
        np.testing.assert_allclose(m[key].numpy(), jm[key], rtol=1e-4, atol=1e-7, err_msg=key)
    # the same port step in f64: ``.float()`` leaves f64 tensors as they are
    f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda t: t if t.dtype == torch.float64 else f32(t))
    st64, _, _ = _port_step(post, batch, torch.float64)
    monkeypatch.undo()

    for model, model64, jv, jv_new, jo, jg64 in (
            (st.model_1, st64.model_1, post.variables_1, jnew.variables_1, jnew.opt_state_1,
             jnew64.opt_state_1),
            (st.model_2, st64.model_2, post.variables_2, jnew.variables_2, jnew.opt_state_2,
             jnew64.opt_state_2)):
        jg32 = state_dict_from_flax({**jv, "params": _adam_gradient(jo)}, NUM_EMB)
        jg64 = state_dict_from_flax({**jv, "params": jg64}, NUM_EMB)
        g64 = dict(model64.named_parameters())
        for name, p in model.named_parameters():
            want = jg64[name].numpy()
            if name == "prototype_loss.embedding":  # detached: no gradient, JAX's zero
                assert p.grad is None and g64[name].grad is None and not want.any()
                continue
            assert _rel(g64[name].grad.numpy(), want) <= 1e-6, name
            assert _rel(p.grad.numpy(), want) <= 1e-4, name
            assert _rel(p.grad.numpy(), jg32[name].numpy()) <= 1e-4 + _rel(jg32[name].numpy(), want), name
        want = state_dict_from_flax(jv_new, NUM_EMB)
        for key, t in model.state_dict().items():
            if "running" in key:
                np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=key)
            if "codebooks" in key:  # frozen: bitwise as before the step
                np.testing.assert_array_equal(t.numpy(), want[key].numpy(), err_msg=key)
    assert st.step == 1


def test_driver_epoch_matches_jax(driver_runs):
    jrun, prun = driver_runs["jax_run"], driver_runs["port_run"]
    assert _listing(jrun) == _listing(prun) == sorted(
        ["ckpoints", "ckpoints/0ep.ckpt", "ckpoints/last.ckpt", "log_txt",
         "VQRePTUnet1x1_reptcps_0.jsonl"])
    [jrec] = [json.loads(line) for line in open(os.path.join(jrun, "VQRePTUnet1x1_reptcps_0.jsonl"))]
    [rec] = [json.loads(line) for line in open(os.path.join(prun, "VQRePTUnet1x1_reptcps_0.jsonl"))]
    assert set(rec) == set(jrec)
    for k in rec:
        tol = dict(atol=1e-3) if k == "miou" else dict(rtol=1e-3)
        np.testing.assert_allclose(rec[k], jrec[k], err_msg=k, **tol)
    [jline] = open(os.path.join(jrun, "log_txt")).read().splitlines()
    [line] = open(os.path.join(prun, "log_txt")).read().splitlines()
    assert line.startswith("[reptcps][Epoch0] ") and jline.startswith("[reptcps][Epoch0] ")
    assert [kv.split("=")[0] for kv in line.split(", ")[:-1]] == \
        [kv.split("=")[0] for kv in jline.split(", ")[:-1]]
    assert driver_runs["captured"]["tf32_in_driver"] == (False, False)  # full f32
    [h] = driver_runs["history"]
    assert h["drop_percent"] == 80.0 and h["step"] == 2 and 0.0 <= h["test_miou"] <= 1.0
    for name in ("0ep.ckpt", "last.ckpt"):
        ck = ckpoints.load_full(os.path.join(prun, "ckpoints", name))
        jck = jax_load_full(os.path.join(jrun, "ckpoints", name))
        assert set(ck) == set(jck) == CONTRACT
        assert ck["epoch"] == int(jck["epoch"]) == 0 and ck["batch_idx"] == int(jck["batch_idx"]) == 1
    # the detached table has no Adam state; resume's step count still reads
    ck = ckpoints.load_full(os.path.join(prun, "ckpoints", "last.ckpt"))
    st = create_cps_state(_drv_cfg("", "")["model"], lambda s: 1.0, device="cpu")
    from vq_seg_tpu_torch.training import restore_cps_state
    restore_cps_state(st, ck)
    assert st.step == 2


@pytest.mark.parametrize("name", REPTCPS_CONFIGS)
def test_shipped_reptcps_configs_through_the_cli(name, synthetic_dataset, tmp_path, capsys):
    cfg = _drv_cfg(synthetic_dataset, str(tmp_path / "runs"), name, test_every=0)
    cfg["wandb_logging"] = False
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    train_cli.main(["--config_path", str(path), "--max_steps_per_epoch", "1", "--device", "cpu"])
    assert "[reptcps][Epoch0] " in capsys.readouterr().out
    [run] = os.listdir(tmp_path / "runs")
    assert run == f"{cfg['project_name']}_reptcps_0"
    ck = ckpoints.load_full(str(tmp_path / "runs" / run / "ckpoints" / "last.ckpt"))
    assert set(ck) == CONTRACT
    if name in DATA_VARIANTS:
        shutil.rmtree(tmp_path / "runs")
        return
    # the run's last.ckpt serves and is swept by the test CLI
    last = str(tmp_path / "runs" / run / "ckpoints" / "last.ckpt")
    pred = Predictor.from_checkpoint(Config(cfg), last, device="cpu", batch_size=2, half=False)
    labels = pred(np.zeros((2, HW, HW, 3), np.uint8))
    assert labels.shape == (2, HW, HW) and int(labels.max()) < 3
    cfg["test"].update(weights=os.path.dirname(last), save_dir=str(tmp_path / "test"))
    best_path, best = test_cli.test(Config(cfg), save_img=False, device="cpu")
    assert best_path.endswith(".ckpt") and 0.0 <= best["test_miou"] <= 1.0
    shutil.rmtree(tmp_path / "runs")  # two full contracts, 0.6 GB


def test_reptcps_entry_points_need_the_card(synthetic_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = _drv_cfg(synthetic_dataset, str(tmp_path / "runs"))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    for call in (lambda: variant_drivers.train_rept_cps(Config(copy.deepcopy(cfg))),
                 lambda: train_cli.main(["--config_path", str(path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.path.exists(tmp_path / "runs")
