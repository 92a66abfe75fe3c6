"""Port parity: the ``plaincps`` and ``objcps`` trainers against the JAX
package, f32 on the CPU, at resnet18 / K=8 / 64x64, batch 2 labeled + 2
unlabeled.

The port starts from JAX's variables, mapped by ``state_dict_from_flax``.

Bounds:
  * one ``plaincps`` step of ``vqatunet`` (``vqatunet.json``: the encoder
    at lr / 10) and one ``objcps`` step of ``vqcanet``
    (``vqcanet_obj_loss.json``) against the JAX driver's own compiled step,
    from its post-init state with the attention gates set to 0.7: loss
    terms within 1e-5 relative (IoUs 1e-3 absolute), every parameter's
    gradient within 1e-4 relative L2 of JAX's in f64, and each model's f32
    gradient (JAX's read from Adam's first moment) as the test says; BN
    running stats within 1e-5, codebooks unchanged.  The port's step and
    optimizers are the driver's (``plain_step``).  Adam's first update is
    lr * g / (|g| + 1e-8) with lr the group's rate: JAX's
    parameters after its step follow it from JAX's gradients (which pins
    the groups of ``multi_lr_tx``), and the port's from the port's.
  * one driver epoch of ``train_plain_cps`` and of ``train_obj_cps``
    against JAX's on the same PNG tree, the port starting from JAX's
    post-init state: epoch averages within 1e-3 relative (IoUs 1e-3
    absolute), the same run directory, checkpoint files and contract keys,
    and each forward in full f32.
  * ``init_phase`` of ``vqcanetv4`` (in-encoder codebooks) and of
    ``vqsegheadnet`` (the head's K=3 codebook): the encoder's running stats
    as JAX's, and every codebook the k-means of its own train-mode rows,
    replayed from the generator the phase draws from.
  * ``multi_lr_adam``'s encoder group on the networks whose encoder sits at
    the top level.
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
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import supervised as jsup
from vq_seg_tpu.training import variant_drivers as jvd
from vq_seg_tpu.training import variants as jvariants
from vq_seg_tpu.utils.ckpoints import load_full as jax_load_full
from _seeded_flax import seeded_variables
from vq_seg_tpu_torch import train as train_cli
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.ops.kmeans import kmeans_step, sample_vectors
from vq_seg_tpu_torch.training import create_cps_state, supervised, variant_drivers
from vq_seg_tpu_torch.training.cps import model_cfg_with_bn
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import cps_state_from_flax, state_dict_from_flax
from vq_seg_tpu_torch.utils.train_tools import multi_lr_adam

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, B, STEP_SEED, GATE = 64, 2, 8, 0.7
NUM_EMB = [0, 0, 8, 8, 8]
CONTRACT = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}
# mode -> (config, network, metrics of the step)
MODES = {
    "plaincps": ("vqatunet", ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "usage_loss")),
    "objcps": ("vqcanet_obj_loss", ("loss", "cps_loss", "sup_loss", "obj_loss",
                                    "commitment_loss")),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batch(rng):
    img = rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)
    lab = ((np.arange(HW)[None, :, None] // 8 + rng.integers(0, 2, size=(B, HW, HW))) % 3)
    return img, lab.astype(np.int32), rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)


def _drv_cfg(data_dir, save_dir, name, **train):
    cfg = json.load(open(os.path.join(ROOT, "config", f"{name}.json")))
    cfg["resize"] = HW
    params = cfg["model"]["params"]
    params.update(encoder_name="resnet18", encoder_weights=None)
    params["vq_cfg"]["num_embeddings"] = NUM_EMB
    cfg["train"].update(data_dir=data_dir, save_dir=save_dir, num_epochs=1, batch_size=B,
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
    both models (op by op, flax's init compiles each random draw)."""
    init = jax.jit(lambda rngs, x: model.init(rngs, x, train=True))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    v1, v2 = (init({"params": k, "dropout": k}, *sample_args) for k in (k1, k2))
    return jvd.CPSTrainState(variables_1=v1, variables_2=v2, opt_state_1=tx.init(v1["params"]),
                             opt_state_2=tx.init(v2["params"]), step=jnp.zeros((), jnp.int32))


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _driver_runs(mode, synthetic_dataset, tmp_path_factory):
    """JAX's driver for one epoch of 2 steps, then the port's from JAX's
    post-init state (captured at the JAX step's first call)."""
    name = MODES[mode][0]
    base = tmp_path_factory.mktemp(mode)
    captured = {}
    owner, attr = ((jvd, "make_plain_cps_train_step") if mode == "plaincps"
                   else (jvariants, "make_objloss_cps_train_step"))
    real_make = getattr(owner, attr)

    def make_capturing(*a, **k):
        step = real_make(*a, **k)

        def capturing(state, *batch):
            if "post" not in captured:  # numpy copies: the step donates the state
                captured["post"] = _np(state)
            return step(state, *batch)

        captured["step"] = step
        return capturing

    # the JAX package's fastimg.load() gives None to a decode thread that
    # asks while another thread loads the library, and that item then
    # decodes through PIL (up to 2/255 off): load it before its loader runs
    jfastimg.load()
    mp = pytest.MonkeyPatch()
    mp.setattr(owner, attr, make_capturing)
    mp.setattr(jvd, "_dual_state", _jit_dual_state)
    jax_train = jvd.train_plain_cps if mode == "plaincps" else jvd.train_obj_cps
    try:
        jax_train(JaxConfig(_drv_cfg(synthetic_dataset, str(base / "jax"), name)),
                  max_steps_per_epoch=2)
    finally:
        mp.undo()

    def port_init(state, l_img, l_target):
        captured["tf32_in_driver"] = _tf32_flags()
        return cps_state_from_flax(state, captured["post"], NUM_EMB)

    mp.setattr(variant_drivers, "plain_init_phase", port_init)
    seen = []
    real_create = variant_drivers.create_cps_state

    def create_watching(*a, **k):
        st = real_create(*a, **k)
        st.model_1.register_forward_pre_hook(lambda *_: seen.append(_tf32_flags()))
        return st

    mp.setattr(variant_drivers, "create_cps_state", create_watching)
    history = []
    port_train = (variant_drivers.train_plain_cps if mode == "plaincps"
                  else variant_drivers.train_obj_cps)
    try:
        state = port_train(Config(_drv_cfg(synthetic_dataset, str(base / "port"), name)),
                           max_steps_per_epoch=2, device="cpu", history=history)
    finally:
        mp.undo()
    project = json.load(open(os.path.join(ROOT, "config", f"{name}.json")))["project_name"]
    run = f"{project}_{mode}_0"
    yield dict(state=state, history=history, captured=captured, seen=seen, run=run,
               jax_run=str(base / "jax" / run), port_run=str(base / "port" / run))
    shutil.rmtree(base, ignore_errors=True)  # four full contracts


@pytest.fixture(scope="module")
def plain_runs(synthetic_dataset, tmp_path_factory):
    yield from _driver_runs("plaincps", synthetic_dataset, tmp_path_factory)


@pytest.fixture(scope="module")
def obj_runs(synthetic_dataset, tmp_path_factory):
    yield from _driver_runs("objcps", synthetic_dataset, tmp_path_factory)


@pytest.fixture
def runs(request):
    return request.getfixturevalue({"plaincps": "plain_runs", "objcps": "obj_runs"}[
        request.param])


# -- one step ---------------------------------------------------------------------------


def _with_gates(variables):
    """The variables with every ``gamma`` (PAM's, CAM's) at ``GATE``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.full_like(a, GATE) if path[-1].key == "gamma" else a, variables)


def _adam_moments(opt_state, params):
    """Adam's first moment of every parameter and the divisor of its rate:
    from ``optax.adam``'s state, or from ``multi_lr_tx``'s partition (the
    encoder group at ``lr / decoder_lr_times``)."""
    masked = lambda t: isinstance(t, optax.MaskedNode)
    if isinstance(opt_state, optax.transforms.PartitionState):
        enc = opt_state.inner_states["encoder"].inner_state[0].mu
        rest = opt_state.inner_states["rest"].inner_state[0].mu
        mu = jax.tree_util.tree_map(lambda p, a, b: b if masked(a) else a, params, enc, rest,
                                    is_leaf=masked)
        div = jax.tree_util.tree_map(lambda p, a: np.full(p.shape, 1.0 if masked(a) else 10.0,
                                                          np.float32), params, enc,
                                     is_leaf=masked)
        return mu, div
    return opt_state[0].mu, jax.tree_util.tree_map(lambda p: np.ones(p.shape, np.float32), params)


def _adam_first(before, grad, lr):
    """Adam's first update (b1 0.9, b2 0.999, eps 1e-8)."""
    return before - lr * grad / (np.abs(grad) + 1e-8)


def _gradient_tx():
    """Updates nothing and keeps the last gradient as its state."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)
    return optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))


def _port_state(mode, cfg, post, lr, dtype=torch.float32):
    """The port's state from JAX's ``post`` and the step and optimizers
    its driver builds (``variant_drivers.plain_step``)."""
    st = create_cps_state(model_cfg_with_bn(Config(cfg)), lambda step: lr, device="cpu")
    cps_state_from_flax(st, post, NUM_EMB)
    if dtype == torch.float64:
        st.model_1.double()
        st.model_2.double()
    return st, variant_drivers.plain_step(Config(cfg), st, mode)


def _port_step(step, st, batch, dtype=torch.float32):
    l_img, l_t, ul = batch
    return step(st, _nchw(l_img).to(dtype), torch.from_numpy(l_t).long(),
                _nchw(ul).to(dtype))[1]


def _f64_gradients(mode, cfg, post, batch, monkeypatch):
    """Both packages' gradients of one step in f64 (JAX's x64 with its f32
    casts widened, the port's ``.float()`` leaving f64 as it is), as port
    state dicts per model."""
    tx = _gradient_tx()
    jpost = post.replace(opt_state_1=_np(tx.init(post.variables_1["params"])),
                         opt_state_2=_np(tx.init(post.variables_2["params"])))
    jmodel = jax_make_model(cfg["model"])
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        if mode == "plaincps":
            step = jvariants.make_plain_cps_train_step(jmodel, tx, num_classes=3)
        else:
            crit = cfg["train"]["criterion"]["name"]
            step = jvariants.make_objloss_cps_train_step(
                jmodel, tx, jax_make_loss(crit, 3, ignore_index=255), jax_make_loss(crit, 1),
                num_classes=3, batch_size=B)
        wide = lambda a: jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
        l_img, l_t, ul = batch
        jnew, _ = step(jax.tree_util.tree_map(wide, jpost), wide(l_img), jnp.asarray(l_t),
                       wide(ul))
        jnew = _np(jnew)
    # (state_dict_from_flax rounds to f32: 6e-8 relative, far below the bounds)
    jg = [{k: t.numpy() for k, t in state_dict_from_flax({**v, "params": o}, NUM_EMB).items()}
          for v, o in ((post.variables_1, jnew.opt_state_1), (post.variables_2, jnew.opt_state_2))]
    f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t: t if t.dtype == torch.float64 else f32(t))
    st, step = _port_state(mode, cfg, post, 1e-3, torch.float64)
    _port_step(step, st, batch, torch.float64)
    monkeypatch.undo()
    running = lambda sd: {k: np.asarray(t, np.float64) for k, t in sd.items() if "running" in k}
    jstats = [running(state_dict_from_flax(v, NUM_EMB))
              for v in (jnew.variables_1, jnew.variables_2)]
    return (jg, [{n: p.grad.numpy() for n, p in m.named_parameters()}
                 for m in (st.model_1, st.model_2)],
            jstats, [running(m.state_dict()) for m in (st.model_1, st.model_2)])


@pytest.mark.parametrize("runs", list(MODES), indirect=True)
def test_one_step_matches_jax(runs, monkeypatch):
    """From the JAX driver's post-init state with the gates at ``GATE``, on
    a seeded batch.  ``vqatunet``'s attention softmaxes (no 1/sqrt(d)
    scale; CAM's energies are Gram entries summed over up to 1024
    positions) are near one-hot, so f32 rounding moves some of its
    gradients by up to 10% in either package, and ``vqcanet``'s CCA on a
    2x2 map moves the stem's by 2e-4: both steps also run in f64, every
    parameter's gradient is held to 1e-4 in f64 (PAM's key bias,
    whose gradient is zero since a softmax ignores a per-row constant, to
    1e-12 of the model's gradient), and the port's f32 gradient of the
    whole model, against the f64 one, to 1e-4 plus twice JAX's own f32
    distance; the BN running stats to 1e-5 in f64 and, in f32, each to
    1e-5 plus twice JAX's own distance."""
    mode = next(m for m in MODES if runs["run"].endswith(f"_{m}_0"))
    cfg = _drv_cfg("", "", MODES[mode][0])
    post = _np(runs["captured"]["post"])
    post = post.replace(variables_1=_with_gates(post.variables_1),
                        variables_2=_with_gates(post.variables_2))
    batch = _batch(np.random.default_rng(STEP_SEED))
    jnew, jm = runs["captured"]["step"](jax.tree_util.tree_map(jnp.asarray, post),
                                        *map(jnp.asarray, batch))
    jnew, jm = _np(jnew), _np(jm)

    lr = 0.5e-3  # the port's rate; the groups divide it
    st, step = _port_state(mode, cfg, post, lr)
    before = [{k: p.detach().clone() for k, p in m.named_parameters()}
              for m in (st.model_1, st.model_2)]
    m = _port_step(step, st, batch)
    for key in MODES[mode][1]:
        np.testing.assert_allclose(m[key].numpy(), jm[key], rtol=1e-5, atol=1e-7, err_msg=key)
    for key in ("miou", "iou_list"):
        np.testing.assert_allclose(m[key].numpy(), jm[key], atol=1e-3, err_msg=key)
    jax_lr = cfg["train"]["learning_rate"]  # the driver's cosine schedule at step 0
    jg64s, g64s, jstats64, stats64 = _f64_gradients(mode, cfg, post, batch, monkeypatch)

    for i, (model, pre, jv, jv_new, jo) in enumerate((
            (st.model_1, before[0], post.variables_1, jnew.variables_1, jnew.opt_state_1),
            (st.model_2, before[1], post.variables_2, jnew.variables_2, jnew.opt_state_2))):
        mu, div = _adam_moments(jo, jv["params"])
        jgrad = state_dict_from_flax({**jv, "params": jax.tree_util.tree_map(
            lambda a: a / np.float32(0.1), mu)}, NUM_EMB)
        jdiv = state_dict_from_flax({**jv, "params": div}, NUM_EMB)
        jbefore = state_dict_from_flax(jv, NUM_EMB)
        jafter = state_dict_from_flax(jv_new, NUM_EMB)
        jg64, g64 = jg64s[i], g64s[i]
        total = np.sqrt(sum(np.sum(np.square(g.astype(np.float64))) for g in jg64.values()))
        flat32 = []
        for pname, p in model.named_parameters():
            g, jg = p.grad.numpy(), jgrad[pname].numpy()
            want = jg64[pname]
            if np.linalg.norm(want) <= 1e-12 * total:  # a zero gradient
                assert np.linalg.norm(g64[pname] - want) <= 1e-12 * total, pname
                assert "key.bias" in pname
            else:
                assert _rel(g64[pname], want) <= 1e-4, pname
                flat32.append((g, jg, want))
            d = float(jdiv[pname].numpy().reshape(-1)[0])
            assert d == (10.0 if mode == "plaincps" and pname.startswith("core.encoder.")
                         else 1.0), pname
            # JAX's Adam: its gradient at the group's rate, the group its own
            np.testing.assert_allclose(jafter[pname].numpy(),
                                       _adam_first(jbefore[pname].numpy(), jg, jax_lr / d),
                                       rtol=1e-6, atol=jax_lr * 1e-4, err_msg=pname)
            # the port's Adam: its own gradient at the same group's rate
            np.testing.assert_allclose(p.detach().numpy(),
                                       _adam_first(pre[pname].numpy(), g, lr / d),
                                       rtol=1e-6, atol=lr * 1e-4, err_msg=pname)
        # the model's f32 gradient as a whole, against the f64 one
        cat = [np.concatenate([a[j].reshape(-1) for a in flat32]) for j in range(3)]
        assert _rel(cat[0], cat[2]) <= 1e-4 + 2 * _rel(cat[1], cat[2])
        want = state_dict_from_flax(jv_new, NUM_EMB)
        for key, t in model.state_dict().items():
            if "running" in key:  # f64 within 1e-5; f32 as the gradients
                w64 = jstats64[i][key]
                np.testing.assert_allclose(stats64[i][key], w64, rtol=1e-5, atol=1e-5, err_msg=key)
                err = np.abs(t.numpy() - w64).max()
                assert err <= 1e-5 + 2 * np.abs(want[key].numpy() - w64).max(), key
            if "codebooks" in key:  # frozen: bitwise as before the step
                np.testing.assert_array_equal(t.numpy(), want[key].numpy(), err_msg=key)
    assert st.step == 1


# -- one driver epoch ---------------------------------------------------------------------


@pytest.mark.parametrize("runs", list(MODES), indirect=True)
def test_driver_epoch_matches_jax(runs):
    jrun, prun, run = runs["jax_run"], runs["port_run"], runs["run"]
    assert _listing(jrun) == _listing(prun) == sorted(
        ["ckpoints", "ckpoints/0ep.ckpt", "ckpoints/last.ckpt", "log_txt", f"{run}.jsonl"])
    [jrec] = [json.loads(line) for line in open(os.path.join(jrun, f"{run}.jsonl"))]
    [rec] = [json.loads(line) for line in open(os.path.join(prun, f"{run}.jsonl"))]
    assert set(rec) == set(jrec)
    for k in rec:
        tol = dict(atol=1e-3) if k == "miou" else dict(rtol=1e-3)
        np.testing.assert_allclose(rec[k], jrec[k], err_msg=k, **tol)
    mode = run.rsplit("_", 2)[1]
    [jline] = open(os.path.join(jrun, "log_txt")).read().splitlines()
    [line] = open(os.path.join(prun, "log_txt")).read().splitlines()
    assert line.startswith(f"[{mode}][Epoch0] ") and jline.startswith(f"[{mode}][Epoch0] ")
    assert [kv.split("=")[0] for kv in line.split(", ")[:-1]] == \
        [kv.split("=")[0] for kv in jline.split(", ")[:-1]]
    # full f32: the init phase and every forward (2 train steps, 3 test images)
    assert runs["captured"]["tf32_in_driver"] == (False, False)
    assert runs["seen"] == [(False, False)] * 7
    [h] = runs["history"]
    assert h["step"] == 2 and 0.0 <= h["test_miou"] <= 1.0 and h["ckpt_files"] == [
        "0ep.ckpt", "last.ckpt"]
    for name in ("0ep.ckpt", "last.ckpt"):
        ck = ckpoints.load_full(os.path.join(prun, "ckpoints", name))
        jck = jax_load_full(os.path.join(jrun, "ckpoints", name))
        assert set(ck) == set(jck) == CONTRACT
        assert ck["epoch"] == int(jck["epoch"]) == 0 and ck["batch_idx"] == int(jck["batch_idx"]) == 1
    if mode == "plaincps":  # vqatunet.json: the encoder group at lr / 10
        groups = runs["state"].opt_1.param_groups
        assert [g.get("lr_div") for g in groups] == [10.0, None]
        assert groups[0]["lr"] * 10.0 == pytest.approx(groups[1]["lr"], rel=1e-12)


# -- the init phase -----------------------------------------------------------------------


def _net_cfg(name, encoder="resnet18", **extra):
    return {"name": name, "params": {
        "encoder_name": encoder, "num_classes": 3,
        "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True},
        **extra}}


def _rows(f):
    return f.permute(0, 2, 3, 1).reshape(-1, f.shape[1])


def _replay(rows, table, generator):
    means = sample_vectors(rows, table.shape[0], generator)
    for _ in range(10):
        means, _ = kmeans_step(rows, means)
    np.testing.assert_allclose(means.numpy(), table.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["vqcanetv4", "vqsegheadnet"])
def test_init_phase(name):
    cfg = _net_cfg(name, **({"encoder_name": "ccavqresnet18",
                             "cca": [False, False, True, True, True]} if name == "vqcanetv4"
                            else {}))
    x = _batch(np.random.default_rng(2))[0]
    jmodel = jax_make_model(cfg)
    v = seeded_variables(jmodel, (jnp.asarray(x),), train=True)
    pre = jsup.TrainState(variables=v, opt_state=None, step=jnp.zeros((), jnp.int32))
    post = _np(jsup.init_phase(jmodel, pre, (jnp.asarray(x),)))
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(_np(v), NUM_EMB))
    before = copy.deepcopy(model)
    heads = []
    if name == "vqsegheadnet":
        model.segmentation_head.register_forward_pre_hook(lambda m, a: heads.append(a[0]))
    st = supervised.TrainState(model, None, lambda s: 1.0)
    supervised.init_phase(st, (_nchw(x),), seed=0)
    assert not model.training  # left as found (make_model gives eval mode)
    sd = model.state_dict()
    want = state_dict_from_flax(post.variables, NUM_EMB)
    prefix = "encoder.backbone." if name == "vqcanetv4" else "core.encoder."
    enc = [k for k in sd if k.startswith(prefix) and "running" in k]
    assert enc
    for key in enc:
        np.testing.assert_allclose(sd[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    # each codebook is the k-means of its own train-mode rows, stage by
    # stage from the generator the phase draws from; the head's last
    generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if name == "vqcanetv4":
            feats, books = before.train().encoder.backbone(_nchw(x))[1:], "encoder.codebooks"
        else:
            feats, books = before.train().core._features(_nchw(x)), "core.codebooks"
    for i, f in enumerate(feats):
        if NUM_EMB[i]:
            _replay(_rows(f), sd[f"{books}.{i}.embedding"], generator)
    if name == "vqsegheadnet":
        table = sd["segmentation_head.embedding"]
        assert tuple(table.shape) == (3, 32)
        _replay(_rows(heads[0]), table, generator)


def test_multi_lr_groups():
    """The encoder group holds exactly the parameters under a path segment
    named ``encoder``: ``core.encoder`` or the top-level ``encoder`` (with
    the ccavq ``backbone``); the rest, with the head, in the other."""
    for name, encoder, prefix in (("vqatunet", "resnet18", "core.encoder."),
                                  ("vqcanetv2", "ccaresnet18", "encoder."),
                                  ("vqcanetv4", "ccavqresnet18", "encoder.backbone.")):
        model = make_model(_net_cfg(name, encoder), device="cpu")
        opt = multi_lr_adam(model, 10)
        enc, rest = opt.param_groups
        names = {id(p): n for n, p in model.named_parameters()}
        assert enc["lr_div"] == 10.0 and all(names[id(p)].startswith(prefix)
                                             for p in enc["params"])
        assert not any(names[id(p)].startswith(prefix) for p in rest["params"])
        assert len(enc["params"]) + len(rest["params"]) == len(names)
        assert len(multi_lr_adam(model, 1).param_groups) == 1


def test_plain_and_obj_entry_points_need_the_card(synthetic_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for mode, name in (("plaincps", "vqatunet"), ("objcps", "vqcanet_obj_loss")):
        cfg = _drv_cfg(synthetic_dataset, str(tmp_path / "runs"), name)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        driver = (variant_drivers.train_plain_cps if mode == "plaincps"
                  else variant_drivers.train_obj_cps)
        for call in (lambda: driver(Config(copy.deepcopy(cfg))),
                     lambda: train_cli.main(["--config_path", str(path)])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert not os.path.exists(tmp_path / "runs")
