"""Port parity: the VQ EMA codebook update and dead-code restart
(``vq_cfg.ema``, ``vq_cfg.restart_threshold``) against the JAX package, f32
on the CPU.

  * ``VectorQuantizer(ema=True)`` alone, euclidean and cosine, with and
    without restart, over 3 sequential train forwards from JAX's k-means
    init: idx and counts exactly equal, ``cluster_size``, ``embed_avg``
    and the codebook within 1e-5 relative (1e-6 absolute) of JAX's after
    each forward; the revived codes and their rows exactly equal.
  * Restart with ties: rows of exactly equal residual (duplicates, and
    distinct rows with the same squared norm): the row each code takes is
    JAX's ``top_k`` order (the lower row first), bitwise.
  * The frozen paths: eval, the init phase, a train forward outside
    ``ema_updates()``, ``ema=False`` (whose ``state_dict`` keys stay those
    of a config without the knob), ``vqvaev1`` (JAX passes it six knobs
    only) and a ``plaincps`` step under ``ema: true``: the codebook and
    its state bitwise unchanged.
  * The flagship CPS step with EMA and restart against JAX's
    ``make_cps_train_step`` for 2 steps (resnet18 / K=8 / 64x64, batch
    2+2; an optax transformation that updates nothing, so that both
    steps see the same parameters): loss terms within 1e-4 relative and
    BN running stats within 1e-5 (``tests/test_torch_training.py``'s
    bounds for a step); the revived codes equal.  The codebooks,
    ``cluster_size`` and ``embed_avg`` are means of train-mode features,
    which f32 carries only to about 1e-5 at resnet18's deepest stage (8
    rows per BN channel here): the port's f64 step within 1e-6 relative L2
    of JAX's f64 step, and the port's f32 step within 1e-5 of JAX's f64
    plus JAX's own f32 distance from it.  One accumulated micro-step
    (``grad_accum_steps`` 2) updates the codebooks as JAX's step does
    (the mutated collections do not depend on the transformation) and
    leaves the parameters bitwise.  One ``sup`` step of ``vqunet_v2`` and
    one ``selfsup`` step of ``vqvaev2`` against JAX's: loss terms within
    1e-4 (1e-5 for ``selfsup``), the codebook state within 1e-5 relative
    L2.
  * JAX's EMA state through ``tools/jax_ckpt_to_port.py`` into a port
    state that resumes: bitwise JAX's after the conversion, and the port's
    own checkpoint restores a state that steps bitwise as the original.
The update from the kernel's idx and counts against the plain version's
is a ``cuda`` test in ``tests/test_torch_vq.py`` (it needs no JAX).
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vq_seg_tpu.losses import make_loss as jax_make_loss
from vq_seg_tpu.models.modules.vector_quantizer import VectorQuantizer as JaxVQ
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import cps as jcps
from vq_seg_tpu.training import selfsup as jselfsup
from vq_seg_tpu.training import supervised as jsup
from vq_seg_tpu.utils import ckpoints as jck
from _port_helpers import jax_f64, nchw, nhwc, port_f64, rel, to_np, wide
from _seeded_flax import seeded_variables
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.models.modules.vector_quantizer import (VectorQuantizer, ema_updates,
                                                              make_vq_module)
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.ops.kmeans import l2norm
from vq_seg_tpu_torch.training import (cps, create_cps_state, make_cps_train_step,
                                       make_plain_cps_train_step, selfsup)
from vq_seg_tpu_torch.training.supervised import TrainState, _adam, make_sup_train_step
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import cps_state_from_flax, state_dict_from_flax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import jax_ckpt_to_port  # noqa: E402

torch.set_num_threads(1)

HW, B, TH = 64, 2, 0.7
NUM_EMB = [0, 0, 8, 8, 8]
RTOL, ATOL = 1e-5, 1e-6
EMA_STATE = ("embedding", "cluster_size", "embed_avg")


def _port_vq(jvars, **kw):
    vq = VectorQuantizer(**kw)
    vq.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jvars["codebook"].items()})
    return vq


def _jax_vq_init(jvq, x):
    v = jvq.init(jax.random.PRNGKey(0), x)
    _, mut = jvq.apply(v, x, train=True, init_codebook=True, mutable=["codebook"],
                       rngs={"kmeans": jax.random.PRNGKey(1)})
    return {**v, **mut}


def _assert_state(vq, jcodebook, msg=""):
    for key in EMA_STATE:
        np.testing.assert_allclose(getattr(vq, key).numpy(), np.asarray(jcodebook[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{msg}{key}")


# -- the module alone ---------------------------------------------------------------------


@pytest.mark.parametrize("restart", [0.0, 0.95])
@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_ema_forwards_match_jax(distance, restart):
    rng = np.random.default_rng(0)
    k, c = 16, 8
    kw = dict(num_embeddings=k, kmeans_init=True, ema=True, decay=0.7, distance=distance,
              restart_threshold=restart)
    xs = [(rng.standard_normal((2, 4, 4, c)) + 0.3 * i).astype(np.float32) for i in range(4)]
    jvq = JaxVQ(dim=c, **kw)
    jv = to_np(_jax_vq_init(jvq, jnp.asarray(xs[0])))
    vq = _port_vq(jv, dim=c, **kw).train()
    revived = 0
    for i, x in enumerate(xs[1:]):
        (jq, jidx, jloss, jusage), mut = jvq.apply(jv, jnp.asarray(x), train=True,
                                                   mutable=["codebook"])
        with ema_updates():
            q, idx, loss, usage = vq(nchw(x), train=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx), err_msg=f"forward {i}")
        counts = np.bincount(idx.numpy().ravel(), minlength=k)
        np.testing.assert_array_equal(counts, np.bincount(np.asarray(jidx).ravel(), minlength=k))
        np.testing.assert_allclose(usage.item(), float(jusage), rtol=1e-6)
        np.testing.assert_allclose(nhwc(q), np.asarray(jq), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        jcb = to_np(mut["codebook"])
        _assert_state(vq, jcb, f"forward {i}: ")
        blend = np.float32(0.7) * jv["codebook"]["cluster_size"] + np.float32(0.3) * counts
        dead = blend < restart
        np.testing.assert_array_equal(jcb["cluster_size"][dead], 1.0)
        revived += int(dead.sum())
        if restart:  # a revived code is a row of this forward's features, bitwise
            rows = x.reshape(-1, c)
            if distance == "cosine":
                rows = l2norm(torch.from_numpy(rows)).numpy()
            for j in np.flatnonzero(dead):
                assert (rows == vq.embedding[j].numpy()).all(-1).any(), j
                np.testing.assert_array_equal(vq.embedding[j].numpy(), jcb["embedding"][j])
        if distance == "cosine":
            np.testing.assert_allclose(np.linalg.norm(vq.embedding.numpy(), axis=-1), 1.0,
                                       atol=1e-5)
        jv = {**jv, "codebook": jcb}
    assert (revived > 0) == (restart > 0)


@pytest.mark.parametrize("case", ["duplicate-rows", "equal-norms"])
def test_restart_ties_follow_top_k(case):
    """Every code dead (threshold above any cluster size), all codes at the
    origin: each row's residual is its squared norm, and code j takes the
    row of rank j % min(K, N).  Integer rows make the ties exact."""
    k, c = 12, 4
    base = np.array([[1, 2, 0, 0], [2, 1, 0, 0], [0, 0, 3, 0], [0, 2, 1, 0], [1, 0, 0, 2],
                     [0, 0, 0, 1], [3, 0, 0, 0], [0, 1, 2, 0]], np.float32)
    rows = np.concatenate([base, base[:4]]) if case == "duplicate-rows" else base
    x = np.zeros((1, 1, len(rows), c), np.float32)
    x[0, 0] = rows
    kw = dict(num_embeddings=k, ema=True, restart_threshold=1e6)
    jvq = JaxVQ(dim=c, **kw)
    jv = to_np(jvq.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv["codebook"] = {"embedding": np.zeros((k, c), np.float32),
                      "cluster_size": np.ones(k, np.float32),
                      "embed_avg": np.zeros((k, c), np.float32)}
    _, mut = jvq.apply(jv, jnp.asarray(x), train=True, mutable=["codebook"])
    jcb = to_np(mut["codebook"])
    vq = _port_vq(jv, dim=c, **kw).train()
    with ema_updates():
        vq(nchw(x), train=True)
    err = (rows ** 2).sum(-1)
    order = np.argsort(-err, kind="stable")  # largest first, the lower row among equals
    want = rows[order[np.arange(k) % len(rows)]]
    np.testing.assert_array_equal(vq.embedding.numpy(), want)
    np.testing.assert_array_equal(jcb["embedding"], want)
    np.testing.assert_array_equal(vq.embed_avg.numpy(), jcb["embed_avg"])
    np.testing.assert_array_equal(vq.cluster_size.numpy(), np.ones(k, np.float32))


@pytest.mark.parametrize("path", ["eval", "init-phase", "outside-the-gate", "ema-off"])
def test_frozen_paths(path):
    rng = np.random.default_rng(1)
    c = 8
    x = torch.from_numpy(rng.standard_normal((2, c, 4, 4)).astype(np.float32))
    ema = path != "ema-off"
    vq = VectorQuantizer(c, 8, kmeans_init=True, ema=ema)
    vq.init_codebook_(x, torch.Generator().manual_seed(0))
    if ema:
        np.testing.assert_array_equal(vq.cluster_size.numpy(), np.ones(8, np.float32))
        assert torch.equal(vq.embed_avg, vq.embedding)
    before = {key: t.clone() for key, t in vq.state_dict().items()}
    x2 = x + 0.5
    with ema_updates():
        if path == "eval":
            vq(x2, train=False)
        elif path == "init-phase":  # the k-means runs, the EMA does not
            vq(x2, train=True, init_codebook=True, generator=torch.Generator().manual_seed(1))
            np.testing.assert_array_equal(vq.cluster_size.numpy(), np.ones(8, np.float32))
            assert torch.equal(vq.embed_avg, vq.embedding)
            assert not torch.equal(vq.embedding, before["embedding"])
            before = {key: t.clone() for key, t in vq.state_dict().items()}
        elif path == "ema-off":
            vq(x2, train=True)
    if path == "outside-the-gate":
        vq(x2, train=True)
    for key, t in vq.state_dict().items():
        assert torch.equal(t, before[key]), key
    if path == "ema-off":
        plain = make_vq_module({"num_embeddings": [0, 8]}, [3, 8, 8], 2)
        off = make_vq_module({"num_embeddings": [0, 8], "ema": False}, [3, 8, 8], 2)
        assert list(off.state_dict()) == list(plain.state_dict()) == ["1.embedding"]
    with pytest.raises(ValueError, match="restart_threshold requires ema"):
        VectorQuantizer(c, 8, restart_threshold=0.5)


def _vqvae_cfg(name):
    return {"name": name, "params": {"encoder_name": "resnet18", "vq_cfg": {
        "num_embeddings": NUM_EMB, "kmeans_init": True, "ema": True, "decay": 0.8,
        "restart_threshold": 0.9}}}


def _with_ema_state(v):
    """seeded variables with the EMA state as the init leaves it."""
    for tree in jax.tree_util.tree_leaves(v["codebook"], is_leaf=lambda t: "embedding" in t):
        if "cluster_size" in tree:
            tree["cluster_size"] = np.ones_like(tree["cluster_size"])
            tree["embed_avg"] = tree["embedding"].copy()
    return v


@pytest.mark.parametrize("name", ["vqvaev1", "vqvaev2"])
def test_selfsup_step_updates_where_jax_does(name):
    """Under ``ema: true`` JAX's ``vqvaev1`` builds its codebook with six
    knobs only, so its step leaves it frozen; ``vqvaev2``'s moves."""
    x = np.random.default_rng(3).uniform(size=(2, HW, HW, 3)).astype(np.float32)
    cfg = _vqvae_cfg(name)
    jmodel = jax_make_model(cfg)
    v = _with_ema_state(to_np(seeded_variables(jmodel, (jnp.asarray(x),), train=True)))
    tx = optax.sgd(0.0)
    jstate = jsup.TrainState(variables=v, opt_state=tx.init(v["params"]), step=0)
    jnew, jm, _ = jselfsup.make_selfsup_train_step(jmodel, tx)(
        jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(x))
    jnew = to_np(jnew)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    before = {key: t.clone() for key, t in model.state_dict().items()}
    st = TrainState(model.train(), _adam(model.parameters()), lambda s: 0.0)
    _, m, _ = selfsup.make_selfsup_train_step()(st, nchw(x))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    want = state_dict_from_flax(jnew.variables, NUM_EMB)
    keys = [key for key in before if "codebook" in key]
    assert keys
    for key in keys:
        if name == "vqvaev1":
            assert key == "codebook.embedding"
            assert torch.equal(model.state_dict()[key], before[key])
            np.testing.assert_array_equal(want[key].numpy(), before[key].numpy())
        else:
            assert not torch.equal(model.state_dict()[key], before[key]) or "cluster" in key
            assert rel(model.state_dict()[key].numpy(), want[key].numpy()) <= RTOL, key


def test_plaincps_step_keeps_ema_codebooks_frozen():
    """The ``variants.py`` steps apply with ``batch_stats`` mutable only in
    the JAX package: under ``ema: true`` their codebooks stay as they are."""
    cfg = {"name": "vqcanet", "params": {"encoder_name": "resnet18", "num_classes": 3,
           "vq_cfg": {"num_embeddings": NUM_EMB, "kmeans_init": True, "ema": True,
                      "restart_threshold": 0.9}}}
    st = create_cps_state(cfg, lambda s: 1e-4, device="cpu")
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(size=(B, 3, HW, HW)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 3, size=(B, HW, HW)))
    before = [{k: t.clone() for k, t in m.state_dict().items() if "codebooks" in k}
              for m in (st.model_1, st.model_2)]
    assert any(k.endswith("cluster_size") for k in before[0])
    make_plain_cps_train_step(num_classes=3)(st, img, lab, img.flip(-1))
    for m, old in zip((st.model_1, st.model_2), before):
        for key, t in old.items():
            assert torch.equal(m.state_dict()[key], t), key


# -- the flagship CPS step, sup and the checkpoints -----------------------------------------

MODEL_CFG = {"name": "vqreptunet1x1v2", "params": {
    "encoder_name": "resnet18", "num_classes": 3,
    "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True,
               "ema": True, "restart_threshold": 0.9},
    "margin": 0.5, "scale": 30.0}}
STEP_KW = dict(num_classes=3, confidence_threshold=TH, cps_loss_weight=1.0,
               commitment_loss_weight=1.0, prototype_loss_weight=0.01)
LOSSES = ("loss", "cps_loss", "sup_loss_1", "sup_loss_2", "commitment_loss", "prototype_loss")


def _batch(rng):
    img = rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)
    lab = ((np.arange(HW)[None, :, None] // 8 + rng.integers(0, 2, size=(B, HW, HW))) % 3)
    return img, lab.astype(np.int32), rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)


def _gradient_tx():
    """Updates nothing and keeps the last gradient as its state."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)
    return optax.GradientTransformation(zeros, lambda g, s, params=None: (zeros(g), g))


@pytest.fixture(scope="module")
def flagship():
    """JAX's post-init state of the EMA flagship and its states after each of
    2 steps (numpy leaves), in f32 and in f64, with the batches."""
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in range(2)]
    l_img, l_t, _ = batches[0]
    jmodel = jax_make_model(MODEL_CFG)
    tx = _gradient_tx()
    pre = jax.jit(lambda x, gt: jcps.create_cps_state(jmodel, tx, (x, gt, TH)))(
        jnp.asarray(l_img), jnp.asarray(l_t))
    post = to_np(jax.jit(lambda s, x, gt: jcps.cps_init_phase(jmodel, s, x, gt, TH))(
        pre, jnp.asarray(l_img), jnp.asarray(l_t)))
    out = {}
    for dtype in (np.float32, np.float64):
        with jax_f64() if dtype == np.float64 else contextlib.nullcontext():
            step = jcps.make_cps_train_step(
                jmodel, tx, jax_make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)
            state = post if dtype == np.float32 else wide(post)
            states, metrics = [state], []
            for l_img, l_t, ul in batches:
                state, m, _, _ = step(jax.tree_util.tree_map(jnp.asarray, state),
                                      jnp.asarray(l_img.astype(dtype)), jnp.asarray(l_t),
                                      jnp.asarray(ul.astype(dtype)))
                state = to_np(state)
                states.append(state)
                metrics.append(to_np(m))
        out[dtype] = dict(states=states, metrics=metrics)
    assert out[np.float64]["states"][1].variables_1["codebook"]["core"][
        "VectorQuantizer_0"]["embed_avg"].dtype == np.float64
    return dict(f32=out[np.float32], f64=out[np.float64], batches=batches)


def _port_state(jstate, **kw):
    st = create_cps_state(MODEL_CFG, lambda s: 0.0, device="cpu", **kw)
    return cps_state_from_flax(st, jstate, NUM_EMB)


def _run(st, batches, dtype=torch.float32):
    step = make_cps_train_step(make_loss("dice_loss", 3, ignore_index=255), **STEP_KW)
    out = []
    for l_img, l_t, ul in batches:
        _, m, _, _ = step(st, nchw(l_img).to(dtype), torch.from_numpy(l_t).long(),
                          nchw(ul).to(dtype))
        out.append(({k: m[k].numpy() for k in LOSSES},
                    [{k: t.clone() for k, t in mm.state_dict().items()}
                     for mm in (st.model_1, st.model_2)]))
    return out


def _run64(jstate, batches):
    with port_f64():
        st = _port_state(jstate)
        st.model_1.double()
        st.model_2.double()
        return _run(st, batches, torch.float64)


def _codebook_state(jstate):
    return [{k: t for k, t in state_dict_from_flax(v, NUM_EMB).items()
             if k.startswith("core.codebooks.")}
            for v in (jstate.variables_1, jstate.variables_2)]


def _assert_models(sds, sds64, j32, j64, msg):
    """BN running stats of the f32 runs within 1e-5; the codebooks and their
    EMA state of the f64 runs within 1e-6 relative L2, and of the f32 runs
    within 1e-5 of JAX's f64 plus JAX's own f32 distance there; the codes
    revived equal (their cluster sizes reset to 1)."""
    for sd, sd64, jv, want32, want64 in zip(sds, sds64, (j32.variables_1, j32.variables_2),
                                            _codebook_state(j32), _codebook_state(j64)):
        want = state_dict_from_flax(jv, NUM_EMB)
        for key, t in sd.items():
            if "running" in key:
                np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=f"{msg}: {key}")
        for key, w64 in want64.items():
            w64, w32 = w64.numpy(), want32[key].numpy()
            assert rel(sd64[key].numpy(), w64) <= 1e-6, f"{msg}: {key}"
            assert rel(sd[key].numpy(), w64) <= RTOL + rel(w32, w64), f"{msg}: {key}"
            if key.endswith("cluster_size"):
                np.testing.assert_array_equal(sd[key].numpy() == 1.0, w32 == 1.0,
                                              err_msg=f"{msg}: {key}")


def test_flagship_cps_steps_match_jax(flagship):
    j32, j64 = flagship["f32"], flagship["f64"]
    out = _run(_port_state(j32["states"][0]), flagship["batches"])
    out64 = _run64(j32["states"][0], flagship["batches"])
    revived = 0
    for i, ((m, sds), (_, sds64), jm) in enumerate(zip(out, out64, j32["metrics"])):
        for key in LOSSES:
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i}: {key}")
        _assert_models(sds, sds64, j32["states"][i + 1], j64["states"][i + 1], f"step {i}")
        for sd, old in zip(sds, _codebook_state(j32["states"][i])):
            for key in old:
                if key.endswith("embedding"):
                    assert not torch.equal(sd[key], old[key]), key  # every codebook moves
            revived += sum(int((sd[key] == 1.0).sum()) for key in old
                           if key.endswith("cluster_size"))
    assert revived > 0


def test_accumulated_micro_step_updates_the_codebooks(flagship):
    j32, j64 = flagship["f32"], flagship["f64"]
    st = _port_state(j32["states"][0], grad_accum_steps=2)
    params = [{n: p.detach().clone() for n, p in m.named_parameters()}
              for m in (st.model_1, st.model_2)]
    [(_, sds)] = _run(st, flagship["batches"][:1])
    assert st.opt_1.mini_step == 1
    [(_, sds64)] = _run64(j32["states"][0], flagship["batches"][:1])
    _assert_models(sds, sds64, j32["states"][1], j64["states"][1], "micro-step")
    for mm, old in zip((st.model_1, st.model_2), params):
        for name, p in mm.named_parameters():
            assert torch.equal(p, old[name]), name


def test_sup_step_with_ema_matches_jax():
    cfg = {"name": "vqunet_v2", "params": {"encoder_name": "resnet18", "num_classes": 3,
           "vq_cfg": {"num_embeddings": NUM_EMB, "kmeans_init": True, "ema": True,
                      "restart_threshold": 0.9}}}
    rng = np.random.default_rng(5)
    img, lab, _ = _batch(rng)
    jmodel = jax_make_model(cfg)
    v = _with_ema_state(to_np(seeded_variables(jmodel, (jnp.asarray(img),), train=True)))
    tx = optax.sgd(0.0)
    jstate = jsup.TrainState(variables=v, opt_state=tx.init(v["params"]), step=0)
    dice = "dice_loss"
    jstep = jsup.make_sup_train_step(jmodel, tx, jax_make_loss(dice, 3, ignore_index=255),
                                     num_classes=3, forward_mode="plain")
    jnew, jm = jstep(jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(img),
                     jnp.asarray(lab), 0.0)[:2]
    jnew, jm = to_np(jnew), to_np(jm)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    st = TrainState(model, _adam(model.parameters()), lambda s: 0.0)
    step = make_sup_train_step(make_loss(dice, 3, ignore_index=255), num_classes=3,
                               forward_mode="plain")
    _, m, _ = step(st, nchw(img), torch.from_numpy(lab).long(), 0.0)
    for key in ("loss", "sup_loss", "commitment_loss"):
        np.testing.assert_allclose(m[key].numpy(), jm[key], rtol=1e-4, err_msg=key)
    want = state_dict_from_flax(jnew.variables, NUM_EMB)
    old = state_dict_from_flax(v, NUM_EMB)
    moved = 0
    for key, t in model.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        if "codebooks" in key:
            assert rel(t.numpy(), want[key].numpy()) <= RTOL, key
            moved += not torch.equal(t, old[key])
    assert moved >= 6


def test_ema_state_through_the_checkpoint_tool_and_a_port_resume(flagship, tmp_path):
    jstate = flagship["f32"]["states"][2]
    jpath = str(tmp_path / "last.ckpt")
    jck.save_ckpoints(jstate.variables_1, jstate.variables_2, 0, 1, jstate.opt_state_1,
                      jstate.opt_state_2, jpath, async_save=False, include_optimizers=False)
    dst = str(tmp_path / "port.ckpt")
    jax_ckpt_to_port.convert(jpath, dst, MODEL_CFG)
    ck = ckpoints.load_full(dst)
    st = create_cps_state(MODEL_CFG, lambda s: 0.0, device="cpu")
    cps.restore_cps_state(st, ck)
    for model, jv in ((st.model_1, jstate.variables_1), (st.model_2, jstate.variables_2)):
        want = state_dict_from_flax(jv, NUM_EMB)
        keys = [k for k in want if k.startswith("core.codebooks.")]
        assert {k.rsplit(".", 1)[1] for k in keys} == set(EMA_STATE)
        for key in keys:
            np.testing.assert_array_equal(model.state_dict()[key].numpy(), want[key].numpy(),
                                          err_msg=key)
    # the port's own contract: a fresh state restored from it steps bitwise
    # as the state that wrote it, EMA state included
    path = str(tmp_path / "resumed.ckpt")
    ckpoints.save_ckpoints(st.model_1, st.model_2, 1, 0, st.opt_1, st.opt_2, path)
    ckpoints.wait_for_saves()
    fresh = create_cps_state(MODEL_CFG, lambda s: 0.0, device="cpu")
    cps.restore_cps_state(fresh, ckpoints.load_full(path))
    [(_, a)] = _run(st, flagship["batches"][:1])
    [(_, b)] = _run(fresh, flagship["batches"][:1])
    for sa, sb in zip(a, b):
        for key, t in sa.items():
            assert torch.equal(t, sb[key]), key
