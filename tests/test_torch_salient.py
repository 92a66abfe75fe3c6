"""Port parity: the ``salientcps`` mode (``SalientDataset``,
``VQUnetwithSalientloss``, its step and its driver) against the JAX
package, on the CPU at resnet18 / K=8 / 64x64, batch 2 labeled + 2
unlabeled (helpers in ``_slice_parity.py``, ``_vqpt_parity.py`` and
``_port_helpers.py``).  No shipped config has the mode:
``config/vqreptunet1x1v2.json``'s encoder and ``vq_cfg`` with the network
swapped (``_slice_parity.salient_cfg``); the saliency maps are the port's
``get_saliency_rbd`` of the inputs (``write_saliency``).

The port starts from JAX's variables (drawn from a numpy seed, or the JAX
driver's own init and init phase), mapped by ``state_dict_from_flax``.

Bounds:
  * ``SalientDataset`` items equal JAX's byte for byte, maps included;
  * the eval forward (logits, commitment, usage) within 1e-5 relative L2;
    the train forward with its saliency map (batch statistics over as few
    as 2 x 2 x 2 values per channel, ill-conditioned in f32) in f64 in
    both packages within 1e-7 (the JAX package's x2 align-corners upsample
    keeps f32 lerp weights in f64), in f32 within 1e-5 plus twice JAX's
    own f32 error of JAX's f64, outputs and running statistics alike;
  * ``salient_loss``'s nearest resize is ``jax.image.resize(...,
    "nearest")``, exactly;
  * one step (the JAX driver's own compiled step): every loss term within
    1e-5 relative in f32; the gradients in f64 in both packages within
    1e-6 (the f32 ones turn on the CPS argmaxes, which f32 rounding can
    flip, and are not compared); codebooks bitwise unchanged;
  * one driver epoch of ``train_salient_cps`` against JAX's on the same PNG
    tree and maps: epoch averages within 1e-3 relative (mIoU 1e-3
    absolute), the same run directory, log keys and checkpoint contract.
"""
import os
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.data import SalientDataset as JaxSalientDataset
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import variants as jvariants
from _port_helpers import jax_f64, nchw, nhwc, port_f64, rel, to_np, wide
from _seeded_flax import seeded_variables
from _slice_parity import run_jax, run_port, salient_cfg, write_saliency
from _vqpt_parity import _check_epoch, _jax_f64_step
from vq_seg_tpu_torch.data import SalientDataset, fastimg
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.training.cps import CPSTrainState, _adam
from vq_seg_tpu_torch.training.variants import make_salient_cps_train_step, salient_loss
from vq_seg_tpu_torch.utils import convert
from vq_seg_tpu_torch.utils.convert import cps_state_from_flax, state_dict_from_flax

torch.set_num_threads(1)

NUM_EMB = [0, 0, 8, 8, 8]
PARAMS = {"encoder_name": "resnet18", "num_classes": 3,
          "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True}}
TERMS = ("loss", "cps_loss", "salient_loss", "commitment_loss")


@pytest.fixture(scope="module")
def maps(synthetic_dataset, tmp_path_factory):
    return write_saliency(synthetic_dataset, str(tmp_path_factory.mktemp("salient")))


def test_salient_dataset_items_match_jax(synthetic_dataset, maps):
    jfastimg.load()
    fastimg.load()
    root = os.path.join(synthetic_dataset, "train")
    for split in ("labelled", "unlabelled"):
        ds = SalientDataset(root, maps, split, resize=48)
        jds = JaxSalientDataset(root, maps, split, resize=48)
        assert len(ds) == len(jds) == (5 if split == "labelled" else 3)
        for i in range(len(ds)):
            a, b = ds[i], jds[i]
            assert sorted(a) == sorted(b) and a["filename"] == b["filename"]
            for key in a:
                if key != "filename":
                    assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
            assert a["salient_map"].shape == (48, 48) and a["salient_map"].max() <= 1.0


def test_salient_loss_resize_is_jax_nearest():
    rng = np.random.default_rng(4)
    sal_map = rng.random((2, 64, 64)).astype(np.float32)
    pred = rng.random((2, 32, 32, 1)).astype(np.float32)
    want = jnp.mean((pred - jax.image.resize(jnp.asarray(sal_map), (2, 32, 32),
                                             method="nearest")[..., None]) ** 2)
    got = salient_loss(nchw(pred), torch.from_numpy(sal_map))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_forward_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = jax_make_model({"name": "VQUnetwithSalientloss", "params": PARAMS})
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x),), train=True))
    model = make_model({"name": "VQUnetwithSalientloss", "params": PARAMS}, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    want = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(nchw(x))
    assert len(got) == len(want) == 3
    assert rel(nhwc(got[0]), want[0]) <= 1e-5
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    jtrain = lambda vv, xx: jmodel.apply(vv, xx, train=True, mutable=["batch_stats"])
    j32, mut32 = jax.jit(jtrain)(v, jnp.asarray(x))
    with jax_f64():
        j64, mut64 = jax.jit(jtrain)(wide(v), jnp.asarray(x, jnp.float64))
    with torch.no_grad():
        got32 = model.train()(nchw(x), train=True)
    stats32 = {k: t.clone() for k, t in model.state_dict().items() if "running" in k}
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    model.double()
    with torch.no_grad(), port_f64():
        got64 = model.train()(nchw(x).double(), train=True)
    assert len(got32) == len(j32) == 4 and tuple(got32[3].shape) == (2, 1, 32, 32)
    for i in (0, 3):  # the logits and the saliency map
        assert rel(nhwc(got64[i]), j64[i]) <= 1e-7
        assert rel(nhwc(got32[i]), j64[i]) <= 1e-5 + 2 * rel(j32[i], j64[i])
    assert abs(float(got64[1]) / float(j64[1]) - 1) <= 1e-7
    want32 = state_dict_from_flax({**v, "batch_stats": to_np(mut32["batch_stats"])}, NUM_EMB)
    with mock.patch.object(convert, "_t", lambda a: torch.tensor(np.asarray(a, np.float64))):
        want64 = state_dict_from_flax({**wide(v), "batch_stats": to_np(mut64["batch_stats"])},
                                      NUM_EMB)
    sd64 = model.state_dict()
    assert any(k.startswith("salient_decoder.3.bn.running") for k in stats32)
    for key, t in stats32.items():
        w64 = want64[key].numpy()
        assert rel(sd64[key].numpy(), w64) <= 1e-7, key
        assert rel(t.numpy(), w64) <= 1e-5 + 2 * rel(want32[key].numpy(), w64), key


@pytest.fixture(scope="module")
def salient_runs(synthetic_dataset, maps, tmp_path_factory):
    base = tmp_path_factory.mktemp("salientcps")
    captured = {}
    run_jax("train_salient_cps", "make_salient_cps_train_step",
            salient_cfg(synthetic_dataset, str(base / "jax"), maps), captured)

    def port_init(state, l_img, l_target):
        return cps_state_from_flax(state, captured["post"], NUM_EMB)

    port_state, history, _ = run_port(
        "train_salient_cps", salient_cfg(synthetic_dataset, str(base / "port"), maps), captured,
        patches={"plain_init_phase": port_init})
    yield dict(state=port_state, history=history, captured=captured,
               jax_run=str(base / "jax" / "salient_salientcps_0"),
               port_run=str(base / "port" / "salient_salientcps_0"))
    shutil.rmtree(base, ignore_errors=True)


def test_one_salient_step_matches_jax(salient_runs):
    post = salient_runs["captured"]["post"]
    rng = np.random.default_rng(8)
    l_img, ul = (rng.standard_normal((2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    l_t = ((np.arange(64)[None, :, None] // 8 + rng.integers(0, 2, (2, 64, 64))) % 3).astype(
        np.int32)
    l_sal, ul_sal = (rng.random((2, 64, 64)).astype(np.float32) for _ in range(2))
    args = (l_img, l_t, l_sal, ul, ul_sal)
    _, jm = salient_runs["captured"]["step"](jax.tree_util.tree_map(jnp.asarray, post),
                                             *[jnp.asarray(a) for a in args])
    jm = to_np(jm)
    jmodel = jax_make_model({"name": "VQUnetwithSalientloss", "params": PARAMS})
    jnew64 = _jax_f64_step(lambda tx: jvariants.make_salient_cps_train_step(
        jmodel, tx, num_classes=3), post, args)

    def port(dtype):
        models = []
        for v in (post.variables_1, post.variables_2):
            m = make_model({"name": "VQUnetwithSalientloss", "params": PARAMS}, device="cpu")
            m.load_state_dict(state_dict_from_flax(v, NUM_EMB))
            models.append(m.to(dtype).train())
        st = CPSTrainState(models[0], models[1], _adam(models[0].parameters()),
                           _adam(models[1].parameters()), lambda s: 0.0)
        cb = {k: t.clone() for k, t in models[0].state_dict().items() if "codebooks" in k}
        cast = lambda a: (nchw(a) if a.ndim == 4 else torch.from_numpy(a)).to(dtype)
        with port_f64():
            _, m = make_salient_cps_train_step(num_classes=3)(
                st, cast(l_img), torch.from_numpy(l_t).long(), cast(l_sal), cast(ul),
                cast(ul_sal))
        assert all(torch.equal(t, models[0].state_dict()[k]) for k, t in cb.items())
        return st, m

    st, m = port(torch.float32)
    st64, m64 = port(torch.float64)
    for k in TERMS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(jm["salient_loss"]) > 0 and float(jm["commitment_loss"]) > 0
    for i, model in enumerate((st64.model_1, st64.model_2)):
        jv = (post.variables_1, post.variables_2)[i]
        with mock.patch.object(convert, "_t", lambda a: torch.tensor(np.asarray(a, np.float64))):
            want64 = state_dict_from_flax(
                {**wide(jv), "params": (jnew64.opt_state_1, jnew64.opt_state_2)[i]}, NUM_EMB)
        for name, p in model.named_parameters():
            w64 = want64[name].numpy()
            if np.abs(w64).max() == 0:  # the codebooks: no gradient
                assert p.grad is None or not p.grad.any(), name
                continue
            assert rel(p.grad.numpy(), w64) <= 1e-6, name
    assert st.step == 1


def test_salient_driver_epoch_matches_jax(salient_runs):
    rec = _check_epoch(salient_runs["jax_run"], salient_runs["port_run"], "salientcps")
    assert set(TERMS) | {"miou"} <= set(rec)
    [h] = salient_runs["history"]
    assert h["step"] == 2 and h["test_miou"] is None  # no evaluation, as the JAX driver
