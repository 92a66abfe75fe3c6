"""Port parity: the ``unimatch`` mode (``UniMatch`` on the DeepLab v3+
decoder, its step and its driver) against the JAX package, on the CPU at
resnet18 / 64x64, batch 2 labeled + 2 unlabeled (helpers in
``_slice_parity.py`` and ``_port_helpers.py``).  No shipped config has the
mode: ``config/semiweednet.json`` with the network swapped
(``_slice_parity.unimatch_cfg``).

The port starts from JAX's variables (drawn from a numpy seed, or the JAX
driver's own init), mapped by ``state_dict_from_flax``.  The dropout takes
the masks flax drew (``record_dropout``) and CutMix the boxes JAX drew from
the step's key.  JAX hands one dropout key to the step's four passes, so
the ASPP draws one mask for the labeled pass and both mixes (batch 2) and
another for the ``need_fp`` pass (batch 4); the test checks that the
recorded masks show exactly that.

Bounds:
  * the eval forward within 1e-5 relative L2; the ``need_fp`` train
    forward (batch statistics over as few as 2 x 2 x 2 values per channel,
    ill-conditioned in f32) in f64 in both packages within 1e-7 (the JAX
    package's x4 align-corners upsample keeps f32 lerp weights in f64), in
    f32 within 1e-5 plus twice JAX's own f32 error of JAX's f64, both
    outputs and every running statistic;
  * one step (the JAX driver's own compiled step, its key): the loss terms
    and the gradients in f64 in both packages (JAX's f64 step replaying
    the f32 step's masks and boxes) within 1e-7 and 1e-6 relative; in f32
    the loss terms within 1e-5 plus twice JAX's own f32 error, the IoUs
    within 1e-3 (a few pixels); the f32 gradients, which turn on
    pseudo-labels thresholded at 0.95 and argmaxes that f32 rounding can
    flip, are not compared.  The head's kernel is scaled 150x so that the
    teacher is confident on part of the batch (at the drawn scale its
    softmax never reaches 0.95 and the three unlabeled terms are 0);
  * one driver epoch of ``train_unimatch`` against JAX's on the same PNG
    tree with JAX's boxes and masks: epoch averages within 1e-3 relative
    (mIoU 1e-3 absolute), the same run directory, log keys and
    ``last.ckpt`` = ``{model_1, epoch, optimizer_1}``.
"""
import copy
import json
import os
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.data.augmentations import make_cutout_mask as jax_cutout
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import variants as jvariants
from vq_seg_tpu.utils import ckpoints as jck
from _port_helpers import (MASKS, jax_f64, nchw, nhwc, port_f64, record_dropout, rel,
                           replay_dropout, take_masks, to_np, wide)
from _seeded_flax import seeded_variables
from _slice_parity import jax_f64_one_model_step, run_jax, run_port, unimatch_cfg
from _vqpt_parity import _batch, _listing
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.training.supervised import TrainState, _adam
from vq_seg_tpu_torch.training.variants import make_unimatch_train_step
from vq_seg_tpu_torch.utils import ckpoints, convert
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

PARAMS = {"encoder_name": "resnet18", "num_classes": 3, "depth": 5}
TERMS = ("loss", "sup_loss", "loss_u_1", "loss_u_2", "loss_u_fp")


def _queue(masks):
    return lambda shape: masks.pop(0)


def _by_shape(masks):
    table = {tuple(m.shape): m for m in masks}
    return lambda shape: table[tuple(shape)]


def test_forward_with_and_without_fp_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = jax_make_model({"name": "unimatch", "params": PARAMS})
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x),), train=True))
    model = make_model({"name": "unimatch", "params": PARAMS}, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, None))
    want, jnone = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got, none = model.eval()(nchw(x))
    assert jnone is None and none is None and nhwc(got).shape == (2, 64, 64, 3)
    assert rel(nhwc(got), want) <= 1e-5

    def jtrain(vv, xx):
        return jmodel.apply(vv, xx, need_fp=True, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(3)})

    MASKS.clear()
    with record_dropout():
        (j32, j32_fp), mut32 = jax.jit(jtrain)(v, jnp.asarray(x))
        jax.effects_barrier()
    masks = take_masks(3)
    # the perturbation's two masks (feats[1], feats[-1]), then the ASPP's over 2N
    assert [tuple(m.shape) for m in masks] == [(2, 64, 32, 32), (2, 512, 4, 4), (4, 256, 4, 4)]
    with jax_f64(), replay_dropout([nhwc(m) for m in masks]):
        (j64, j64_fp), mut64 = jax.jit(jtrain)(wide(v), jnp.asarray(x, jnp.float64))
    with torch.no_grad():
        got32 = model.train()(nchw(x), need_fp=True, train=True,
                              dropout=_by_shape(masks[2:]), fp_dropout=_queue(masks[:2]))
    stats32 = {k: t.clone() for k, t in model.state_dict().items() if "running" in k}
    model.load_state_dict(state_dict_from_flax(v, None))
    model.double()
    with torch.no_grad(), port_f64():
        got64 = model.train()(nchw(x).double(), need_fp=True, train=True,
                              dropout=_by_shape([m for m in masks[2:]]),
                              fp_dropout=_queue(list(masks[:2])))
    for g32, g64, w32, w64 in zip(got32, got64, (j32, j32_fp), (j64, j64_fp)):
        assert nhwc(g32).shape == (2, 64, 64, 3)
        assert rel(nhwc(g64), w64) <= 1e-7
        assert rel(nhwc(g32), w64) <= 1e-5 + 2 * rel(w32, w64)
    want32 = state_dict_from_flax({**v, "batch_stats": to_np(mut32["batch_stats"])}, None)
    with mock.patch.object(convert, "_t", lambda a: torch.tensor(np.asarray(a, np.float64))):
        want64 = state_dict_from_flax({**wide(v), "batch_stats": to_np(mut64["batch_stats"])},
                                      None)
    sd64 = model.state_dict()
    for key, t in stats32.items():
        w64 = want64[key].numpy()
        assert rel(sd64[key].numpy(), w64) <= 1e-7, key
        assert rel(t.numpy(), w64) <= 1e-5 + 2 * rel(want32[key].numpy(), w64), key


def _step_masks(masks):
    """A JAX step's six recorded masks (ASPP of the labeled pass; the
    perturbation's two and the ASPP's of the fp pass; the ASPP's of the
    two mixes) as the port step's ``dropout`` and ``fp_dropout``."""
    assert [tuple(m.shape)[0] for m in masks] == [2, 2, 2, 4, 2, 2]
    # one key for the four passes: the same ASPP mask wherever the shape repeats
    assert torch.equal(masks[0], masks[4]) and torch.equal(masks[0], masks[5])
    return _by_shape([masks[0], masks[3]]), _queue([masks[1], masks[2]])


def _boxes(key, hw):
    k1, k2, _ = jax.random.split(jnp.asarray(key), 3)
    return [torch.from_numpy(np.asarray(jax_cutout(k, hw, 0.5))) for k in (k1, k2)]


@pytest.fixture(scope="module")
def unimatch_runs(synthetic_dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("unimatch")
    captured = {}
    MASKS.clear()
    with record_dropout():
        run_jax("train_unimatch", "make_unimatch_train_step",
                unimatch_cfg(synthetic_dataset, str(base / "jax")), captured)
        jax.effects_barrier()
    steps_masks = [take_masks(6) for _ in range(2)]
    assert not MASKS  # the teacher and the evaluation draw none
    keys = [np.asarray(extra[0]) for extra in captured["extra"]]

    def draws(cfg, device):
        queue = [(*_boxes(k, (64, 64)), *_step_masks(m)) for k, m in zip(keys, steps_masks)]
        return lambda hw: queue.pop(0)

    def state(cfg, schedule, device):
        model = make_model(cfg.model, device="cpu")
        model.load_state_dict(state_dict_from_flax(captured["post"].variables, None))
        return TrainState(model.train(), _adam(model.parameters()), schedule)

    port_state, history, _ = run_port(
        "train_unimatch", unimatch_cfg(synthetic_dataset, str(base / "port")), captured,
        patches={"unimatch_draws": draws, "unimatch_state": state})
    yield dict(state=port_state, history=history, captured=captured, base=base,
               jax_run=str(base / "jax" / "unimatch_unimatch_0"),
               port_run=str(base / "port" / "unimatch_unimatch_0"))
    shutil.rmtree(base, ignore_errors=True)


def test_one_unimatch_step_matches_jax(unimatch_runs):
    post = copy.deepcopy(unimatch_runs["captured"]["post"])
    # the head's kernel 150 times its drawn scale makes the eval-mode teacher
    # confident (softmax above 0.95) on about 2/3 of the pixels, so every
    # term of the loss is exercised (at the drawn scale none is)
    head = post.variables["params"]["segmentation_head"]["ConvPad_0"]["Conv_0"]
    head["kernel"] = head["kernel"] * np.float32(150)
    l_img, l_t, ul = _batch(8)
    key = jax.random.PRNGKey(7)
    MASKS.clear()
    with record_dropout():
        _, jm = unimatch_runs["captured"]["step"](
            jax.tree_util.tree_map(jnp.asarray, post), jnp.asarray(l_img), jnp.asarray(l_t),
            jnp.asarray(ul), key)
        jax.effects_barrier()
    masks = take_masks(6)
    jm = to_np(jm)
    boxes = _boxes(key, (64, 64))
    jmodel = jax_make_model({"name": "unimatch", "params": PARAMS})
    # JAX's f64 step draws other boxes under x64 (int64 randint): it takes the f32 ones
    box_queue = [jnp.asarray(b.numpy()) for b in boxes]
    with mock.patch.object(jvariants, "make_cutout_mask", lambda *a: box_queue.pop(0)):
        jnew64, jm64 = jax_f64_one_model_step(
            lambda tx: jvariants.make_unimatch_train_step(jmodel, tx, num_classes=3), post,
            (l_img, l_t, ul, np.asarray(key)), replay=[nhwc(m) for m in masks])
    assert not box_queue
    assert all(float(jm[k]) > 0 for k in TERMS)  # every term sees confident pixels

    def port(dtype):
        model = make_model({"name": "unimatch", "params": PARAMS}, device="cpu")
        model.load_state_dict(state_dict_from_flax(post.variables, None))
        model.to(dtype)
        st = TrainState(model.train(), _adam(model.parameters()), lambda s: 0.0)
        step = make_unimatch_train_step(num_classes=3)
        cast = lambda t: t.to(dtype)
        with port_f64():
            _, m = step(st, cast(nchw(l_img)), torch.from_numpy(l_t).long(), cast(nchw(ul)),
                        *boxes, *_step_masks(masks))
        return st, m

    st, m = port(torch.float32)
    st64, m64 = port(torch.float64)
    for k in TERMS:
        want64 = float(jm64[k])
        assert abs(float(m64[k]) / want64 - 1) <= 1e-7, k
        own = abs(float(jm[k]) / want64 - 1)
        assert abs(float(m[k]) / want64 - 1) <= 1e-5 + 2 * own, k
    # the IoUs: f64 exactly as JAX's f64; f32 within a few of the 8192
    # pixels (the argmax of 150x logits flips between any two f32 sums)
    np.testing.assert_allclose(m64["iou_list"].numpy(), jm64["iou_list"], atol=1e-9)
    np.testing.assert_allclose(m["iou_list"].numpy(), jm["iou_list"], atol=1e-3)
    with mock.patch.object(convert, "_t", lambda a: torch.tensor(np.asarray(a, np.float64))):
        want64 = state_dict_from_flax({**wide(post.variables), "params": jnew64.opt_state},
                                      None)
    for name, p in st64.model.named_parameters():
        assert rel(p.grad.numpy(), want64[name].numpy()) <= 1e-6, name
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in st.model.parameters())
    assert st.step == 1


def test_unimatch_driver_epoch_matches_jax(unimatch_runs):
    jrun, prun = unimatch_runs["jax_run"], unimatch_runs["port_run"]
    log = os.path.basename(prun) + ".jsonl"
    assert _listing(jrun) == _listing(prun) == sorted(
        ["ckpoints", "ckpoints/last.ckpt", "log_txt", log])
    [jrec] = [json.loads(line) for line in open(os.path.join(jrun, log))]
    [rec] = [json.loads(line) for line in open(os.path.join(prun, log))]
    assert set(rec) == set(jrec) >= set(TERMS) | {"miou"}
    for k in rec:
        tol = dict(atol=1e-3) if k == "miou" else dict(rtol=1e-3, atol=1e-9)
        np.testing.assert_allclose(rec[k], jrec[k], err_msg=k, **tol)
    [line] = open(os.path.join(prun, "log_txt")).read().splitlines()
    assert line.startswith("[unimatch][Epoch0] ")
    ck = ckpoints.load_full(os.path.join(prun, "ckpoints", "last.ckpt"))
    jckpt = jck.load_full(os.path.join(jrun, "ckpoints", "last.ckpt"))
    assert set(ck) == set(jckpt) == {"model_1", "epoch", "optimizer_1"} and ck["epoch"] == 0
    [h] = unimatch_runs["history"]
    assert h["step"] == 2 and 0.0 <= h["test_miou"] <= 1.0 and h["ckpt_files"] == ["last.ckpt"]
