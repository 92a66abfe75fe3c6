"""Port parity: ``config/obia_CWFID.json``'s path, the VGG encoders,
``fcn32s``, the VGG ``.pth`` conversion, ``OBIADataset`` and the ``sup``
driver on an OBIA tree, against the JAX package on the CPU (helpers in
``_port_helpers.py``).

The port starts from JAX's variables (drawn from a numpy seed,
``_seeded_flax``), mapped by ``utils/convert.py``.  ``fcn32s``'s ``fc6`` is
a VALID 7x7 conv on the stride-32 feature, so its inputs are 224x224 (the
least size it takes); its encoder is ``vgg11``, batch 2.  Dropout takes
the masks flax drew (``record_dropout``).

Bounds:
  * the VGG encoders (``vgg11``, ``vgg11_bn``, ``vgg19``, 64x64): every
    stage's output in eval mode within 1e-5 relative L2; ``vgg11_bn`` in
    train mode (2 x 2 x 2 values per channel at its deepest BN) in f64 in
    both packages within 1e-9, in f32 within 1e-5 plus twice JAX's own f32
    error;
  * a torchvision-layout ``vgg11_bn`` state dict loads through
    ``load_encoder_weights`` onto exactly the values of JAX's
    ``convert_vgg``;
  * ``upscore``: flax's ``ConvTranspose((64, 64), strides=32)`` with a
    random kernel (the bilinear one is symmetric and diagonal and would
    hide a wrong flip or swap) against the mapped ``ConvTranspose2d(k=64,
    s=32, p=16)`` at 7x7 and 10x10 inputs within 1e-5;
  * ``fcn32s`` eval and train forwards within 1e-5 relative L2;
  * ``OBIADataset`` items equal byte for byte, in the same order;
  * one ``sup`` step of ``fcn32s`` (the JAX driver's own compiled step,
    its masks) within 1e-5 for the loss terms and 1e-4 relative L2 for
    every gradient (no BN: f32 is well-conditioned);
  * one driver epoch of ``obia_CWFID.json`` cut to ``vgg11``, 224x224,
    batch 2, f32, on a tiny OBIA tree against JAX's ``supervised.train``
    with JAX's masks: epoch averages within 1e-3 relative (mIoU 1e-3
    absolute), the same run directory and ``last.ckpt`` keys.
"""
import json
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.data.dataset import OBIADataset as JaxOBIADataset
from vq_seg_tpu.models.encoders import make_encoder as jax_make_encoder
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.models.networks.fcn import bilinear_upsampling_kernel
from vq_seg_tpu.training import supervised as jsup
from vq_seg_tpu.utils.ckpoints import load_full as jax_load_full
from vq_seg_tpu.utils.torch_weights import convert_vgg as jax_convert_vgg
from _port_helpers import (MASKS, jax_f64, nchw, nhwc, record_dropout, rel, take_masks, to_np,
                           wide)
from _seeded_flax import seeded_variables
from _slice_parity import adam_gradient
from _vqpt_parity import _listing
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.data import OBIADataset, fastimg
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.models.encoders import make_encoder
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.training import supervised
from vq_seg_tpu_torch.training.supervised import TrainState, make_sup_train_step
from vq_seg_tpu_torch.utils import ckpoints, convert
from vq_seg_tpu_torch.utils.convert import sup_state_from_flax
from vq_seg_tpu_torch.utils.torch_weights import load_encoder_weights

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 224
FCN = {"encoder_name": "vgg11", "num_classes": 3}


def _image(hw, seed=0, n=2):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def _enc_sd(variables):
    sd = {}
    convert._encoder(sd, "", variables["params"], variables.get("batch_stats", {}))
    return sd


@pytest.mark.parametrize("name", ["vgg11", "vgg11_bn", "vgg19"])
def test_vgg_encoder_matches_jax(name):
    x = _image(64, 1)
    jenc, jch = jax_make_encoder(name, 3, 5)
    v = to_np(seeded_variables(jenc, (jnp.asarray(x),), train=True))
    enc, ch = make_encoder(name, 3, 5)
    assert tuple(ch) == tuple(jch) == (64, 128, 256, 512, 512, 512)
    enc.load_state_dict(_enc_sd(v))  # strict: features.N line up one to one
    with torch.no_grad():
        feats = enc.eval()(nchw(x))
    jfeats = jax.jit(lambda vv, xx: jenc.apply(vv, xx, train=False))(v, jnp.asarray(x))
    assert len(feats) == len(jfeats) == 6
    for i, (f, jf) in enumerate(zip(feats, jfeats)):
        assert nhwc(f).shape == np.asarray(jf).shape == (2, 64 >> i, 64 >> i, ch[i])
        assert rel(nhwc(f), jf) <= 1e-5
    if not name.endswith("_bn"):
        return
    jtrain = lambda vv, xx: jenc.apply(vv, xx, train=True, mutable=["batch_stats"])
    j32, _ = jax.jit(jtrain)(v, jnp.asarray(x))
    with jax_f64():
        j64, _ = jax.jit(jtrain)(wide(v), jnp.asarray(x, jnp.float64))
    with torch.no_grad():
        f32 = enc.train()(nchw(x))
        enc.load_state_dict(_enc_sd(v))
        f64 = enc.double().train()(nchw(x).double())
    for a32, a64, w32, w64 in zip(f32, f64, j32, j64):
        assert rel(nhwc(a64), w64) <= 1e-9
        assert rel(nhwc(a32), w64) <= 1e-5 + 2 * rel(w32, w64)


def test_vgg_pth_conversion_matches_jax(tmp_path):
    enc, _ = make_encoder("vgg11_bn", 3, 5)
    rng = np.random.default_rng(7)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
          for k, t in enc.state_dict().items() if not k.endswith("num_batches_tracked")}
    sd["features.1.num_batches_tracked"] = torch.tensor(3)
    sd.update({"classifier.0.weight": torch.zeros(8, 25088), "classifier.0.bias": torch.zeros(8)})
    torch.save(sd, str(tmp_path / "vgg11_bn.pth"))
    load_encoder_weights(enc, str(tmp_path / "vgg11_bn.pth"))
    params, stats = jax_convert_vgg({k: v.numpy() for k, v in sd.items()})
    want = _enc_sd({"params": params, "batch_stats": stats})
    got = {k: v for k, v in enc.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(k for k in want if not k.endswith("num_batches_tracked"))
    for key, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[key].numpy(), err_msg=key)
    # the port's fcn32s loads the same file into its encoder
    model = make_model({"name": "fcn32s", "params": {"encoder_name": "vgg11_bn",
                                                      "num_classes": 3}}, device="cpu")
    load_encoder_weights(model.encoder, str(tmp_path / "vgg11_bn.pth"))
    assert torch.equal(model.encoder.features[0].weight, sd["features.0.weight"])


@pytest.mark.parametrize("hw", [7, 10])
def test_upscore_mapping_with_a_random_kernel(hw):
    k = 3
    rng = np.random.default_rng(hw)
    kernel = rng.standard_normal((64, 64, k, k)).astype(np.float32)
    x = rng.standard_normal((2, hw, hw, k)).astype(np.float32)
    up = fnn.ConvTranspose(k, (64, 64), strides=(32, 32), use_bias=False)
    want = up.apply({"params": {"kernel": kernel}}, jnp.asarray(x))
    layer = torch.nn.ConvTranspose2d(k, k, 64, stride=32, padding=16, bias=False)
    sd = {}
    convert._conv_transpose(sd, "up", {"kernel": kernel})
    layer.load_state_dict({"weight": sd["up.weight"]})
    with torch.no_grad():
        got = nhwc(layer(nchw(x)))
    assert got.shape == np.asarray(want).shape == (2, 32 * hw, 32 * hw, k)
    assert rel(got, want) <= 1e-5


def test_fcn32s_forward_matches_jax():
    x = _image(HW, 2)
    jmodel = jax_make_model({"name": "fcn32s", "params": FCN})
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x),), train=True))
    model = make_model({"name": "fcn32s", "params": FCN}, device="cpu")
    model.load_state_dict(convert.state_dict_from_flax(v, None))
    want, none = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got, tnone = model.eval()(nchw(x))
    assert none is None and tnone is None
    assert nhwc(got).shape == np.asarray(want).shape == (2, HW, HW, 3)
    assert rel(nhwc(got), want) <= 1e-5
    MASKS.clear()
    with record_dropout():
        jt, _ = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=True, rngs={
            "dropout": jax.random.PRNGKey(5)}))(v, jnp.asarray(x))
        jax.effects_barrier()
    masks = take_masks(2)
    assert [tuple(m.shape) for m in masks] == [(2, 4096, 1, 1)] * 2
    with torch.no_grad():
        got, _ = model.train()(nchw(x), train=True, dropout=lambda shape: masks.pop(0))
    assert not masks and rel(nhwc(got), jt) <= 1e-5
    # a fresh network's upscore starts at the bilinear kernel, on every
    # class's diagonal
    w = make_model({"name": "fcn32s", "params": FCN}, device="cpu").upscore.weight
    sd = {}
    convert._conv_transpose(sd, "up", {"kernel": np.asarray(bilinear_upsampling_kernel(3, 64))})
    assert torch.equal(w, sd["up.weight"]) and not w[0, 1].any()


def _obia_tree(root):
    """input/ with 6 images, target/ with 2 masks and obia/ with pseudo
    masks for 2 of the 4 unlabelled images; a test split of 2."""
    rng = np.random.default_rng(11)
    for split, n, lab, obia in (("train", 6, (0, 1), (3, 5)), ("test", 2, (0, 1), ())):
        for sub in ("input", "target", "obia") if split == "train" else ("input", "target"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n):
            name = f"im{i:03d}.png"
            Image.fromarray(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)).save(
                os.path.join(root, split, "input", name))
            for sub, keep in (("target", lab), ("obia", obia)):
                if i in keep:
                    mask = rng.choice(np.array([0, 128, 255], np.uint8), (48, 56))
                    Image.fromarray(mask, mode="L").save(os.path.join(root, split, sub, name))
    return root


def test_obia_dataset_items_match_jax(tmp_path):
    root = _obia_tree(str(tmp_path / "tree"))
    jfastimg.load()
    fastimg.load()
    for bs in (None, 4):
        jds = JaxOBIADataset(os.path.join(root, "train"), batch_size=bs, resize=64)
        ds = OBIADataset(os.path.join(root, "train"), batch_size=bs, resize=64)
        assert len(ds) == len(jds) == (4 if bs is None else 4)
        assert [os.path.relpath(p, root) for p in ds.target_files] == [
            os.path.relpath(p, root) for p in jds.target_files]
        assert os.path.basename(os.path.dirname(ds.target_files[0])) == "obia"
        for i in range(len(ds)):
            a, b = ds[i], jds[i]
            assert a["filename"] == b["filename"]
            for key in ("img", "target"):
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    ds = OBIADataset(os.path.join(root, "train"), batch_size=3, resize=64)
    assert len(ds) == 6 and ds.target_files[4:] == ds.target_files[:2]


def _obia_cfg(data_dir, save_dir):
    cfg = json.load(open(os.path.join(ROOT, "config", "obia_CWFID.json")))
    cfg["resize"] = HW
    cfg["model"]["params"].update(encoder_name="vgg11", encoder_weights=None)
    cfg["train"].update(data_dir=data_dir, save_dir=save_dir, num_epochs=1, batch_size=2,
                        half=False)
    return cfg


@pytest.fixture(scope="module")
def obia_runs(tmp_path_factory):
    """JAX's ``supervised.train`` of the cut ``obia_CWFID.json`` for one
    epoch of 2 steps (its step captured, its masks recorded), then the
    port's from JAX's initial state with JAX's masks."""
    base = tmp_path_factory.mktemp("obia")
    root = _obia_tree(str(base / "tree"))
    captured = {}
    real_make = jsup.make_sup_train_step

    def make_capturing(*a, **k):
        step = real_make(*a, **k)
        captured["step"] = step

        def capturing(state, *args):
            captured.setdefault("post", to_np(state))
            return step(state, *args)

        return capturing

    def seeded_state(model, tx, sample_args, seed=0):
        v = seeded_variables(model, sample_args, seed, train=True)
        return jsup.TrainState(variables=v, opt_state=tx.init(v["params"]),
                               step=jnp.zeros((), jnp.int32))

    jfastimg.load()
    mp = pytest.MonkeyPatch()
    mp.setattr(jsup, "make_sup_train_step", make_capturing)
    mp.setattr(jsup, "create_state", seeded_state)
    MASKS.clear()
    try:
        with record_dropout():
            jsup.train(JaxConfig(_obia_cfg(root, str(base / "jax"))), max_steps_per_epoch=2)
            jax.effects_barrier()
    finally:
        mp.undo()
    masks = take_masks(4)
    assert not MASKS

    mp.setattr(supervised, "init_phase",
               lambda state, args, **k: sup_state_from_flax(state, captured["post"], None))
    mp.setattr(supervised, "sup_dropout", lambda cfg, device: lambda shape: masks.pop(0))
    history = []
    try:
        state = supervised.train(Config(_obia_cfg(root, str(base / "port"))),
                                 max_steps_per_epoch=2, device="cpu", history=history)
    finally:
        mp.undo()
    assert not masks
    yield dict(state=state, history=history, captured=captured,
               jax_run=str(base / "jax" / "OBIA_CWFID_sup_0"),
               port_run=str(base / "port" / "OBIA_CWFID_sup_0"))
    shutil.rmtree(base, ignore_errors=True)


def test_fcn32s_sup_step_matches_jax(obia_runs):
    post = obia_runs["captured"]["post"]
    rng = np.random.default_rng(4)
    x = rng.random((2, HW, HW, 3)).astype(np.float32)
    gt = ((np.arange(HW)[None, :, None] // 16 + rng.integers(0, 2, (2, HW, HW))) % 3).astype(
        np.int32)
    MASKS.clear()
    with record_dropout():
        jnew, jm, _ = obia_runs["captured"]["step"](jax.tree_util.tree_map(jnp.asarray, post),
                                                   jnp.asarray(x), jnp.asarray(gt), None)
        jax.effects_barrier()
    masks = take_masks(2)
    jnew, jm = to_np(jnew), to_np(jm)
    model = make_model({"name": "fcn32s", "params": FCN}, device="cpu")
    model.load_state_dict(convert.state_dict_from_flax(post.variables, None))
    st = TrainState(model, supervised._adam(model.parameters()), lambda s: 0.0)
    step = make_sup_train_step(make_loss("cross_entropy", 3, ignore_index=255), num_classes=3,
                               forward_mode="plain")
    _, m, _ = step(st, nchw(x), torch.from_numpy(gt).long(), None,
                   lambda shape: masks.pop(0))
    assert not masks
    for k in ("loss", "sup_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(m["commitment_loss"]) == float(m["prototype_loss"]) == 0.0
    grads = convert.state_dict_from_flax({**post.variables,
                                          "params": adam_gradient(jnew.opt_state)}, None)
    for name, p in model.named_parameters():
        assert rel(p.grad.numpy(), grads[name].numpy()) <= 1e-4, name


def test_obia_driver_epoch_matches_jax(obia_runs):
    jrun, prun = obia_runs["jax_run"], obia_runs["port_run"]
    log = "OBIA_CWFID_sup_0.jsonl"
    assert _listing(jrun) == _listing(prun) == sorted(["ckpoints", "ckpoints/last.ckpt", log])
    [jrec] = [json.loads(line) for line in open(os.path.join(jrun, log))]
    [rec] = [json.loads(line) for line in open(os.path.join(prun, log))]
    assert set(rec) == set(jrec) >= {"loss", "sup_loss", "miou"}
    for k in rec:
        tol = dict(atol=1e-3) if k == "miou" else dict(rtol=1e-3, atol=1e-9)
        np.testing.assert_allclose(rec[k], jrec[k], err_msg=k, **tol)
    [h] = obia_runs["history"]
    assert h["epoch"] == 0 and h["step"] == 2
    ck = ckpoints.load_full(os.path.join(prun, "ckpoints", "last.ckpt"))
    jck = jax_load_full(os.path.join(jrun, "ckpoints", "last.ckpt"))
    assert set(ck) == set(jck) == {"model_1", "epoch"} and ck["epoch"] == 0
