"""Port parity: the ``selfsup`` slice (``config/vqvaev2_selfsup.json``)
against the JAX package, on the CPU at resnet18 / K=8 / 64x64, batch 2
(helpers in ``_slice_parity.py`` and ``_port_helpers.py``).

Bounds:
  * flax's ``ConvTranspose(k=4, s=2, padding="SAME")`` against the port's
    ``ConvTranspose2d(k=4, s=2, p=1)`` with the kernel flipped and its
    in/out axes swapped (``utils/convert.py``), at odd and even sizes and
    two channel counts: output shapes equal (twice the input), values
    within 1e-6 relative L2, the input gradient likewise;
  * ``vqvaev2`` (decoder stride 2 and 4) and ``vqvaev1`` eval and train
    forwards: the reconstruction within 1e-5 relative L2, commit within
    1e-5 relative, usage exactly equal, each VQ stage's idx exactly equal;
  * one ``selfsup`` step from the JAX driver's post-init state (its own
    compiled step): loss terms within 1e-5 relative, gradients within 1e-4
    relative L2, running statistics within 1e-5, codebooks unchanged;
  * one driver epoch of ``selfsup.train`` over a ``FolderDataset`` against
    JAX's, the port from JAX's post-init state: epoch averages within 1e-3
    relative, the same ``selfsup_ckpoints/0ep_{encoder,codebook,decoder}``
    files;
  * ``save_vqvae`` of a seeded ``vqvaev2`` and ``load_vqvae_pretrained``
    into a seeded ``vqptunet`` give bitwise the same weights in both
    packages (the VQ-VAE's encoder at its top level, the codebooks by
    stage); ``vqvaev1``'s one codebook matches no stage in either package.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import os
import shutil
import warnings

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.data import fastimg as jfastimg
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import selfsup as jselfsup
from vq_seg_tpu.utils import ckpoints as jck
from _port_helpers import nchw, nhwc, rel, to_np
from _seeded_flax import seeded_variables
from _slice_parity import NUM_EMB, JitModel, drv_cfg
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.models.networks.vqvae import _conv_transpose
from vq_seg_tpu_torch.training import selfsup
from vq_seg_tpu_torch.training.supervised import TrainState, _adam
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils import convert
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

VQ = {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True}


@pytest.mark.parametrize("hw,cin,cout", [((5, 5), 4, 3), ((6, 7), 8, 3), ((8, 8), 3, 6)])
def test_conv_transpose_matches_flax(hw, cin, cout):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    jmod = nn.ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME")
    params = {"kernel": rng.standard_normal((4, 4, cin, cout)).astype(np.float32),
              "bias": rng.standard_normal(cout).astype(np.float32)}
    g = rng.standard_normal((2, 2 * hw[0], 2 * hw[1], cout)).astype(np.float32)
    jout, vjp = jax.vjp(lambda xx: jmod.apply({"params": params}, xx), jnp.asarray(x))
    [jgx] = vjp(jnp.asarray(g))
    up = _conv_transpose(cin, cout, None)
    sd = {}
    convert._conv_transpose(sd, "up", params)
    up.load_state_dict({k[3:]: t for k, t in sd.items()})
    xt = nchw(x).requires_grad_(True)
    out = up(xt)
    (out * nchw(g)).sum().backward()
    assert nhwc(out).shape == np.asarray(jout).shape == (2, 2 * hw[0], 2 * hw[1], cout)
    assert rel(nhwc(out.detach()), jout) <= 1e-6
    assert rel(nhwc(xt.grad), jgx) <= 1e-6


def _vq_hooks(model, name):
    seen = []
    quantizers = ([model.codebooks[i] for i, k in enumerate(NUM_EMB) if k]
                  if name == "vqvaev2" else [model.codebook])
    for q in quantizers:
        q.register_forward_hook(lambda m, a, out: seen.append(out[1].numpy().copy()))
    return seen


@pytest.mark.parametrize("name,stride", [("vqvaev2", 2), ("vqvaev2", 4), ("vqvaev1", 2)])
def test_vqvae_forwards_match_jax(name, stride):
    x = np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    cfg = {"name": name, "params": {"encoder_name": "resnet18", "vq_cfg": VQ, "stride": stride}}
    jmodel = jax_make_model(cfg)
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x),), train=True))
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    idx = _vq_hooks(model, name)
    is_vq = lambda mdl, _: type(mdl).__name__ == "VectorQuantizer"
    for train in (False, True):
        idx.clear()
        (jrec, jc, ju), st = jax.jit(lambda vv, xx: jmodel.apply(
            vv, xx, train=train, capture_intermediates=is_vq,
            mutable=["intermediates", "batch_stats"]))(v, jnp.asarray(x))
        inter = st["intermediates"]
        jidx = ([inter[f"VectorQuantizer_{n}"]["__call__"][0][1] for n in range(3)]
                if name == "vqvaev2" else [inter["codebook"]["__call__"][0][1]])
        model.train(train)
        with torch.no_grad():
            rec, c, u = model(nchw(x), train=train)
        assert nhwc(rec).shape == np.asarray(jrec).shape
        assert rel(nhwc(rec), jrec) <= 1e-5
        np.testing.assert_allclose(c.item(), float(jc), rtol=1e-5, atol=1e-12)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        assert len(idx) == len(jidx)
        for got, want in zip(idx, jidx):
            np.testing.assert_array_equal(got, np.asarray(want))
        assert (c.item() > 0) == train


# -- the step and the driver -----------------------------------------------------------


def _selfsup_cfg(data_dir, save_dir):
    cfg = drv_cfg(data_dir, save_dir, "vqvaev2_selfsup")
    cfg["train"]["data_dir"] = os.path.join(data_dir, "train", "input")
    cfg["wandb_logging"] = False
    return cfg


@pytest.fixture(scope="module")
def selfsup_runs(synthetic_dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("selfsup")
    captured = {}
    real_make = jselfsup.make_selfsup_train_step

    def make_capturing(model, tx):
        step = real_make(model, tx)

        def capturing(state, img):
            if "post" not in captured:
                captured["post"] = to_np(state)
            out = step(state, img)
            captured.setdefault("metrics", []).append(to_np(out[1]))
            return out

        captured["step"] = step
        return capturing

    jfastimg.load()
    mp = pytest.MonkeyPatch()
    mp.setattr(jselfsup, "make_selfsup_train_step", make_capturing)
    mp.setattr(jselfsup, "make_model", lambda c: JitModel(jax_make_model(c)))
    try:
        jselfsup.train(JaxConfig(_selfsup_cfg(synthetic_dataset, str(base / "jax"))),
                       max_steps_per_epoch=2)
    finally:
        mp.undo()

    def port_init(state, args):
        state.model.load_state_dict(state_dict_from_flax(captured["post"].variables, NUM_EMB))
        return state

    mp.setattr(selfsup, "init_phase", port_init)
    history = []
    try:
        state = selfsup.train(Config(_selfsup_cfg(synthetic_dataset, str(base / "port"))),
                              max_steps_per_epoch=2, device="cpu", history=history)
    finally:
        mp.undo()
    yield dict(state=state, history=history, captured=captured, base=base)
    shutil.rmtree(base, ignore_errors=True)


def test_one_selfsup_step_matches_jax(selfsup_runs):
    post = selfsup_runs["captured"]["post"]
    x = np.random.default_rng(8).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jnew, jm, _ = selfsup_runs["captured"]["step"](jax.tree_util.tree_map(jnp.asarray, post),
                                                   jnp.asarray(x))
    jnew, jm = to_np(jnew), to_np(jm)
    cfg = _selfsup_cfg("", "")
    model = make_model(cfg["model"], device="cpu")
    model.load_state_dict(state_dict_from_flax(post.variables, NUM_EMB))
    st = TrainState(model.train(), _adam(model.parameters()), lambda s: 1e-4)
    st, m, _ = selfsup.make_selfsup_train_step()(st, nchw(x))
    for k in ("loss", "recon_loss", "commitment_loss", "code_usage"):
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=1e-5, err_msg=k)
    grads = jax.tree_util.tree_map(lambda mu: mu / np.float32(0.1), jnew.opt_state[0].mu)
    want = state_dict_from_flax({**post.variables, "params": grads}, NUM_EMB)
    for name, p in model.named_parameters():
        assert rel(p.grad.numpy(), want[name].numpy()) <= 1e-4, name
    new = state_dict_from_flax(jnew.variables, NUM_EMB)
    for key, t in model.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(t.numpy(), new[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        if "codebooks" in key:
            np.testing.assert_array_equal(t.numpy(), new[key].numpy(), err_msg=key)


def test_selfsup_driver_epoch_matches_jax(selfsup_runs):
    base = selfsup_runs["base"]
    names = ["0ep_codebook.ckpt", "0ep_decoder.ckpt", "0ep_encoder.ckpt"]
    for pkg in ("jax", "port"):
        assert sorted(os.listdir(base / pkg / "selfsup_ckpoints")) == names
    [h] = selfsup_runs["history"]
    assert h["step"] == 2 and h["ckpt_files"] == ["0ep_encoder.ckpt", "0ep_codebook.ckpt",
                                                  "0ep_decoder.ckpt"]
    # the port's files against the state it trained, the JAX files' keys
    enc = ckpoints.load_full(str(base / "port" / "selfsup_ckpoints" / "0ep_encoder.ckpt"))
    sd = selfsup_runs["state"].model.encoder.state_dict()
    assert set(enc) == set(sd) and all(torch.equal(enc[k], sd[k]) for k in sd)
    jcb = jck.load_full(str(base / "jax" / "selfsup_ckpoints" / "0ep_codebook.ckpt"))
    cb = ckpoints.load_full(str(base / "port" / "selfsup_ckpoints" / "0ep_codebook.ckpt"))
    assert sorted(jcb) == [f"VectorQuantizer_{n}" for n in range(3)]
    assert sorted(cb) == ["2.embedding", "3.embedding", "4.embedding"]
    for n, stage in enumerate((2, 3, 4)):  # codebooks are not trained: JAX's post-init ones
        np.testing.assert_array_equal(cb[f"{stage}.embedding"].numpy(),
                                      np.asarray(jcb[f"VectorQuantizer_{n}"]["embedding"]))
    # the epoch averages against the JAX driver's steps' metrics
    jsteps = selfsup_runs["captured"]["metrics"]
    assert len(jsteps) == 2
    for k in ("loss", "recon_loss", "commitment_loss", "code_usage"):
        want = float(np.mean([np.mean(m[k]) for m in jsteps]))
        np.testing.assert_allclose(h[k], want, rtol=1e-3, err_msg=k)


def test_vqvae_files_load_into_vqptunet_as_in_jax(tmp_path):
    x = np.zeros((2, 64, 64, 3), np.float32)
    gt = np.zeros((2, 64, 64), np.int32)
    vae_cfg = {"name": "vqvaev2", "params": {"encoder_name": "resnet18", "vq_cfg": VQ}}
    net_cfg = {"name": "vqptunet", "params": {"encoder_name": "resnet18", "num_classes": 3,
                                              "vq_cfg": VQ}}
    vae_v = to_np(seeded_variables(jax_make_model(vae_cfg), (jnp.asarray(x),), seed=1,
                                   train=True))
    net_v = to_np(seeded_variables(jax_make_model(net_cfg), (jnp.asarray(x), jnp.asarray(gt)),
                                   seed=2, train=True))
    # JAX: its files, loaded into the network's variables
    jck.save_vqvae(vae_v, 3, str(tmp_path / "jax"))
    jck.wait_for_saves()
    loaded = to_np(jck.load_vqvae_pretrained(net_v, str(tmp_path / "jax" / "3ep_encoder.ckpt"),
                                             str(tmp_path / "jax" / "3ep_codebook.ckpt")))
    want = state_dict_from_flax(loaded, NUM_EMB)
    # the port: the same VQ-VAE's files, loaded into the same network
    vae = make_model(vae_cfg, device="cpu")
    vae.load_state_dict(state_dict_from_flax(vae_v, NUM_EMB))
    ckpoints.save_vqvae(vae, 3, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == ["3ep_codebook.ckpt", "3ep_decoder.ckpt",
                                                     "3ep_encoder.ckpt"]
    net = make_model(net_cfg, device="cpu")
    net.load_state_dict(state_dict_from_flax(net_v, NUM_EMB))
    ckpoints.load_vqvae_pretrained(net, str(tmp_path / "port" / "3ep_encoder.ckpt"),
                                   str(tmp_path / "port" / "3ep_codebook.ckpt"))
    got = net.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    before = state_dict_from_flax(net_v, NUM_EMB)
    changed = [k for k in got if not torch.equal(got[k], before[k])]
    assert changed and all(k.startswith(("core.encoder.", "core.codebooks.")) for k in changed)
    # vqvaev1's single codebook matches no stage, in either package
    v1_cfg = {"name": "vqvaev1", "params": {"encoder_name": "resnet18", "vq_cfg": VQ}}
    v1_v = to_np(seeded_variables(jax_make_model(v1_cfg), (jnp.asarray(x),), seed=3, train=True))
    jck.save_vqvae(v1_v, 0, str(tmp_path / "jax1"))
    jck.wait_for_saves()
    with pytest.warns(UserWarning, match="codebook"):
        jck.load_vqvae_pretrained(net_v, str(tmp_path / "jax1" / "0ep_encoder.ckpt"),
                                  str(tmp_path / "jax1" / "0ep_codebook.ckpt"))
    v1 = make_model(v1_cfg, device="cpu")
    v1.load_state_dict(state_dict_from_flax(v1_v, NUM_EMB))
    ckpoints.save_vqvae(v1, 0, str(tmp_path / "port1"))
    assert sorted(ckpoints.load_full(str(tmp_path / "port1" / "0ep_codebook.ckpt"))) == [
        "embedding"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ckpoints.load_vqvae_pretrained(net, str(tmp_path / "port1" / "0ep_encoder.ckpt"),
                                       str(tmp_path / "port1" / "0ep_codebook.ckpt"))
    assert any("no codebook" in str(w.message) for w in caught)
