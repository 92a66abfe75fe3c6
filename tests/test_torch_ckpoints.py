"""Port parity: checkpoints (``utils/ckpoints.py``, ``ckpt_cadence``) and the
pretrained ResNet encoder (``utils/torch_weights.py``) against the JAX
package, on the CPU at resnet18 / K=4-8 / 64x64.

  * ``ckpt_cadence`` equals JAX's over a grid of ``ckpt_every`` x
    ``last_every`` x ``light_snapshots`` x epoch x ``num_epochs``.
  * The contract keys; a light snapshot has no optimizers and
    ``load_ckpoints(istrain=True)`` raises on it; the host copy does not
    follow later updates; ``latest_ckpt`` picks the newest ``last.ckpt``;
    a failed background write raises in ``wait_for_saves``;
    ``Predictor.from_checkpoint(device="cpu")`` loads a ``last.ckpt``;
    ``save_tar``.
  * A seeded resnet18 state dict with torchvision names, saved as a .pth,
    loaded by JAX's ``load_encoder_weights`` and by the port: the encoder
    outputs within 1e-5 (eval mode, so the BN running statistics count);
    ``create_cps_state`` loads it into both models before re-drawing the
    decoder and head; VGG/ConvNeXt files raise.
"""
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.config import Config as JaxConfig
from vq_seg_tpu.models.encoders import make_encoder as jax_make_encoder
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu.training import cps as jcps
from vq_seg_tpu.utils.torch_weights import load_encoder_weights as jax_load_encoder_weights
from vq_seg_tpu_torch.config import Config
from vq_seg_tpu_torch.models.encoders import make_encoder
from vq_seg_tpu_torch.serving import Predictor
from vq_seg_tpu_torch.training import ckpt_cadence, create_cps_state
from vq_seg_tpu_torch.utils import ckpoints
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax
from vq_seg_tpu_torch.utils.torch_weights import load_encoder_weights

torch.set_num_threads(1)

HW = 64
NUM_EMB = [0, 0, 4, 4, 4]
MODEL_CFG = {"name": "vqreptunet1x1v2", "params": {
    "encoder_name": "resnet18", "num_classes": 3,
    "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True},
    "margin": 0.5, "scale": 30.0}}
CONTRACT = {"model_1", "model_2", "epoch", "batch_idx", "optimizer_1", "optimizer_2"}


# -- cadence ---------------------------------------------------------------------


@pytest.mark.parametrize("light", [False, True])
@pytest.mark.parametrize("last_every", [None, 1, 3])
@pytest.mark.parametrize("ckpt_every", [None, 1, 4, 12])
def test_ckpt_cadence_equals_jax(ckpt_every, last_every, light):
    train = {"light_snapshots": light}
    if ckpt_every is not None:
        train["ckpt_every"] = ckpt_every
    if last_every is not None:
        train["last_every"] = last_every
    ours, ref = Config({"train": train}), JaxConfig({"train": train})
    for num_epochs in (1, 5, 25):
        for epoch in range(num_epochs):
            assert ckpt_cadence(ours, epoch, num_epochs) == jcps.ckpt_cadence(ref, epoch, num_epochs)


# -- the checkpoint contract -------------------------------------------------------


@pytest.fixture(scope="module")
def state():
    """A port CPS state whose Adams have taken one step."""
    st = create_cps_state(MODEL_CFG, lambda step: 1e-3, device="cpu")
    for model, opt in ((st.model_1, st.opt_1), (st.model_2, st.opt_2)):
        loss = model(torch.rand(1, 3, HW, HW))[0].square().mean()
        loss.backward()
        opt.step()
    st.step = 1
    return st


def _save(st, path, **kw):
    ckpoints.save_ckpoints(st.model_1, st.model_2, 3, 7, st.opt_1, st.opt_2, str(path), **kw)
    ckpoints.wait_for_saves()


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_trees(x, y) for x, y in zip(a, b))
    return a == b


def test_contract_keys_and_round_trip(state, tmp_path):
    _save(state, tmp_path / "last.ckpt")
    ck = ckpoints.load_full(str(tmp_path / "last.ckpt"))
    assert set(ck) == CONTRACT
    assert ck["epoch"] == 3 and ck["batch_idx"] == 7
    assert _equal_trees(ck["model_1"], state.model_1.state_dict())
    assert _equal_trees(ck["model_2"], state.model_2.state_dict())
    assert _equal_trees(ck["optimizer_1"], state.opt_1.state_dict())
    assert _equal_trees(ck["optimizer_2"], state.opt_2.state_dict())
    m2, epoch, batch_idx, o1, o2 = ckpoints.load_ckpoints(str(tmp_path / "last.ckpt"), istrain=True)
    assert (epoch, batch_idx) == (3, 7) and _equal_trees(m2, ck["model_2"])
    assert _equal_trees(ckpoints.load_ckpoints(str(tmp_path / "last.ckpt"), istrain=False),
                        ck["model_1"])
    assert ckpoints.write_log[-1]["path"] == str(tmp_path / "last.ckpt")
    assert ckpoints.write_log[-1]["bytes"] == os.path.getsize(tmp_path / "last.ckpt")


def test_light_snapshot(state, tmp_path):
    _save(state, tmp_path / "0ep.ckpt", include_optimizers=False)
    ck = ckpoints.load_full(str(tmp_path / "0ep.ckpt"))
    assert set(ck) == {"model_1", "model_2", "epoch", "batch_idx"}
    with pytest.raises(ValueError, match="light snapshot"):
        ckpoints.load_ckpoints(str(tmp_path / "0ep.ckpt"), istrain=True)
    assert _equal_trees(ckpoints.load_ckpoints(str(tmp_path / "0ep.ckpt"), istrain=False),
                        state.model_1.state_dict())
    light = ckpoints.fetch_ckpt_tree(state.model_1, state.model_2, 0, 0, None, None,
                                     include_optimizers=False)
    with pytest.raises(ValueError, match="optimizer state"):
        ckpoints.save_ckpoints(None, None, 0, 0, None, None, str(tmp_path / "x.ckpt"),
                               prefetched=light)


def test_host_copy_does_not_follow_the_model(state, tmp_path):
    """The background write reads the host copy while training goes on."""
    host = ckpoints.fetch_ckpt_tree(state.model_1, state.model_2, 0, 0, state.opt_1, state.opt_2)
    w = state.model_1.segmentation_head.weight
    old = w.detach().clone()
    with torch.no_grad():
        w.add_(1.0)
    try:
        assert torch.equal(host["model_1"]["segmentation_head.weight"], old)
    finally:
        with torch.no_grad():
            w.sub_(1.0)


def test_failed_write_raises_in_wait_for_saves(state, tmp_path):
    host = ckpoints.fetch_ckpt_tree(state.model_1, state.model_2, 0, 0, state.opt_1, state.opt_2)
    ckpoints.save_ckpoints(None, None, 0, 0, None, None, str(tmp_path / "no" / "dir.ckpt"),
                           prefetched=host)
    with pytest.raises(RuntimeError, match="does not exist"):
        ckpoints.wait_for_saves()
    ckpoints.wait_for_saves()  # nothing left in flight


def test_latest_ckpt_picks_the_newest(state, tmp_path):
    assert ckpoints.latest_ckpt(str(tmp_path / "none")) is None
    assert ckpoints.latest_ckpt(None) is None
    paths = []
    for i, t in enumerate((100.0, 300.0, 200.0)):
        d = tmp_path / f"P_hybrid_{i}" / "ckpoints"
        d.mkdir(parents=True)
        (d / "last.ckpt").write_bytes(b"x")
        os.utime(d / "last.ckpt", (t, t))
        paths.append(str(d / "last.ckpt"))
    (tmp_path / "P_hybrid_3" / "ckpoints").mkdir(parents=True)  # a run without last.ckpt
    assert ckpoints.latest_ckpt(str(tmp_path)) == paths[1]


def test_predictor_from_checkpoint_reads_last_ckpt(state, tmp_path):
    _save(state, tmp_path / "last.ckpt")
    cfg = Config({"model": MODEL_CFG, "resize": HW})
    pred = Predictor.from_checkpoint(cfg, str(tmp_path / "last.ckpt"), device="cpu", half=False,
                                     batch_size=2)
    assert _equal_trees(pred.model.state_dict(), state.model_1.state_dict())
    imgs = np.random.default_rng(0).integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    labels = pred(imgs)
    assert labels.shape == (2, HW, HW) and labels.dtype == np.uint8 and labels.max() < 3
    with torch.no_grad():
        want = state.model_1.eval()(torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0)[0]
    state.model_1.train()
    np.testing.assert_array_equal(labels, want.argmax(1).numpy())


def test_save_tar(tmp_path):
    run = tmp_path / "P_hybrid_0"
    (run / "ckpoints").mkdir(parents=True)
    (run / "ckpoints" / "last.ckpt").write_bytes(b"abc")
    ckpoints.save_tar(str(run))
    assert not run.exists()
    with tarfile.open(tmp_path / "P_hybrid_0.tar.gz") as t:
        assert any(n.endswith("P_hybrid_0/ckpoints/last.ckpt") for n in t.getnames())


# -- the pretrained encoder ----------------------------------------------------------


def _torchvision_resnet18(path, seed=0):
    """A seeded resnet18 state dict with torchvision's names (the port's
    encoder keys plus ``fc.*``), saved as a .pth."""
    rng = np.random.default_rng(seed)
    enc, _ = make_encoder("resnet18", 3, 5, generator=torch.Generator().manual_seed(0))
    sd = {}
    for k, v in enc.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k.endswith("running_mean") or k.endswith("bias"):
            sd[k] = torch.from_numpy((rng.standard_normal(v.shape) * 0.1).astype(np.float32))
        elif v.dim() == 1:  # BN scale, below 1 so the residual stages stay near unit size
            sd[k] = torch.from_numpy(rng.uniform(0.25, 0.75, v.shape).astype(np.float32))
        else:
            fan_in = int(np.prod(v.shape[1:]))
            sd[k] = torch.from_numpy((rng.standard_normal(v.shape) / np.sqrt(fan_in)).astype(np.float32))
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, str(path))
    return sd


def test_pretrained_resnet_matches_jax_loader(tmp_path):
    pth = tmp_path / "resnet18-imagenet_swsl.pth"
    sd = _torchvision_resnet18(pth)
    x = np.random.default_rng(1).uniform(size=(2, HW, HW, 3)).astype(np.float32)
    jmodel = jax_make_model(MODEL_CFG)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax_load_encoder_weights(v, "resnet18", str(pth), encoder_path=("core", "encoder"))
    jenc, _ = jax_make_encoder("resnet18", 3, 5, padding_mode="reflect")
    jfeats = jenc.apply({"params": v["params"]["core"]["encoder"],
                         "batch_stats": v["batch_stats"]["core"]["encoder"]}, jnp.asarray(x), False)

    from vq_seg_tpu_torch.models.networks import make_model

    model = make_model(MODEL_CFG, device="cpu", generator=torch.Generator().manual_seed(3))
    enc = model.core.encoder
    load_encoder_weights(enc, str(pth))
    own = enc.state_dict()
    for k in own:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(own[k], sd[k]), k
    # the same tensors as JAX's tree carries (its mapping back into the port)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, v), NUM_EMB)
    for k in own:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(own[k].numpy(), want[f"core.encoder.{k}"].numpy(), err_msg=k)
    with torch.no_grad():
        feats = enc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(feats) == len(jfeats) == 6
    for f, jf in zip(feats[1:], jfeats[1:]):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), np.asarray(jf), atol=1e-5)


def test_create_cps_state_loads_the_encoder_then_redraws_the_decoder(tmp_path, monkeypatch):
    sd = _torchvision_resnet18(tmp_path / "resnet18-imagenet_swsl.pth")
    monkeypatch.setenv("VQ_SEG_PRETRAINED_DIR", str(tmp_path))
    st = create_cps_state(MODEL_CFG, lambda step: 1e-4, encoder_weights="imagenet_swsl",
                          init_weights=True, device="cpu")
    plain = create_cps_state(MODEL_CFG, lambda step: 1e-4, init_weights=True, device="cpu")
    for model, other in ((st.model_1, plain.model_1), (st.model_2, plain.model_2)):
        for k, t in model.core.encoder.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(t, sd[k]), k
        # the decoder and head are re-drawn from the model's own generator,
        # the same draws as without pretrained weights
        for name in ("core.decoder.blocks.0.0.conv.weight", "segmentation_head.weight"):
            assert torch.equal(model.state_dict()[name], other.state_dict()[name])
    assert not torch.equal(st.model_1.segmentation_head.weight, st.model_2.segmentation_head.weight)
    # a direct path resolves as well
    st2 = create_cps_state(MODEL_CFG, lambda step: 1e-4,
                           encoder_weights=str(tmp_path / "resnet18-imagenet_swsl.pth"),
                           device="cpu")
    assert torch.equal(st2.model_1.core.encoder.conv1.weight, sd["conv1.weight"])


def _torchvision_convnext_state(depths, dims, rng):
    """A torchvision-layout ConvNeXt state dict with random values:
    ``features.0.{0,1}`` stem, blocks ``features.{2s+1}.{b}.block.{0,2,3,5}``
    with ``layer_scale``, downsamplers ``features.{2s}.{0,1}``, a
    classifier."""
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    sd = {"features.0.0.weight": t(dims[0], 3, 4, 4), "features.0.0.bias": t(dims[0]),
          "features.0.1.weight": t(dims[0]), "features.0.1.bias": t(dims[0])}
    for si, (n, d) in enumerate(zip(depths, dims)):
        if si > 0:
            sd.update({f"features.{2 * si}.0.weight": t(dims[si - 1]),
                       f"features.{2 * si}.0.bias": t(dims[si - 1]),
                       f"features.{2 * si}.1.weight": t(d, dims[si - 1], 2, 2),
                       f"features.{2 * si}.1.bias": t(d)})
        for b in range(n):
            pre = f"features.{2 * si + 1}.{b}"
            sd.update({f"{pre}.layer_scale": t(d, 1, 1),
                       f"{pre}.block.0.weight": t(d, 1, 7, 7), f"{pre}.block.0.bias": t(d),
                       f"{pre}.block.2.weight": t(d), f"{pre}.block.2.bias": t(d),
                       f"{pre}.block.3.weight": t(4 * d, d), f"{pre}.block.3.bias": t(4 * d),
                       f"{pre}.block.5.weight": t(d, 4 * d), f"{pre}.block.5.bias": t(d)})
    sd.update({"classifier.0.weight": t(dims[-1]), "classifier.2.weight": t(10, dims[-1])})
    return sd


def test_vgg_or_convnext_files_raise(tmp_path):
    """A VGG file for a ResNet encoder raises (VGG files load into the VGG
    encoders, ``tests/test_torch_fcn.py``), a file short of encoder keys
    raises, and a torchvision ConvNeXt file loads, onto the same values as
    the JAX package's ``convert_convnext`` gives."""
    torch.save({"features.0.weight": torch.zeros(64, 3, 3, 3)}, str(tmp_path / "vgg.pth"))
    enc, _ = make_encoder("resnet18", 3, 5)
    with pytest.raises(ValueError, match="lacks"):
        load_encoder_weights(enc, str(tmp_path / "vgg.pth"))
    torch.save({"conv1.weight": torch.zeros(64, 3, 7, 7)}, str(tmp_path / "partial.pth"))
    with pytest.raises(ValueError, match="lacks"):
        load_encoder_weights(enc, str(tmp_path / "partial.pth"))

    from vq_seg_tpu.utils.torch_weights import convert_convnext as jax_convert_convnext
    from vq_seg_tpu_torch.models.encoders.convnext import convnext_encoders
    from vq_seg_tpu_torch.utils.convert import _encoder

    p = convnext_encoders["convnext_tiny"]
    sd = _torchvision_convnext_state(p["depths"], p["dims"], np.random.default_rng(5))
    torch.save(sd, str(tmp_path / "convnext.pth"))
    enc, _ = make_encoder("convnext_tiny", 3, 4)
    load_encoder_weights(enc, str(tmp_path / "convnext.pth"))
    params, stats = jax_convert_convnext({k: v.numpy() for k, v in sd.items()})
    assert stats == {}
    want: dict = {}
    _encoder(want, "", params, {})  # the JAX tree in the port's names
    got = enc.state_dict()
    assert sorted(got) == sorted(want)
    for key, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[key].numpy(), err_msg=key)

