"""Port parity: the decoder's ``subpixel_tail`` against the JAX package, f32
on the CPU at resnet18 / K=8.

  * ``space_to_depth``/``depth_to_space`` put the 2x2 position first in the
    channels, as the JAX package's NHWC reshapes do (``F.pixel_unshuffle``
    puts it last): equal to JAX's reshapes bitwise, and each the other's
    inverse.
  * ``UnetDecoder(subpixel_tail=True)`` alone, eval and train mode, and the
    flagship with ``subpixel_tail: true`` (eval logits and the train
    forward's outputs), weights mapped from seeded JAX variables: within
    1e-4; the BN running stats of the train forward within 1e-5.
  * One train forward's gradients (a fixed random projection of the
    logits plus the commitment and prototype terms) within 1e-4 relative
    L2 of JAX's in f64 in both packages (train-mode BN over the few values
    of resnet18's deepest stage at 64x64 makes f32 gradients
    ill-conditioned), and in f32 within 1e-4 plus JAX's own f32 distance.
  * The tail applies to the last block only, never with ``cca`` or a
    single block; odd skip sizes raise in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.models.modules.decoder import UnetDecoder as JaxDecoder
from vq_seg_tpu.models.networks import make_model as jax_make_model
from _port_helpers import jax_f64, nchw, nhwc, port_f64, rel, to_np, wide
from _seeded_flax import seeded_variables
from vq_seg_tpu_torch.models.modules.decoder import (UnetDecoder, depth_to_space,
                                                     space_to_depth)
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.utils import convert
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

HW, TH = 64, 0.7
NUM_EMB = [0, 0, 8, 8, 8]
ENC_CH = (3, 16, 24, 32, 40, 48)
DEC_CH = (40, 32, 24, 16, 8)
CFG = {"name": "vqreptunet1x1v2", "params": {
    "encoder_name": "resnet18", "num_classes": 3, "subpixel_tail": True,
    "vq_cfg": {"num_embeddings": NUM_EMB, "kmeans_init": True}, "margin": 0.5, "scale": 30.0}}


def test_space_to_depth_puts_the_position_first():
    x = np.random.default_rng(0).standard_normal((2, 6, 8, 3)).astype(np.float32)
    b, h, w, c = x.shape
    want = x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5).reshape(
        b, h // 2, w // 2, 4 * c)  # the JAX package's decoder
    got = space_to_depth(nchw(x))
    np.testing.assert_array_equal(nhwc(got), want)
    assert not torch.equal(got, torch.nn.functional.pixel_unshuffle(nchw(x), 2))
    y = nhwc(got)
    back = y.reshape(b, h // 2, w // 2, 2, 2, c).transpose(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    np.testing.assert_array_equal(nhwc(depth_to_space(got)), back)
    np.testing.assert_array_equal(nhwc(depth_to_space(got)), x)


def _features(rng, hw=HW):
    return [rng.standard_normal((2, hw >> (i + 1), hw >> (i + 1), ch)).astype(np.float32)
            for i, ch in enumerate(ENC_CH[1:])]


@pytest.mark.parametrize("train", [False, True])
def test_decoder_matches_jax(train):
    feats = _features(np.random.default_rng(1))
    jdec = JaxDecoder(DEC_CH, subpixel_tail=True)
    v = to_np(seeded_variables(jdec, ([jnp.asarray(f) for f in feats],), train=True))
    assert v["params"]["block4"]["ConvBNReLU_0"]["ConvPad_0"]["Conv_0"]["kernel"].shape == (
        3, 3, DEC_CH[3] + 4 * ENC_CH[1], 4 * DEC_CH[4])
    out, mut = jdec.apply(v, [jnp.asarray(f) for f in feats], train=train,
                          mutable=["batch_stats"])
    dec = UnetDecoder(ENC_CH, DEC_CH, subpixel_tail=True)
    sd = {}
    convert._decoder(sd, "", v["params"], v["batch_stats"])
    dec.load_state_dict(sd)
    dec.train(train)
    with torch.no_grad():
        got = dec([nchw(f) for f in feats])
    assert got.shape == (2, DEC_CH[-1], HW // 2, HW // 2)
    np.testing.assert_allclose(nhwc(got), np.asarray(out), atol=1e-4)
    if train:
        want = {}
        convert._decoder(want, "", v["params"], to_np(mut["batch_stats"]))
        for key, t in dec.state_dict().items():
            if "running" in key:
                np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=key)


def test_the_tail_applies_where_jax_applies_it():
    assert UnetDecoder(ENC_CH, DEC_CH, subpixel_tail=True).subpixel
    assert not UnetDecoder(ENC_CH, DEC_CH[:1], subpixel_tail=True).subpixel
    assert not UnetDecoder(ENC_CH, DEC_CH, subpixel_tail=True, cca=[False] * 5).subpixel
    odd = _features(np.random.default_rng(2), hw=68)  # a 34x34 skip, then 17x17
    odd[0] = odd[0][:, :33]
    dec = UnetDecoder(ENC_CH, DEC_CH, subpixel_tail=True).eval()
    with pytest.raises(RuntimeError):
        dec([nchw(f) for f in odd])
    with pytest.raises(TypeError):
        jdec = JaxDecoder(DEC_CH, subpixel_tail=True)
        jdec.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in odd])


@pytest.fixture(scope="module")
def flagship():
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(2, HW, HW, 3)).astype(np.float32)
    gt = (np.arange(HW)[None, :, None] // 8 + rng.integers(0, 2, (2, HW, HW))) % 3
    jmodel = jax_make_model(CFG)
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x), jnp.asarray(gt), TH), train=True))
    for sub in v["codebook"]["core"].values():  # codes drawn among the features' scale
        sub["embedding"] *= np.float32(0.1)
    model = make_model(CFG, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    return jmodel, v, model, x, gt.astype(np.int32)


def test_flagship_forwards_match_jax(flagship):
    jmodel, v, model, x, gt = flagship
    jout = jmodel.apply(v, jnp.asarray(x), train=False)[0]
    out = model.eval()(nchw(x))[0]
    assert out.shape == (2, 3, HW, HW)
    np.testing.assert_allclose(nhwc(out.detach()), np.asarray(jout), atol=1e-4)
    (jo, jc, ju, jp), mut = jmodel.apply(v, jnp.asarray(x), jnp.asarray(gt), TH, train=True,
                                         mutable=["batch_stats"])
    o, c, u, p = model.train()(nchw(x), torch.from_numpy(gt).long(), TH, train=True)
    np.testing.assert_allclose(nhwc(o.detach()), np.asarray(jo), atol=1e-4)
    np.testing.assert_allclose(c.item(), float(jc), rtol=1e-5)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_allclose(p.item(), float(jp), rtol=1e-5)
    want = state_dict_from_flax({**v, "batch_stats": to_np(mut["batch_stats"])}, NUM_EMB)
    for key, t in model.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def _jax_grads(jmodel, v, x, gt, proj):
    def loss(params):
        (o, c, _, p), _ = jmodel.apply({**v, "params": params}, x, gt, TH, train=True,
                                       mutable=["batch_stats"])
        return jnp.sum(o * proj) + c + p

    return to_np(jax.grad(loss)(v["params"]))


def _port_grads(model, x, gt, proj):
    model.zero_grad(set_to_none=True)
    o, c, _, p = model.train()(x, gt, TH, train=True)
    (torch.sum(o * proj) + c + p).backward()
    return {n: q.grad for n, q in model.named_parameters()}


def test_train_gradients_match_jax(flagship):
    jmodel, v, model, x, gt = flagship
    proj = np.random.default_rng(4).standard_normal((2, HW, HW, 3)).astype(np.float32)
    j32 = state_dict_from_flax({**v, "params": _jax_grads(
        jmodel, v, jnp.asarray(x), jnp.asarray(gt), jnp.asarray(proj))}, NUM_EMB)
    with jax_f64():
        v64 = wide(v)
        j64 = state_dict_from_flax({**v64, "params": _jax_grads(
            jmodel, v64, jnp.asarray(x.astype(np.float64)), jnp.asarray(gt),
            jnp.asarray(proj.astype(np.float64)))}, NUM_EMB)
    g32 = _port_grads(model, nchw(x), torch.from_numpy(gt).long(), nchw(proj))
    with port_f64():
        model64 = make_model(CFG, device="cpu")
        model64.load_state_dict(state_dict_from_flax(v, NUM_EMB))
        model64.double()
        g64 = _port_grads(model64, nchw(x).double(), torch.from_numpy(gt).long(),
                          nchw(proj).double())
    tail = [n for n in g32 if n.startswith("core.decoder.blocks.4.")]
    assert tail
    for name, g in g32.items():
        want = j64[name].numpy()
        assert g.dtype == torch.float32 and g64[name].dtype == torch.float64
        assert rel(g64[name].numpy(), want) <= 1e-6, name
        assert rel(g.numpy(), want) <= 1e-4 + rel(j32[name].numpy(), want), name
