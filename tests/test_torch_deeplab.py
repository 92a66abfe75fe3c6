"""Port parity: the DeepLab modules of the ``semiweed`` slice against the
JAX package, on the CPU (helpers in ``_port_helpers.py``).

JAX's random draws cannot be matched, so the port starts from JAX's
variables (drawn from a numpy seed, ``_seeded_flax``), mapped by
``utils/convert.py``.  Dropout in training takes the masks flax drew
(recorded, ``record_dropout``).

Bounds:
  * the dilated resnet encoders (resnet18 at output stride 16 and 8,
    resnet50 at 16): every stage output's shape equal, in eval mode its
    values within 1e-5 relative L2; in train mode (batch statistics,
    ill-conditioned in f32: resnet50's f32 outputs and running variances
    differ by 3e-5 between the packages) the outputs and running
    statistics in f64 within 1e-10 of JAX's f64, in f32 within 1e-5 plus
    twice JAX's own f32 error of JAX's f64;
  * ``SegmentationHead`` (1x1 x4 and 3x3 x2 with a softmax): within 1e-6
    relative L2;
  * ``ASPP`` (separable and not), train and eval, and
    ``DeepLabV3PlusDecoder``: outputs within 1e-5 relative L2, running
    statistics within 1e-5; the ASPP in f64 in both packages within 1e-10
    (its pooled branch normalises over the batch alone: 2 values per
    channel here, where f32's one-pass variance loses most);
  * ``deeplabv3``, ``deeplabv3plus`` and ``semiweednet`` (resnet18, 64x64):
    eval forwards within 1e-5 relative L2; train forwards (``semiweednet``
    with ``issup`` and with its MLP), whose batch statistics are
    ill-conditioned in f32 (8.6e-5 between the packages for
    ``deeplabv3``), in f64 in both packages with the masks of JAX's f32
    run within 1e-7 (the JAX package's align-corners upsample keeps f32
    lerp weights in f64: 3e-8), and in f32 within 1e-5 plus twice JAX's
    own f32 error of JAX's f64, outputs, MLP projections and running
    statistics alike;
  * ``dc_loss`` and its gradients within 1e-6 relative.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.losses.dc import dc_loss as jax_dc_loss
from vq_seg_tpu.models.encoders import make_encoder as jax_make_encoder
from vq_seg_tpu.models.modules import heads as jheads
from vq_seg_tpu.models.networks import deeplabv3 as jdl
from vq_seg_tpu.models.networks import make_model as jax_make_model
from _port_helpers import (jax_f64, nchw, nhwc, rel, record_dropout, replay_dropout, take_masks,
                           to_np, wide)
from _seeded_flax import seeded_variables
from vq_seg_tpu_torch.losses import dc_loss
from vq_seg_tpu_torch.models.encoders import make_encoder
from vq_seg_tpu_torch.models.modules.heads import SegmentationHead
from vq_seg_tpu_torch.models.networks import deeplabv3 as tdl
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.utils import convert

torch.set_num_threads(1)


def _image(hw, seed=0, n=2):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def _check_stats(module, sd_fn, v, mut):
    want = sd_fn({**v, "batch_stats": to_np(mut["batch_stats"])})
    for key, t in module.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


# -- the encoder ---------------------------------------------------------------------


@pytest.mark.parametrize("name,output_stride,hw", [("resnet18", 16, 64), ("resnet18", 8, 64),
                                                   ("resnet50", 16, 64)])
def test_dilated_encoder_matches_jax(name, output_stride, hw):
    x = _image(hw, 1)
    jenc, jch = jax_make_encoder(name, 3, 5, output_stride=output_stride)
    v = to_np(seeded_variables(jenc, (jnp.asarray(x),), train=True))
    enc, ch = make_encoder(name, 3, 5, output_stride=output_stride)
    assert tuple(ch) == tuple(jch)

    def sd_fn(var):
        sd = {}
        convert._encoder(sd, "", var["params"], var["batch_stats"])
        return sd

    enc.load_state_dict(sd_fn(v))
    jeval = jax.jit(lambda vv, xx: jenc.apply(vv, xx, train=False))
    jtrain = jax.jit(lambda vv, xx: jenc.apply(vv, xx, train=True, mutable=["batch_stats"]))
    with torch.no_grad():
        feats = enc.eval()(nchw(x))
    jfeats = jeval(v, jnp.asarray(x))
    stride = [1, 2, 4, 8, min(16, output_stride), output_stride]
    for f, jf, s in zip(feats, jfeats, stride):
        assert nhwc(f).shape == np.asarray(jf).shape == (2, hw // s, hw // s, f.shape[1])
        assert rel(nhwc(f), jf) <= 1e-5
    jfeats, mut = jtrain(v, jnp.asarray(x))
    with torch.no_grad():
        feats = enc.train()(nchw(x))
    stats32 = {k: t.clone() for k, t in enc.state_dict().items() if "running" in k}
    # train-mode BN over few values per channel (8 at resnet50's deepest
    # stage here) makes f32 ill-conditioned: the semantics in f64 in both
    # packages, the f32 results within twice JAX's own f32 error of f64
    with jax_f64():
        j64, mut64 = jax.jit(lambda vv, xx: jenc.apply(vv, xx, train=True,
                                                       mutable=["batch_stats"]))(
            wide(v), jnp.asarray(x, jnp.float64))
    enc.load_state_dict(sd_fn(v))
    with torch.no_grad():
        feats64 = enc.double().train()(nchw(x).double())
    for f, f64, jf, jf64 in zip(feats, feats64, jfeats, j64):
        assert rel(nhwc(f64), jf64) <= 1e-10
        assert rel(nhwc(f), jf64) <= 1e-5 + 2 * rel(jf, jf64)
    want32 = sd_fn({**v, "batch_stats": to_np(mut["batch_stats"])})
    with mock.patch.object(convert, "_t", lambda a: torch.tensor(np.asarray(a, np.float64))):
        want64 = sd_fn({**v, "batch_stats": to_np(mut64["batch_stats"])})
    for key, t in enc.state_dict().items():  # the running statistics likewise
        if "running" in key:
            w64 = want64[key].numpy()
            assert rel(t.numpy(), w64) <= 1e-10, key
            assert rel(stats32[key].numpy(), w64) <= 1e-5 + 2 * rel(want32[key].numpy(),
                                                                    w64), key
    # the dilated stages: every 3x3 conv dilated, padding = dilation, and
    # the first block's 1x1 downsample kept at stride 1
    for layer, dil in ((enc.layer3, max(1, 16 // output_stride)),
                       (enc.layer4, 32 // output_stride)):
        convs = [m for m in layer.modules() if isinstance(m, torch.nn.Conv2d)
                 and m.kernel_size == (3, 3)]
        assert convs and all(m.dilation == (dil, dil) == m.padding for m in convs)
        if dil > 1:
            assert layer[0].downsample[0].stride == (1, 1)


# -- the modules ---------------------------------------------------------------------


@pytest.mark.parametrize("kernel,up,act", [(1, 4, None), (3, 2, "softmax")])
def test_segmentation_head_matches_jax(kernel, up, act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    jhead = jheads.SegmentationHead(3, kernel, up, (lambda y: jax.nn.softmax(y, -1)) if act
                                    else None)
    v = to_np(seeded_variables(jhead, (jnp.asarray(x),)))
    v["params"]["ConvPad_0"]["Conv_0"]["bias"] = rng.standard_normal(3).astype(np.float32)
    head = SegmentationHead(8, 3, kernel, up, (lambda y: torch.softmax(y, 1)) if act else None)
    sd = {}
    convert._conv(sd, "conv", v["params"]["ConvPad_0"]["Conv_0"])
    head.load_state_dict(sd)
    with torch.no_grad():
        out = head(nchw(x))
    want = np.asarray(jhead.apply(v, jnp.asarray(x)))
    assert nhwc(out).shape == want.shape == (2, 5 * up, 6 * up, 3)
    assert rel(nhwc(out), want) <= 1e-6  # JAX's upsample is a product by a lerp matrix


def _aspp_pair(separable, x, dtype=np.float32):
    jmod = jdl.ASPP(16, (1, 2, 3), separable=separable)
    v = to_np(seeded_variables(jmod, (jnp.asarray(x),), train=True))
    mod = tdl.ASPP(x.shape[-1], 16, (1, 2, 3), separable=separable)

    def sd_fn(var):
        sd = {}
        convert._aspp(sd, "", var["params"], var["batch_stats"])
        return {k[1:]: t for k, t in sd.items()}

    mod.load_state_dict(sd_fn(v))
    return jmod, v, mod, sd_fn


@pytest.mark.parametrize("separable", [False, True], ids=["plain", "separable"])
def test_aspp_matches_jax(separable):
    x = np.random.default_rng(3).standard_normal((2, 6, 6, 12)).astype(np.float32)
    jmod, v, mod, sd_fn = _aspp_pair(separable, x)
    jout = jmod.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = mod.eval()(nchw(x))
    assert rel(nhwc(out), jout) <= 1e-5
    with record_dropout():
        jout, mut = jax.jit(lambda vv, xx, k: jmod.apply(vv, xx, train=True,
                                                         mutable=["batch_stats"],
                                                         rngs={"dropout": k}))(
            v, jnp.asarray(x), jax.random.PRNGKey(4))
        jax.effects_barrier()
    [keep] = take_masks(1)
    assert 0.3 < float(keep.float().mean()) < 0.7
    out = mod.train()(nchw(x), train=True, dropout=lambda shape: keep)
    assert rel(nhwc(out.detach()), jout) <= 1e-5
    assert not (nhwc(out.detach()) != 0).all()  # the dropped values are zero
    _check_stats(mod, sd_fn, v, mut)
    # f64 in both packages: the pooled branch's batch-only statistics
    with jax_f64(), record_dropout():
        x64 = jnp.asarray(x, jnp.float64)
        j64 = jmod.apply(wide(v), x64, train=False)
        j64t, _ = jmod.apply(wide(v), x64, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(4)})
        jax.effects_barrier()
    [keep64] = take_masks(1)
    assert np.asarray(j64t).dtype == np.float64
    mod.load_state_dict(sd_fn(v))
    mod.double()
    with torch.no_grad():
        assert rel(nhwc(mod.eval()(nchw(x).double())), j64) <= 1e-10
        assert rel(nhwc(mod.train()(nchw(x).double(), train=True, dropout=lambda shape: keep64)),
                   j64t) <= 1e-10


def test_deeplabv3plus_decoder_matches_jax():
    rng = np.random.default_rng(5)
    hw = 64
    feats = [rng.standard_normal((2, hw // s, hw // s, c)).astype(np.float32)
             for s, c in ((1, 3), (2, 8), (4, 8), (8, 12), (16, 16), (16, 20))]
    jmod = jdl.DeepLabV3PlusDecoder(16, (1, 2, 3), 16)
    v = to_np(seeded_variables(jmod, ([jnp.asarray(f) for f in feats],), train=True))
    mod = tdl.DeepLabV3PlusDecoder([f.shape[-1] for f in feats], 16, (1, 2, 3), 16)

    def sd_fn(var):
        sd = {}
        convert._deeplab_decoder(sd, "", var["params"], var["batch_stats"])
        return {k[1:]: t for k, t in sd.items()}

    mod.load_state_dict(sd_fn(v))
    jf = [jnp.asarray(f) for f in feats]
    tf = [nchw(f) for f in feats]
    with torch.no_grad():
        out = mod.eval()(tf)
    jout = jmod.apply(v, jf, train=False)
    assert nhwc(out).shape == np.asarray(jout).shape == (2, 16, 16, 16)
    assert rel(nhwc(out), jout) <= 1e-5
    with record_dropout():
        jout, mut = jmod.apply(v, jf, train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(6)})
        jax.effects_barrier()
    [keep] = take_masks(1)
    with torch.no_grad():
        out = mod.train()(tf, train=True, dropout=lambda shape: keep)
    assert rel(nhwc(out), jout) <= 1e-5
    _check_stats(mod, sd_fn, v, mut)


# -- the networks --------------------------------------------------------------------

# the f64 bound past an align-corners upsample: the JAX package's lerp
# weights are f32 constants even in f64 (about 3e-8 relative)
F64_AC = 1e-7


@pytest.mark.parametrize("name", ["deeplabv3", "deeplabv3plus", "semiweednet"])
def test_network_forwards_match_jax(name):
    x = _image(64, 7)
    cfg = {"name": name, "params": {"encoder_name": "resnet18", "num_classes": 3}}
    jmodel = jax_make_model(cfg)
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x),), train=True))

    def sd_fn(var):
        return convert.state_dict_from_flax(var, None)

    def sd64(var):
        with mock.patch.object(convert, "_t", lambda a: torch.tensor(np.asarray(a, np.float64))):
            return sd_fn(var)

    model = make_model(cfg, device="cpu")
    model.load_state_dict(sd_fn(v))
    first = lambda o: o[0] if isinstance(o, tuple) else o
    with torch.no_grad():
        out = model.eval()(nchw(x))
    jout = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=False))(v, jnp.asarray(x))
    assert rel(nhwc(first(out)), first(jout)) <= 1e-5
    # train forwards: batch statistics over few values (deeplabv3's ASPP
    # pools a 2x2 map: 2 values per channel) make f32 ill-conditioned, so
    # the semantics are held in f64 in both packages with the masks JAX's
    # f32 run drew, and the f32 results within twice JAX's own f32 error
    for kw in ([{}] if name != "semiweednet" else [{"issup": True}, {}]):
        with record_dropout():
            jout, mut = jax.jit(lambda vv, xx, k: jmodel.apply(
                vv, xx, train=True, mutable=["batch_stats"], rngs={"dropout": k}, **kw))(
                v, jnp.asarray(x), jax.random.PRNGKey(8))
            jax.effects_barrier()
        [keep] = take_masks(1)
        with jax_f64(), replay_dropout([nhwc(keep)]):
            j64, mut64 = jmodel.apply(wide(v), jnp.asarray(x, jnp.float64), train=True,
                                      mutable=["batch_stats"],
                                      rngs={"dropout": jax.random.PRNGKey(8)}, **kw)
        model.load_state_dict(sd_fn(v))
        with torch.no_grad():
            out = model.float().train()(nchw(x), train=True, dropout=lambda shape: keep, **kw)
            stats32 = {k: t.clone() for k, t in model.state_dict().items() if "running" in k}
            model.load_state_dict(sd_fn(v))
            out64 = model.double().train()(nchw(x).double(), train=True, dropout=lambda shape: keep, **kw)
        pairs = [(first(out), first(out64), first(jout), first(j64), nhwc)]
        if name == "semiweednet" and not kw:
            pairs.append((out[1], out64[1], jout[1], j64[1], lambda t: t.numpy()))
        elif name != "deeplabv3":
            assert out[1] is None and jout[1] is None
        for t32, t64, w32, w64, fmt in pairs:
            assert rel(fmt(t64), w64) <= F64_AC
            assert rel(fmt(t32), w64) <= 1e-5 + 2 * rel(w32, w64)
        want32 = sd_fn({**v, "batch_stats": to_np(mut["batch_stats"])})
        want64 = sd64({**v, "batch_stats": to_np(mut64["batch_stats"])})
        for key, t in model.state_dict().items():
            if "running" in key:
                w64 = want64[key].numpy()
                assert rel(t.numpy(), w64) <= F64_AC, key
                assert rel(stats32[key].numpy(), w64) <= 1e-5 + 2 * rel(want32[key].numpy(),
                                                                        w64), key


def test_dc_loss_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.uniform(0.1, 1.0, (5, 7)).astype(np.float32)
    b = rng.uniform(0.1, 1.0, (5, 7)).astype(np.float32)
    jl, (ga, gb) = jax.value_and_grad(jax_dc_loss, argnums=(0, 1))(jnp.asarray(a),
                                                                    jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    loss = dc_loss(ta, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    assert rel(ta.grad.numpy(), ga) <= 1e-6 and rel(tb.grad.numpy(), gb) <= 1e-6
