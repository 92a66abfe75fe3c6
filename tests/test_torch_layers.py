"""Port parity: layers and the resnet encoder (``vq_seg_tpu_torch/models``)
against the JAX package, f32 on the CPU.  Layers hold to 1e-5, every resnet18
encoder stage to 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.models import layers as jl
from vq_seg_tpu.models.encoders import make_encoder as jax_make_encoder
from vq_seg_tpu_torch.models import layers as tl
from vq_seg_tpu_torch.models.encoders import make_encoder
from vq_seg_tpu_torch.utils.convert import _bn, _conv, _encoder

torch.set_num_threads(1)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def _x(shape=(2, 9, 11, 5), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _random_bn(shape_c, rng):
    p = {"scale": rng.uniform(0.5, 1.5, shape_c).astype(np.float32),
         "bias": rng.standard_normal(shape_c).astype(np.float32) * 0.1}
    s = {"mean": rng.standard_normal(shape_c).astype(np.float32) * 0.1,
         "var": rng.uniform(0.5, 1.5, shape_c).astype(np.float32)}
    return p, s


def _randomize_bn_tree(params, stats, rng):
    """Give every BatchNorm of a flax tree random scale/bias/mean/var so eval
    BN is not the identity."""
    for k in params:
        if isinstance(params[k], dict) and "scale" in params[k]:
            params[k], stats[k] = _random_bn(params[k]["scale"].shape, rng)
        elif isinstance(params[k], dict) and k in stats:
            _randomize_bn_tree(params[k], stats[k], rng)


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate", "circular"])
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (7, 2, 3), (1, 2, 0)])
def test_convpad_matches_jax(mode, k, stride, pad):
    x = _x()
    jmod = jl.ConvPad(6, k, stride, pad, padding_mode=mode)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    conv = tl.ConvPad(5, 6, k, stride, pad, padding_mode=mode)
    sd = {}
    _conv(sd, "c", jax.tree_util.tree_map(np.asarray, v["params"]["Conv_0"]))
    conv.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(conv(_nchw(x))), want, atol=1e-5)


def test_batchnorm_and_convbnrelu_eval_match_jax():
    rng = np.random.default_rng(1)
    x = _x(seed=1)
    p, s = _random_bn((5,), rng)
    jbn = jl.BatchNorm()
    want = jbn.apply({"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": s}},
                     jnp.asarray(x), train=False)
    bn = tl.batch_norm(5).eval()
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    np.testing.assert_allclose(_nhwc(bn(_nchw(x))), np.asarray(want), atol=1e-5)

    jcbr = jl.ConvBNReLU(7)
    v = jcbr.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False)
    v = jax.tree_util.tree_map(np.array, v)
    v["params"]["BatchNorm_0"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"]["BatchNorm_0"] = \
        _random_bn((7,), rng)
    want = jcbr.apply(v, jnp.asarray(x), train=False)
    cbr = tl.ConvBNReLU(5, 7).eval()
    sd = {}
    _conv(sd, "conv", v["params"]["ConvPad_0"]["Conv_0"])
    _bn(sd, "bn", v["params"]["BatchNorm_0"]["BatchNorm_0"],
        v["batch_stats"]["BatchNorm_0"]["BatchNorm_0"])
    cbr.load_state_dict(sd)
    got = _nhwc(cbr(_nchw(x)))
    assert (got >= 0).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 9, 11, 5), (1, 16, 16, 3)])
def test_max_pool_same_matches_jax(shape):
    x = _x(shape, seed=3)
    want = np.asarray(jl.max_pool_same(jnp.asarray(x), 3, 2, 1))
    np.testing.assert_array_equal(_nhwc(tl.max_pool_same(_nchw(x), 3, 2, 1)), want)


@pytest.mark.parametrize("size", [(18, 22), (20, 7), (4, 5), (9, 11)])
def test_resize_bilinear_matches_jax(size):
    x = _x(seed=4)
    want = np.asarray(jl.resize_bilinear(jnp.asarray(x), size))
    np.testing.assert_allclose(_nhwc(tl.resize_bilinear(_nchw(x), size)), want, atol=1e-5)


@pytest.mark.parametrize("channels", [3, 130])  # matmul form (C < 128) and gather+lerp
@pytest.mark.parametrize("scale,size", [(2, None), (None, (13, 30))])
def test_upsample_bilinear_ac_matches_jax(channels, scale, size):
    x = _x((2, 6, 8, channels), seed=5)
    want = np.asarray(jl.upsample_bilinear_ac(jnp.asarray(x), scale=scale, size=size))
    got = _nhwc(tl.upsample_bilinear_ac(_nchw(x), scale=scale, size=size))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_init_functions_match_the_jax_distributions():
    g = torch.Generator().manual_seed(0)
    w = tl.kaiming_normal(torch.empty(64, 32, 3, 3), g)
    jw = np.asarray(jl.kaiming_normal(jax.random.PRNGKey(0), (3, 3, 32, 64)))
    assert w.std().item() == pytest.approx(np.sqrt(2.0 / (64 * 9)), rel=0.05)
    assert w.std().item() == pytest.approx(float(jw.std()), rel=0.05)
    u = tl.torch_conv_default(torch.empty(64, 32, 3, 3), g)
    ju = np.asarray(jl.torch_conv_default(jax.random.PRNGKey(1), (3, 3, 32, 64)))
    bound = 1.0 / np.sqrt(32 * 9)
    assert u.abs().max().item() <= bound and float(np.abs(ju).max()) <= bound
    assert u.std().item() == pytest.approx(float(ju.std()), rel=0.05)


def test_convpad_rejects_unknown_padding_mode():
    with pytest.raises(ValueError):
        tl.ConvPad(3, 4, 3, 1, 1, padding_mode="mirror")


def test_resnet18_encoder_stages_match_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jenc, jch = jax_make_encoder("resnet18", padding_mode="reflect")
    v = jax.tree_util.tree_map(np.array, jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    _randomize_bn_tree(v["params"], v["batch_stats"], rng)
    want = jenc.apply(v, jnp.asarray(x), train=False)

    enc, ch = make_encoder("resnet18", padding_mode="reflect")
    assert tuple(ch) == tuple(jch)
    sd = {}
    _encoder(sd, "", v["params"], v["batch_stats"])
    enc.load_state_dict(sd)  # strict: the names line up one to one
    got = enc.eval()(_nchw(x))
    assert len(got) == len(want) == 6
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_nhwc(g_), np.asarray(w_), atol=1e-4)


def test_make_encoder_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_encoder("vgg16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_encoder("ccavqresnet50")
