"""Port parity: the flagship network ``VQRePTUnet1x1v2`` and its vector
quantizer against the JAX package, f32 on the CPU, at resnet18 / K=8 / 64x64.

The JAX variables (after JAX's own k-means codebook init phase) are carried
across by ``state_dict_from_flax``.  Bounds: the same VQ idx exactly, and
|dlogits|max <= 1e-3 for the whole eval forward.
"""
import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.models.modules.vector_quantizer import VectorQuantizer as JaxVQ
from vq_seg_tpu.models.networks import make_model as jax_make_model
from vq_seg_tpu_torch.losses import make_loss
from vq_seg_tpu_torch.models.modules.vector_quantizer import VectorQuantizer, make_vq_module
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.training import create_cps_state
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

HW = 64
NUM_EMB = [0, 0, 8, 8, 8]
MODEL_CFG = {"name": "vqreptunet1x1v2", "params": {
    "encoder_name": "resnet18", "num_classes": 3,
    "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True},
    "margin": 0.5, "scale": 30.0}}


def _randomize_bn(params, stats, rng):
    for k in params:
        if isinstance(params[k], dict) and "scale" in params[k]:
            c = params[k]["scale"].shape
            params[k] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                         "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
            stats[k] = {"mean": (rng.standard_normal(c) * 0.1).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        elif isinstance(params[k], dict) and k in stats:
            _randomize_bn(params[k], stats[k], rng)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()


def build_flagship(seed=0):
    """JAX model and variables after its codebook init phase, the port model
    carrying the same weights, and the batch the init phase saw (NHWC)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(2, HW, HW, 3)).astype(np.float32)
    jmodel = jax_make_model(MODEL_CFG)
    v = jax.tree_util.tree_map(np.array, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    _randomize_bn(v["params"], v["batch_stats"], rng)
    _, mut = jmodel.apply(v, jnp.asarray(x), init_codebook=True, mutable=["codebook"],
                          rngs={"kmeans": jax.random.PRNGKey(1)})
    v["codebook"] = jax.tree_util.tree_map(np.array, mut["codebook"])
    model = make_model(MODEL_CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))  # strict
    return jmodel, v, model, x


@pytest.fixture(scope="module")
def flagship():
    return build_flagship()


def test_eval_forward_matches_jax(flagship):
    jmodel, v, model, x = flagship
    jout, jcommit, jusage, jproto = jmodel.apply(v, jnp.asarray(x), train=False)
    out, commit, usage, proto = model(_nchw(x))
    assert out.shape == (2, 3, HW, HW)
    d = np.abs(out.detach().permute(0, 2, 3, 1).numpy() - np.asarray(jout)).max()
    assert d <= 1e-3, d
    np.testing.assert_array_equal(usage.numpy(), np.asarray(jusage))
    assert float(commit) == float(jcommit) == 0.0
    assert float(proto) == float(jproto) == 0.0


def test_train_forward_commitment_matches_jax(flagship):
    """train=True: batch-stat BN, the STE and the commitment loss divided by
    the number of stages."""
    jmodel, v, model, x = flagship
    (jout, jcommit, jusage, _), _ = jmodel.apply(v, jnp.asarray(x), train=True,
                                                 mutable=["batch_stats"])
    m = copy.deepcopy(model).train()
    out, commit, usage, _ = m(_nchw(x), train=True)
    assert commit.item() > 0
    np.testing.assert_allclose(commit.item(), float(jcommit), rtol=1e-4)
    np.testing.assert_array_equal(usage.numpy(), np.asarray(jusage))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jout),
                               atol=1e-3)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
@pytest.mark.parametrize("stage", [2, 3, 4])
def test_vector_quantizer_alone_gives_the_same_idx(flagship, stage, distance):
    """JAX's VQUnetCore drops idx, so the quantizers are applied alone to the
    same stage features and codebook (the flagship's k-means codebook; the
    cosine quantizers normalise it)."""
    _, _, model, x = flagship
    with torch.no_grad():
        feats = model.core.encoder(_nchw(x))[1:]
    f = feats[stage]
    vq = model.core.codebooks[stage]
    cb = vq.embedding.numpy()
    if distance == "cosine":
        vq = VectorQuantizer(f.shape[1], 8, kmeans_init=True, distance="cosine")
        vq.embedding.copy_(torch.from_numpy(cb))
    f_nhwc = f.permute(0, 2, 3, 1).numpy()
    jvq = JaxVQ(dim=f.shape[1], num_embeddings=8, kmeans_init=True, distance=distance)
    wq, widx, wloss, wusage = jvq.apply({"codebook": {"embedding": cb}}, jnp.asarray(f_nhwc))
    q, idx, loss, usage = vq(f)
    assert idx.dtype == torch.int32 and idx.shape == f.shape[:1] + f.shape[2:]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    if distance == "euclidean":
        np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), np.asarray(wq))
    else:  # the two l2norms of the codebook reduce in another order: an ulp apart
        np.testing.assert_allclose(q.permute(0, 2, 3, 1).numpy(), np.asarray(wq), atol=1e-6)
    assert float(usage) == float(wusage)

    # train: STE value and gradient, commitment loss
    rng = np.random.default_rng(stage)
    w = rng.standard_normal(f_nhwc.shape).astype(np.float32)

    def jax_fn(xx):
        qq, _, ll, _ = jvq.apply({"codebook": {"embedding": cb}}, xx, train=True)
        return jnp.sum(qq * w) + ll, ll

    (_, jl), jg = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(f_nhwc))
    ft = f.clone().requires_grad_(True)
    q, _, loss, _ = vq(ft, train=True)
    (torch.sum(q * _nchw(w)) + loss).backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ft.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg), atol=1e-6)


def test_codebook_init_phase_is_seeded_and_uses_the_features(flagship):
    _, _, model, x = flagship
    a, b = copy.deepcopy(model), copy.deepcopy(model)
    a.init_codebook_(_nchw(x), torch.Generator().manual_seed(3))
    b.init_codebook_(_nchw(x), torch.Generator().manual_seed(3))
    with torch.no_grad():
        feats = a.core.encoder(_nchw(x))[1:]
    for stage in (2, 3, 4):
        cb_a, cb_b = a.core.codebooks[stage].embedding, b.core.codebooks[stage].embedding
        assert torch.equal(cb_a, cb_b)
        rows = feats[stage].permute(0, 2, 3, 1).reshape(-1, cb_a.shape[1])
        # every code is the mean of a subset of the rows: inside their box
        assert (cb_a >= rows.min(0).values - 1e-5).all() and (cb_a <= rows.max(0).values + 1e-5).all()
    # the first two stages pass through
    assert list(a.core.codebooks[0].state_dict()) == list(a.core.codebooks[1].state_dict()) == []


def test_what_is_not_ported_raises():
    with pytest.raises(KeyError):  # every network of the JAX registry is ported
        make_model({"name": "no_such_network", "params": {}}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VectorQuantizer(8, 4, ema=True)
    with pytest.raises(ValueError):
        VectorQuantizer(8, 4, distance="manhattan")
    with pytest.raises(ValueError):
        make_vq_module({"num_embeddings": [4, 4]}, [3, 8, 8, 8], 3)
    with pytest.raises(ValueError, match="unknown loss"):
        make_loss("no_such_loss", 3)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_model(MODEL_CFG)


def test_unresolvable_encoder_weights_warn(tmp_path, monkeypatch):
    """A pretrained tag that resolves to no file warns and leaves the drawn
    weights: training proceeds from scratch, as in the JAX package."""
    monkeypatch.setenv("VQ_SEG_PRETRAINED_DIR", str(tmp_path))
    with pytest.warns(UserWarning, match="FROM SCRATCH"):
        st = create_cps_state(MODEL_CFG, lambda step: 1e-4, encoder_weights="imagenet_swsl",
                              device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plain = create_cps_state(MODEL_CFG, lambda step: 1e-4, device="cpu")
    for model, other in ((st.model_1, plain.model_1), (st.model_2, plain.model_2)):
        want = other.state_dict()
        for k, t in model.state_dict().items():
            assert torch.equal(t, want[k]), k


def test_state_dict_from_flax_checks_the_vq_stages(flagship):
    _, v, _, _ = flagship
    with pytest.raises(ValueError, match="codebooks"):
        state_dict_from_flax(v, [0, 8, 8, 8, 8])
