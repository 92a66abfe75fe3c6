"""Port parity: the ``supconcps`` slice's loss and network against the JAX
package, on the CPU at resnet18 / K=8 / 64x64 (helpers in
``_port_helpers.py``; the step and the driver are in
``test_torch_supcon_train.py``).

JAX's random draws cannot be matched, so the port starts from JAX's
variables, mapped by ``state_dict_from_flax``.

Bounds:
  * ``supcon_loss`` at an odd grid (7x9, labels at 14x18 resized by the
    half-pixel nearest rule), in one block and in blocks of 5 rows (the
    last one ragged), at two feature scales: in f64 in both packages the
    loss and the gradient within 1e-8 (when nearly all the mass is on
    positive pairs JAX's f64 keeps the cancellations described in
    ``losses/contrastive.py``: about 1e-9); in f32 within 1e-5 plus twice
    JAX's own f32 error of JAX's f64, and within 1e-5 of JAX's f32 where
    that is accurate; where every positive pair underflows JAX's f32 (its
    loss +inf, its gradient NaN), the port's equals JAX's f64 within
    1e-5;
  * ``supconvqunet``'s eval and train forwards (the ``"label"`` split with
    labels, and without a split): scores within 1e-4, commit within 1e-5
    relative, each VQ stage's idx and the usage vector exactly equal; the
    contrastive loss (the train-mode features times 1 / 0.04: 2e-5 between
    the packages in f32) in f64 in both within 1e-10, in f32 within 1e-5
    plus twice JAX's own f32 error of JAX's f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.losses.contrastive import supcon_loss as jax_supcon_loss
from vq_seg_tpu.models.networks import make_model as jax_make_model
from _port_helpers import jax_f64, nchw, nhwc, port_f64, rel, to_np, wide
from _seeded_flax import seeded_variables
from _slice_parity import NUM_EMB
from vq_seg_tpu_torch.losses.contrastive import supcon_loss
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

@pytest.mark.parametrize("scale", [0.1, 0.5], ids=["spread", "peaked"])
@pytest.mark.parametrize("block_rows", [4096, 5], ids=["one-block", "blocks-of-5"])
def test_supcon_loss_matches_jax(block_rows, scale):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 7, 9, 6)) * scale).astype(np.float32)
    label = rng.integers(0, 3, size=(3, 14, 18)).astype(np.int32)
    jl, jg = jax.value_and_grad(jax_supcon_loss)(jnp.asarray(x), jnp.asarray(label))
    with jax_f64():
        jl64, jg64 = jax.value_and_grad(jax_supcon_loss)(jnp.asarray(x, jnp.float64),
                                                         jnp.asarray(label))
    xt = nchw(x).requires_grad_(True)
    loss = supcon_loss(xt, torch.from_numpy(label).long(), block_rows=block_rows)
    loss.backward()
    assert not nhwc(xt.grad)[2].any()  # only the first two items enter
    x64 = nchw(x).double().requires_grad_(True)
    loss64 = supcon_loss(x64, torch.from_numpy(label).long(), block_rows=block_rows)
    loss64.backward()
    # when peaked the f64 loss is an ulp-scale log of a ratio near 1 and
    # JAX's f64 gradient keeps the cancellation of two reciprocals: JAX's
    # f64 moves by about 1e-9 with the summation order
    assert abs(loss64.item() - float(jl64)) <= 1e-8 * abs(float(jl64))
    assert rel(nhwc(x64.grad), jg64) <= 1e-8
    # f32: within 1e-5 plus twice JAX's own f32 error of JAX's f64; where
    # JAX's f32 is accurate ("spread") also within 1e-5 of it, where it is
    # rounding noise ("peaked": loss 3e-11, gradient 3 % from f64) within
    # 1e-5 of JAX's f64
    own_loss = abs(float(jl) / float(jl64) - 1)
    own = rel(jg, jg64)
    assert abs(loss.item() / float(jl64) - 1) <= 1e-5 + 2 * own_loss
    assert rel(nhwc(xt.grad), jg64) <= 1e-5 + 2 * own
    if scale == 0.1:
        assert own <= 1e-5 and own_loss <= 1e-5
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        assert rel(nhwc(xt.grad), jg) <= 1e-5
    else:
        assert own > 1e-2
        assert abs(loss.item() / float(jl64) - 1) <= 1e-5
        assert rel(nhwc(xt.grad), jg64) <= 1e-5


def test_supcon_loss_stays_finite_where_jax_underflows():
    """Every positive pair's logit 250 below the largest (a negative pair):
    JAX's f32 ``exp`` underflows, its loss is +inf and its gradient NaN;
    the port's equals JAX's f64."""
    a = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    b = np.array([[0.0, 1.0], [1.0, 0.0], [-1.0, -1.0]])
    x = np.stack([a, b]).reshape(2, 1, 3, 2).astype(np.float32) * np.float32(np.sqrt(10.0))
    label = np.array([[[0, 1, 2]], [[0, 1, 2]]], np.int32)  # positives: the diagonal
    jl, jg = jax.value_and_grad(jax_supcon_loss)(jnp.asarray(x), jnp.asarray(label))
    assert np.isinf(float(jl)) and np.isnan(np.asarray(jg)).any()
    with jax_f64():
        jl64, jg64 = jax.value_and_grad(jax_supcon_loss)(jnp.asarray(x, jnp.float64),
                                                         jnp.asarray(label))
    xt = nchw(x).requires_grad_(True)
    loss = supcon_loss(xt, torch.from_numpy(label).long())
    loss.backward()
    assert np.isfinite(loss.item()) and torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(loss.item(), float(jl64), rtol=1e-5)
    assert rel(nhwc(xt.grad), jg64) <= 1e-5


def _model_cfg():
    return {"name": "supconvqunet", "params": {
        "encoder_name": "resnet18", "num_classes": 3,
        "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True}}}


def _vq_idx_hooks(model):
    seen = []
    for i, k in enumerate(NUM_EMB):
        if k:
            model.core.codebooks[i].register_forward_hook(
                lambda m, a, out: seen.append(out[1].numpy().copy()))
    return seen


def test_supconvqunet_forwards_match_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    gt = ((np.arange(64)[None, :, None] // 8 + rng.integers(0, 2, size=(2, 64, 64))) % 3
          ).astype(np.int32)
    cfg = _model_cfg()
    jmodel = jax_make_model(cfg)
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x), jnp.asarray(gt), "label"), train=True))
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    idx = _vq_idx_hooks(model)
    is_vq = lambda mdl, _: type(mdl).__name__ == "VectorQuantizer"

    def jfwd(*args, **kw):
        out, st = jmodel.apply(v, *args, capture_intermediates=is_vq,
                               mutable=["intermediates", "batch_stats"], **kw)
        inter = st["intermediates"]["core"]
        return out, [np.asarray(inter[f"VectorQuantizer_{n}"]["__call__"][0][1])
                     for n in range(3)]

    for split, train in ((None, False), ("label", True), (None, True)):
        idx.clear()
        (jout, jc, ju, jaux), jidx = jfwd(jnp.asarray(x), jnp.asarray(gt), split, train=train)
        model.train(train)
        with torch.no_grad():
            out, c, u, aux = model(nchw(x), torch.from_numpy(gt).long(), split, train=train)
        np.testing.assert_allclose(nhwc(out), np.asarray(jout), atol=1e-4)
        np.testing.assert_allclose(c.item(), float(jc), rtol=1e-5, atol=1e-12)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        assert len(idx) == 3
        for got, want in zip(idx, jidx):
            np.testing.assert_array_equal(got, want)
        if split != "label":
            assert aux.item() == 0.0 == float(jaux)
            continue
        # the contrastive loss multiplies the decoder's train-mode (batch
        # statistics) features by 1 / 0.04: its f32 value moves by 2e-5
        # between the packages, so it is held in f64 in both, and in f32
        # within twice JAX's own f32 error
        assert aux.item() > 0.0
        with jax_f64():
            j64 = jax.jit(lambda vv, xx, gg: jmodel.apply(
                vv, xx, gg, "label", train=True, mutable=["batch_stats"])[0][3])(
                wide(v), jnp.asarray(x, jnp.float64), jnp.asarray(gt))
        m64 = make_model(cfg, device="cpu")
        m64.load_state_dict(state_dict_from_flax(v, NUM_EMB))
        with torch.no_grad(), port_f64():
            aux64 = m64.double().train()(nchw(x).double(), torch.from_numpy(gt).long(),
                                         "label", train=True)[3]
        assert abs(aux64.item() - float(j64)) <= 1e-10 * float(j64)
        assert abs(aux.item() - float(j64)) <= (1e-5 + 2 * abs(float(jaux) / float(j64) - 1)) \
            * float(j64)
