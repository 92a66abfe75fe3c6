"""Port parity: the angular slice (``angularv3`` and the networks of
``vqreptunetangular.json`` and ``vqreptunetangularv3.json``; the
``reptcps`` step of the first is in ``test_torch_angular_rept.py``, the
``angularv3`` step and driver in ``test_torch_angular_train.py``)
against the JAX package, on the CPU at resnet18 /
K=8 / 64x64, batch 2 labeled + 2 unlabeled (helpers in
``_slice_parity.py`` and ``_vqpt_parity.py``).

JAX's random draws cannot be matched, so the port starts from JAX's
variables, mapped by ``state_dict_from_flax``.  ``scale`` 30 with an
ArcFace margin makes these heads' f32 results ill-conditioned, so their
semantics are held in f64 in both packages and the f32 results within
twice JAX's own f32 error of JAX's f64.

Bounds:
  * ``AngularSegmentationHeadv3`` on the labeled split, and on the
    unlabeled split with a score map at threshold 0 and 0.5 (labels and
    mask at twice the conv's grid, by the half-pixel nearest rule): scores
    within 1e-6; loss and the gradients of the input, the conv and the
    embedding in f64 within 1e-10 relative, in f32 within 1e-5 plus twice
    JAX's own f32 error;
  * ``vqreptunetangular`` (eval, train at percent 100 and 80) and
    ``vqreptunetangularv3`` (eval, labeled, unlabeled at threshold 0.5):
    commit within 1e-5 relative, each VQ stage's idx and the usage vector
    exactly equal; in f64 in both packages the scores within 1e-6 and the
    angular loss within 1e-9 relative; in f32 the scores within 1e-4 and
    the loss within 1e-5 plus twice JAX's own f32 error, except at percent
    80, where the preliminary pass's entropies (all near log 3) crowd the
    percentile and which rows are kept turns on f32 rounding in each
    package (f64 only); the embedding gets its gradient through the real
    pass, not the preliminary one;
  * the threshold of epochs 0, 1, 69, 70 and 399 equals the JAX driver's
    expression.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_seg_tpu.models.modules import heads as jheads
from vq_seg_tpu.models.networks import make_model as jax_make_model
from _port_helpers import jax_f64, nchw, nhwc, port_f64, rel, to_np, wide
from _seeded_flax import seeded_variables
from _slice_parity import NUM_EMB
from vq_seg_tpu_torch.models.modules import heads as theads
from vq_seg_tpu_torch.models.networks import make_model
from vq_seg_tpu_torch.training import angularv3_threshold
from vq_seg_tpu_torch.utils.convert import state_dict_from_flax

torch.set_num_threads(1)

# -- the v3 head ----------------------------------------------------------------------


def _head_case(split, th):
    rng = np.random.default_rng(6)
    n, h, w, cin, c, k = 2, 8, 8, 6, 5, 3
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    if split == "labeled":
        pred = rng.integers(0, k, size=(n, 2 * h, 2 * w)).astype(np.int32)
    else:  # another model's score map at the output size
        logits = rng.standard_normal((n, 2 * h, 2 * w, k)) * 2.0
        pred = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1), np.float32)
    params = {"ConvPad_0": {"Conv_0": {
        "kernel": (rng.standard_normal((1, 1, cin, c)) * 0.3).astype(np.float32),
        "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}},
        "embedding": rng.standard_normal((k, c)).astype(np.float32)}
    return x, pred, params


@pytest.mark.parametrize("split,th", [("labeled", 0.0), ("unlabeled", 0.0),
                                      ("unlabeled", 0.5)])
def test_angular_head_v3_matches_jax(split, th):
    x, pred, params = _head_case(split, th)
    k, c, cin = 3, 5, 6
    jhead = jheads.AngularSegmentationHeadv3(num_classes=k, out_channels=c, scale=30.0,
                                             margin=0.5, upsampling=1)

    def run_jax(xx, pp, pr):
        def fn(a, b):
            return jhead.apply({"params": b}, a, pr, split, th, train=True)
        (jres, jl), vjp = jax.vjp(fn, xx, pp)
        gx, gp = vjp((jnp.zeros_like(jres), jnp.ones_like(jl)))
        return jres, jl, gx, gp

    jres, jl, jgx, jgp = run_jax(jnp.asarray(x), params, jnp.asarray(pred))
    with jax_f64():
        _, jl64, jgx64, jgp64 = run_jax(jnp.asarray(x, jnp.float64), wide(params),
                                        jnp.asarray(wide(pred)))
    conv = params["ConvPad_0"]["Conv_0"]
    sd = {"embedding": torch.tensor(params["embedding"]),
          "conv.weight": torch.tensor(np.transpose(conv["kernel"], (3, 2, 0, 1))),
          "conv.bias": torch.tensor(conv["bias"])}

    def run_port(dtype):
        head = theads.AngularSegmentationHeadv3(cin, k, out_channels=c, scale=30.0, margin=0.5)
        head.load_state_dict(sd)
        head.to(dtype)
        xt = nchw(x).to(dtype).requires_grad_(True)
        pt = torch.from_numpy(pred).long() if split == "labeled" else nchw(pred).to(dtype)
        with port_f64():
            res, loss = head(xt, pt, split, th, train=True)
        loss.backward()
        grads = {"x": nhwc(xt.grad), **{n: p.grad.numpy() for n, p in head.named_parameters()}}
        return res, loss, grads

    res, loss, grads = run_port(torch.float32)
    _, loss64, grads64 = run_port(torch.float64)
    np.testing.assert_allclose(nhwc(res), np.asarray(jres), atol=1e-6)
    assert abs(loss64.item() - float(jl64)) <= 1e-10 * abs(float(jl64))
    own = abs(float(jl) / float(jl64) - 1)
    assert abs(loss.item() / float(jl64) - 1) <= 1e-5 + 2 * own
    t = lambda g: np.transpose(np.asarray(g), (3, 2, 0, 1))
    want32 = {"x": jgx, "embedding": jgp["embedding"],
              "conv.weight": t(jgp["ConvPad_0"]["Conv_0"]["kernel"]),
              "conv.bias": jgp["ConvPad_0"]["Conv_0"]["bias"]}
    want64 = {"x": jgx64, "embedding": jgp64["embedding"],
              "conv.weight": t(jgp64["ConvPad_0"]["Conv_0"]["kernel"]),
              "conv.bias": jgp64["ConvPad_0"]["Conv_0"]["bias"]}
    for name in want64:
        w64 = np.asarray(want64[name])
        assert np.abs(w64).max() > 0, name
        assert rel(grads64[name], w64) <= 1e-10, name
        assert rel(grads[name], w64) <= 1e-5 + 2 * rel(want32[name], w64), name
    # the mask at th 0.5 drops some pixels and keeps others
    if th > 0:
        kept = np.asarray(jax.nn.softmax(jnp.asarray(pred), -1)).max(-1) > th
        assert 0 < kept.mean() < 1


def test_angular_threshold_ramp_matches_the_jax_driver():
    for epoch, num_epochs in ((0, 400), (1, 400), (69, 400), (70, 400), (399, 400), (0, 1)):
        want = float(jnp.float32((epoch + 1) / num_epochs if epoch < 70 else 0.7))
        assert angularv3_threshold(epoch, num_epochs) == want


# -- the networks ---------------------------------------------------------------------


def _model_cfg(name):
    return {"name": name, "params": {
        "encoder_name": "resnet18", "num_classes": 3, "margin": 0.5, "scale": 30.0,
        "vq_cfg": {"num_embeddings": NUM_EMB, "distance": "euclidean", "kmeans_init": True}}}


def _net_batch(seed=4):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    lab = ((np.arange(64)[None, :, None] // 8 + rng.integers(0, 2, size=(2, 64, 64))) % 3
           ).astype(np.int32)
    scores = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal((2, 64, 64, 3)) * 2), -1),
                        np.float32)
    return img, lab, scores


def _idx_hooks(model):
    seen = []
    for i, k in enumerate(NUM_EMB):
        if k:
            model.core.codebooks[i].register_forward_hook(
                lambda m, a, out: seen.append(out[1].numpy().copy()))
    return seen


@pytest.mark.parametrize("name", ["vqreptunetangular", "vqreptunetangularv3"])
def test_angular_network_forwards_match_jax(name):
    x, gt, scores = _net_batch()
    cfg = _model_cfg(name)
    jmodel = jax_make_model(cfg)
    extra = (jnp.asarray(gt), 100.0) if name == "vqreptunetangular" else (jnp.asarray(gt),)
    v = to_np(seeded_variables(jmodel, (jnp.asarray(x), *extra), train=True))
    model = make_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
    idx = _idx_hooks(model)
    is_vq = lambda mdl, _: type(mdl).__name__ == "VectorQuantizer"

    def jfwd(variables, x_in, *args, train):
        """The JAX forward, compiled whole (its non-array arguments
        static), and each VQ stage's idx."""
        arrays = [a for a in args if hasattr(a, "shape")]

        def fn(vv, xx, *arrs):
            it = iter(arrs)
            full = [next(it) if hasattr(a, "shape") else a for a in args]
            out, st = jmodel.apply(vv, xx, *full, train=train, capture_intermediates=is_vq,
                                   mutable=["intermediates", "batch_stats"])
            inter = st["intermediates"]["core"]
            return out, [inter[f"VectorQuantizer_{n}"]["__call__"][0][1] for n in range(3)]

        out, idx_j = jax.jit(fn)(variables, x_in, *arrays)
        return out, [np.asarray(i) for i in idx_j]

    if name == "vqreptunetangular":
        # at percent 80 the preliminary pass's entropies (unscaled cosines:
        # all near log 3) crowd the percentile, and which rows it keeps
        # turns on f32 rounding in each package: held in f64 only
        cases = [((), False), ((gt, 100.0), True), ((gt, 80.0), True)]
    else:
        cases = [((), False), ((gt, "labeled", 0.0), True), ((scores, "unlabeled", 0.5), True)]
    for args, train in cases:
        idx.clear()
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        (jout, jc, ju, jl), jidx = jfwd(v, jnp.asarray(x), *jargs, train=train)
        targs = [a if not isinstance(a, np.ndarray) else torch.from_numpy(a).long()
                 if a.dtype == np.int32 else nchw(a) for a in args]
        model.load_state_dict(state_dict_from_flax(v, NUM_EMB))
        model.train(train)
        out, c, u, loss = model(nchw(x), *targs, train=train)
        f64_only = name == "vqreptunetangular" and args and args[-1] == 80.0
        if not f64_only:
            np.testing.assert_allclose(nhwc(out), np.asarray(jout), atol=1e-4)
        np.testing.assert_allclose(c.item(), float(jc), rtol=1e-5, atol=1e-12)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        for got, want in zip(idx, jidx):
            np.testing.assert_array_equal(got, want)
        if not train:
            assert loss.item() == 0.0 == float(jl)
            continue
        with jax_f64():
            jargs64 = [jnp.asarray(wide(a)) if isinstance(a, np.ndarray) else a for a in args]
            (jout64, _, _, jl64), _ = jfwd(wide(v), jnp.asarray(x, jnp.float64), *jargs64,
                                           train=True)
        m64 = make_model(cfg, device="cpu")
        m64.load_state_dict(state_dict_from_flax(v, NUM_EMB))
        with torch.no_grad(), port_f64():
            targs64 = [t.double() if torch.is_tensor(t) and t.is_floating_point() else t
                       for t in targs]
            out64, _, _, loss64 = m64.double().train()(nchw(x).double(), *targs64, train=True)
        np.testing.assert_allclose(nhwc(out64), np.asarray(jout64), atol=1e-6)
        assert abs(loss64.item() / float(jl64) - 1) <= 1e-9
        if not f64_only:
            own = abs(float(jl) / float(jl64) - 1)
            assert abs(loss.item() / float(jl64) - 1) <= 1e-5 + 2 * own
        loss.backward()  # the table trains through the real pass
        assert model.segmentation_head.embedding.grad.abs().max() > 0
        model.zero_grad(set_to_none=True)
