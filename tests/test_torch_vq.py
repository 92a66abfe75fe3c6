"""Port parity: VQ ops (``vq_seg_tpu_torch/ops``) against the JAX package.

The plain version ``vq_assign_reference`` is held against the XLA path and
against the Pallas kernel run through the Pallas interpreter, at the cases of
``tests/test_pallas_interpret.py``: idx and counts exact, quant bitwise.  The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below, which needs no JAX:
on a machine with a card and without JAX it runs alone with

    python -m pytest --noconftest -m cuda tests/test_torch_vq.py
"""
import numpy as np
import pytest
import torch

from vq_seg_tpu_torch.ops import kmeans as tkm
from vq_seg_tpu_torch.ops import vq as tvq
from vq_seg_tpu_torch.ops import vq_cuda

try:  # the reference; every test but the card's needs it
    import jax
    import jax.numpy as jnp

    import vq_seg_tpu.ops.vq as jvq
    from vq_seg_tpu.ops.kmeans import kmeans as jax_kmeans
    from vq_seg_tpu.ops.kmeans import l2norm as jax_l2norm
    from vq_seg_tpu.ops.kmeans import sample_vectors as jax_sample_vectors
    from vq_seg_tpu.ops.vq_pallas import _vq_assign_pallas_impl
except ImportError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="the JAX package is the reference")

torch.set_num_threads(1)


def _inputs(n, c, k, metric, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    cb = rng.standard_normal((k, c)).astype(np.float32)
    if metric == "cosine":  # F.normalize in f32, as the JAX l2norm does
        x = tkm.l2norm(torch.from_numpy(x)).numpy()
        cb = tkm.l2norm(torch.from_numpy(cb)).numpy()
    return x, cb


def _assert_same(port, ref):
    i1, q1, c1 = (t.numpy() for t in port)
    i2, q2, c2 = (np.asarray(a) for a in ref)
    assert i1.dtype == np.int32 and c1.dtype == np.int32
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(c1, c2)
    assert np.array_equal(q1.view(np.uint32), q2.view(np.uint32))  # bitwise


@needs_jax
@pytest.mark.parametrize("n,c,k", [(1000, 128, 256), (512, 256, 512), (100, 128, 256)])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_reference_matches_xla_and_pallas(n, c, k, metric):
    x, cb = _inputs(n, c, k, metric)
    port = tvq.vq_assign_reference(torch.from_numpy(x), torch.from_numpy(cb), metric)
    _assert_same(port, jvq.vq_assign_xla(jnp.asarray(x), jnp.asarray(cb), metric=metric))
    _assert_same(port, _vq_assign_pallas_impl(jnp.asarray(x), jnp.asarray(cb), metric,
                                              interpret=True))
    assert int(port[2].sum()) == n


@needs_jax
def test_duplicate_codes_resolve_to_first_index():
    rng = np.random.default_rng(2)
    cb = rng.standard_normal((256, 128)).astype(np.float32)
    cb[128] = cb[7]  # duplicate row -> exact tie
    x = np.tile(cb[7][None], (300, 1))
    port = tvq.vq_assign_reference(torch.from_numpy(x), torch.from_numpy(cb))
    assert (port[0].numpy() == 7).all()
    _assert_same(port, jvq.vq_assign_xla(jnp.asarray(x), jnp.asarray(cb)))
    _assert_same(port, _vq_assign_pallas_impl(jnp.asarray(x), jnp.asarray(cb), "euclidean",
                                              interpret=True))


def test_dispatch_sends_cpu_tensors_to_the_plain_version():
    x, cb = _inputs(64, 16, 8, "euclidean", seed=3)
    before = vq_cuda.launches
    got = tvq.vq_assign(torch.from_numpy(x), torch.from_numpy(cb))
    want = tvq.vq_assign_reference(torch.from_numpy(x), torch.from_numpy(cb))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert vq_cuda.launches == before
    # the kernel wrapper takes CUDA tensors only: no silent CPU path
    with pytest.raises(ValueError, match="CUDA"):
        vq_cuda.vq_assign_cuda(torch.from_numpy(x), torch.from_numpy(cb))
    with pytest.raises(ValueError, match="metric"):
        tvq.vq_assign(torch.from_numpy(x), torch.from_numpy(cb), "manhattan")


@needs_jax
def test_usage_ste_and_commitment_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    q = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    w = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)

    def jax_fn(x):
        qs = jvq.quantize_ste(x, jnp.asarray(q))
        return jnp.sum(qs * w) + jvq.commitment_loss(x, qs, 0.25)

    jval, jgrad = jax.value_and_grad(jax_fn)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    qs = tvq.quantize_ste(tx, torch.from_numpy(q))
    commit = tvq.commitment_loss(tx, qs, 0.25)
    np.testing.assert_allclose(qs.detach().numpy(), q, atol=1e-6)
    np.testing.assert_allclose(
        commit.item(), float(jvq.commitment_loss(jnp.asarray(x), jnp.asarray(q), 0.25)),
        rtol=1e-6, atol=1e-6)
    (torch.sum(qs * torch.from_numpy(w)) + commit).backward()
    np.testing.assert_allclose(float(jval), (torch.sum(qs * torch.from_numpy(w)) + commit).item(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-6)

    counts = np.array([0, 3, 0, 1], np.int32)
    assert tvq.code_usage_percent(torch.from_numpy(counts)).item() == pytest.approx(
        float(jvq.code_usage_percent(jnp.asarray(counts))))


@needs_jax
@pytest.mark.parametrize("cosine", [False, True])
def test_kmeans_steps_match_jax_from_the_same_means(cosine):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    if cosine:
        x = np.array(jax_l2norm(jnp.asarray(x)))
    key = jax.random.PRNGKey(7)
    means0 = np.asarray(jax_sample_vectors(key, jnp.asarray(x), 8))
    means = torch.from_numpy(means0)
    for iters in (1, 2):
        jmeans, jbins = jax_kmeans(key, jnp.asarray(x), 8, iters, use_cosine_sim=cosine)
        means, bins = tkm.kmeans_step(torch.from_numpy(x), means, cosine)
        np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), atol=1e-5)
        np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))


def test_kmeans_keeps_empty_bins_and_samples_without_replacement():
    x = torch.tensor([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]])
    # bin 1 gets no rows: it keeps its old mean
    means, bins = tkm.kmeans_step(x, torch.tensor([[0.0, 0.0], [9.0, 9.0], [1.0, 1.0]]))
    assert bins.tolist() == [2, 0, 1]
    assert means[1].tolist() == [9.0, 9.0]
    rows = torch.arange(12, dtype=torch.float32)[:, None]
    picked = tkm.sample_vectors(rows, 12, torch.Generator().manual_seed(0))
    assert sorted(picked.flatten().tolist()) == list(range(12))
    means, bins = tkm.kmeans(rows, 4, 3, generator=torch.Generator().manual_seed(0))
    assert means.shape == (4, 1) and int(bins.sum()) == 12


def _tf32_rna(v):
    """numpy emulation of PTX ``cvt.rna.tf32.f32``: round the f32 significand
    to 10 explicit bits, to nearest with ties away from zero (add half of the
    dropped last place to the magnitude bits, then drop the 13 low bits)."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(v):
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)  # v - hi is exact in f32


def _dot_3xtf32(x, e):
    """x (N, C) . e (K, C)^T as the kernel sums it: per 8-wide k step, the
    f32 accumulator takes lo_x*hi_e, then hi_x*lo_e, then hi_x*hi_e, each as
    one f32 rounding of 8 exact products (an m16n8k8 mma)."""
    c8 = -(-x.shape[1] // 8) * 8
    xh, xl = (np.pad(a, ((0, 0), (0, c8 - x.shape[1]))).astype(np.float64)
              for a in _split_tf32(x))
    eh, el = (np.pad(a, ((0, 0), (0, c8 - x.shape[1]))).astype(np.float64)
              for a in _split_tf32(e))
    acc = np.zeros((x.shape[0], e.shape[0]), np.float32)
    for k0 in range(0, c8, 8):
        s = slice(k0, k0 + 8)
        for a, b in ((xl, eh), (xh, el), (xh, eh)):
            acc = (acc.astype(np.float64) + a[:, s] @ b[:, s].T).astype(np.float32)
    return acc


def _3xtf32_bound(c):
    """The head comment of csrc/vq_assign.cu: |dot_3xTF32 - x.e| is at most
    this times sum_i |x_i e_i|."""
    return 2.0**-20 + 3 * -(-c // 8) * 2.0**-23 * (1 + 2.0**-8)


@pytest.mark.parametrize("c", [3, 512, 2048])
def test_tf32_split_reconstructs_f32_within_2_to_minus_22(c):
    rng = np.random.default_rng(c)
    v = (rng.standard_normal((64, c)) * 10.0 ** rng.uniform(-3, 3, (64, c))).astype(np.float32)
    hi, lo = _split_tf32(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    resid = np.abs(v.astype(np.float64) - hi - lo)
    assert (resid <= 2.0**-22 * np.abs(v.astype(np.float64))).all()
    assert (np.abs(v.astype(np.float64) - hi) <= 2.0**-11 * np.abs(v.astype(np.float64))).all()


@pytest.mark.parametrize("c", [3, 512, 2048])
def test_3xtf32_dot_within_the_kernels_error_bound(c):
    rng = np.random.default_rng(10 + c)
    x = rng.standard_normal((16, c)).astype(np.float32)
    e = rng.standard_normal((24, c)).astype(np.float32)
    exact = x.astype(np.float64) @ e.astype(np.float64).T
    mag = np.abs(x.astype(np.float64)) @ np.abs(e.astype(np.float64)).T
    err = np.abs(_dot_3xtf32(x, e) - exact)
    assert (err <= _3xtf32_bound(c) * mag).all()
    # and it is an f32-grade product, not TF32's 2^-11
    assert (err <= 2.0**-18 * mag).all()
    assert np.abs(_tf32_rna(x).astype(np.float64) @ _tf32_rna(e).astype(np.float64).T
                  - exact).max() > 2.0**-18 * mag.max()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_3xtf32_scores_pick_the_plain_versions_idx_off_near_ties(metric):
    x, cb = _inputs(64, 128, 256, metric, seed=8)
    dot = _dot_3xtf32(x, cb)
    if metric == "euclidean":
        sq = torch.sum(torch.from_numpy(cb) ** 2, dim=-1).numpy()
        idx = np.argmin(sq[None, :] - np.float32(2.0) * dot, axis=-1)
    else:
        idx = np.argmax(dot, axis=-1)
    ref = tvq.vq_assign_reference(torch.from_numpy(x), torch.from_numpy(cb), metric)[0].numpy()
    rows = np.nonzero(idx != ref)[0]
    # the f32 certificate of chip_smoke.py::check_near_ties for each mismatch
    xr = x[rows].astype(np.float64)
    ea, eb = cb[idx[rows]].astype(np.float64), cb[ref[rows]].astype(np.float64)
    dots = np.abs(xr * ea).sum(-1) + np.abs(xr * eb).sum(-1)
    u, c = 2.0**-24, x.shape[1]
    if metric == "euclidean":
        sa = (ea * ea).sum(-1) - 2 * (xr * ea).sum(-1)
        sb = (eb * eb).sum(-1) - 2 * (xr * eb).sum(-1)
        tol = 2 * c * u * dots + c * u * ((ea * ea).sum(-1) + (eb * eb).sum(-1))
    else:
        sa, sb = -(xr * ea).sum(-1), -(xr * eb).sum(-1)
        tol = c * u * dots
    tol = tol + 2 * u * (np.abs(sa) + np.abs(sb))
    assert (np.abs(sa - sb) <= tol).all()
    assert rows.size <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,k,metric", [(1000, 128, 256, "euclidean"), (100, 3, 5, "euclidean"),
                                          (1000, 128, 256, "cosine"),
                                          (1001, 136, 200, "euclidean")])
def test_kernel_matches_plain_version_on_the_card(n, c, k, metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run on the card)")
    x, cb = _inputs(n, c, k, metric, seed=6)
    x, cb = torch.from_numpy(x).cuda(), torch.from_numpy(cb).cuda()
    before = vq_cuda.launches
    got = tvq.vq_assign(x, cb, metric)
    want = tvq.vq_assign_reference(x, cb, metric)
    torch.cuda.synchronize()
    assert vq_cuda.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
