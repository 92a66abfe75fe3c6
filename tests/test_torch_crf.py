"""Port parity: the dense CRF (``utils/crf.py``) on the CPU, f32.

  * ``DenseCRF`` against the JAX package's on ``tests/test_crf_exact.py``'s
    48x48 blob case and on a 50x70 case whose coarse grid leaves a
    remainder (70 = 17 cells of 4 + 2 columns): argmax agreement >= 0.999
    and mean |dQ| <= 1e-4;
  * ``dense_crf_exact`` equals the JAX package's within 1e-6;
  * the port passes ``tests/test_crf_exact.py``'s three bounds against the
    exact form: argmax agreement >= 0.995, mean |dQ| <= 0.005, the 99.9th
    percentile of |dQ| <= 0.05.
"""
import numpy as np
import pytest
import torch

from vq_seg_tpu.utils.crf import DenseCRF as JaxDenseCRF
from vq_seg_tpu.utils.crf import dense_crf_exact as jax_dense_crf_exact
from vq_seg_tpu_torch.utils.crf import DenseCRF, dense_crf_exact

torch.set_num_threads(1)


def _blob_case(h, w):
    """``tests/test_crf_exact.py``'s two colour blobs and noisy softmax
    scores, at (h, w)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.float32)
    blob1 = (yy - 14) ** 2 + (xx - 14) ** 2 < 121
    blob2 = (yy - 32) ** 2 + (xx - 34) ** 2 < 144
    img[..., 0] = 0.2 + 0.6 * blob1
    img[..., 1] = 0.2 + 0.6 * blob2
    img[..., 2] = 0.2
    img += rng.normal(0, 0.03, img.shape).astype(np.float32)
    img = np.clip(img, 0, 1)
    gt = np.zeros((h, w), np.int64)
    gt[blob1] = 1
    gt[blob2] = 2
    logits = np.eye(3, dtype=np.float32)[gt] * 2.0
    logits += rng.normal(0, 1.0, logits.shape).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return img, e / e.sum(-1, keepdims=True), gt


@pytest.fixture(scope="module", params=[(48, 48), (50, 70)], ids=["48x48", "50x70"])
def case(request):
    img, prob, gt = _blob_case(*request.param)
    port = DenseCRF()(img, prob)
    return img, prob, gt, port


def test_dense_crf_matches_jax(case):
    img, prob, _, port = case
    assert isinstance(port, torch.Tensor) and port.dtype == torch.float32
    assert tuple(port.shape) == prob.shape
    want = np.asarray(JaxDenseCRF()(img, prob))
    got = port.numpy()
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert agree >= 0.999, agree
    assert float(np.abs(got - want).mean()) <= 1e-4
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_dense_crf_exact_matches_jax(case):
    img, prob, _, _ = case
    np.testing.assert_allclose(dense_crf_exact(img, prob, iter_max=3),
                               jax_dense_crf_exact(img, prob, iter_max=3), rtol=0, atol=1e-6)


def test_dense_crf_within_the_exact_bounds(case):
    img, prob, gt, port = case
    exact = dense_crf_exact(img, prob)
    ours = port.numpy()
    dq = np.abs(ours - exact)
    assert float((ours.argmax(-1) == exact.argmax(-1)).mean()) >= 0.995
    assert float(dq.mean()) <= 0.005
    assert float(np.quantile(dq, 0.999)) <= 0.05
    # the refinement denoises the noisy prediction
    assert float((ours.argmax(-1) == gt).mean()) > float((prob.argmax(-1) == gt).mean())


def test_dense_crf_takes_tensors_on_their_device():
    img, prob, _ = _blob_case(20, 3)  # narrower than one coarse cell
    got = DenseCRF(iter_max=2)(torch.from_numpy(img), torch.from_numpy(prob).double())
    want = np.asarray(JaxDenseCRF(iter_max=2)(img, prob))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
