"""Port parity: the last helpers of the JAX package's surface, held exactly
against it on the CPU.

  * ``data/augmentations.py``: ``augmentation`` (cutout and cutmix) for a
    given box, and ``similarity_transform``/``inverse_similarity_transform``
    for each given ``aug`` (NHWC and HWC in the JAX package, NCHW and CHW
    here; only the flips act, as in the reference); the port's own draws
    (a ``torch.Generator``) in range and reproducible.
  * ``utils/visualize.py``: ``gray_to_rgb``, ``make_selfsup_example``,
    ``make_test_img`` and ``save_img_list`` (the PNGs decoded with PIL).
  * ``utils/logger.py::make_img_table``: None without wandb, and the same
    rows as the JAX package's through a stand-in wandb module.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vq_seg_tpu.data import augmentations as jaug
from vq_seg_tpu.utils import logger as jlogger
from vq_seg_tpu.utils import visualize as jvis
from _port_helpers import nchw, nhwc
from vq_seg_tpu_torch.data import augmentations as aug
from vq_seg_tpu_torch.utils import logger
from vq_seg_tpu_torch.utils import visualize as vis

torch.set_num_threads(1)


def _batch(seed=0, n=3, h=12, w=10):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, h, w, 3)).astype(np.float32)
    label = rng.integers(0, 3, size=(n, h, w)).astype(np.int32)
    logits = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    return x, label, logits


@pytest.mark.parametrize("name", ["cutout", "cutmix"])
def test_augmentation_matches_jax_for_a_given_box(name):
    x, label, logits = _batch()
    key = jax.random.PRNGKey(3)
    cfg = {"name": name, "ratio": 0.3}
    jx, jl, jg = jaug.augmentation(key, jnp.asarray(x), jnp.asarray(label), jnp.asarray(logits),
                                   cfg)
    mask = torch.from_numpy(np.array(jaug.make_cutout_mask(key, x.shape[1:3], 0.3)))
    assert (mask == 0).any() and (mask == 1).any()
    px, pl, pg = aug.augmentation(None, nchw(x), torch.from_numpy(label).long(), nchw(logits),
                                  cfg, mask=mask)
    np.testing.assert_array_equal(nhwc(px), np.asarray(jx))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(nhwc(pg), np.asarray(jg))
    with pytest.raises(ValueError):
        aug.augmentation(None, nchw(x), torch.from_numpy(label), nchw(logits),
                         {"name": "mixup", "ratio": 0.3}, mask=mask)


def test_augmentation_draws_its_box():
    x, label, logits = _batch(1)
    cfg = {"name": "cutout", "ratio": 0.25}
    out = [aug.augmentation(torch.Generator().manual_seed(5), nchw(x), torch.from_numpy(label),
                            nchw(logits), cfg) for _ in range(2)]
    for a, b in zip(*out):
        assert torch.equal(a, b)
    _, lab, _ = out[0]
    assert (lab == 255).any() and (lab != 255).any()


@pytest.mark.parametrize("case", list(range(10)))
def test_similarity_transform_matches_jax(case):
    x, _, _ = _batch(2)
    key = jax.random.PRNGKey(case)
    g = torch.Generator().manual_seed(case)
    for jx, px, back in ((x, nchw(x), nhwc), (x[0], nchw(x)[0], lambda t: t.permute(1, 2, 0))):
        jy, ja, jang = jaug.similarity_transform(key, jnp.asarray(jx), aug=case)
        py, pa, pang = aug.similarity_transform(g, px, aug=case)
        assert pa == ja == case
        np.testing.assert_array_equal(np.asarray(back(py)), np.asarray(jy))
        assert (pang == 0.0) == (jang == 0.0) == (case < 3)
        assert abs(pang) < 90.0
        if case >= 3:
            assert (pang < 0) == (jang < 0) == (case in (4, 6, 8))
        jinv = jaug.inverse_similarity_transform(jy, ja, jang)
        pinv = aug.inverse_similarity_transform(py, pa, pang)
        np.testing.assert_array_equal(np.asarray(back(pinv)), np.asarray(jinv))
        if case in (0, 1, 2, 3, 4):
            assert torch.equal(pinv, px)


def test_similarity_transform_draws():
    x = nchw(_batch(3)[0])
    ids = [aug.similarity_transform(torch.Generator().manual_seed(s), x)[1] for s in range(40)]
    assert set(ids) <= set(range(10)) and len(set(ids)) > 5
    assert ids == [aug.similarity_transform(torch.Generator().manual_seed(s), x)[1]
                   for s in range(40)]


@pytest.mark.parametrize("shape", [(2, 5, 4), (2, 5, 4, 1)])
def test_gray_to_rgb(shape):
    img = np.random.default_rng(4).uniform(size=shape)
    np.testing.assert_array_equal(vis.gray_to_rgb(img), jvis.gray_to_rgb(img))
    with pytest.raises(NotImplementedError):
        vis.gray_to_rgb(img[0, 0])


def test_selfsup_example_and_test_img():
    rng = np.random.default_rng(5)
    target, recon = rng.uniform(size=(2, 2, 6, 8, 3))
    np.testing.assert_array_equal(vis.make_selfsup_example(target, recon),
                                  jvis.make_selfsup_example(target, recon))
    inp = rng.uniform(size=(2, 6, 8, 3))
    pred = rng.standard_normal((2, 6, 8, 3))
    lab = rng.integers(0, 3, size=(2, 6, 8))
    for got, want in zip(vis.make_test_img(inp, pred, lab), jvis.make_test_img(inp, pred, lab)):
        np.testing.assert_array_equal(got, want)


def test_save_img_list(tmp_path):
    rng = np.random.default_rng(6)
    imgs = [rng.uniform(-0.2, 1.2, size=(5, 7, 3)), rng.uniform(size=(4, 3, 3))]
    names = ["a.png", "b.png"]
    vis.save_img_list(str(tmp_path), names, imgs)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jvis.save_img_list(str(jdir), names, imgs)
    for name, img in zip(names, imgs):
        got = np.asarray(Image.open(tmp_path / name))
        np.testing.assert_array_equal(got, np.asarray(Image.open(jdir / name)))
        np.testing.assert_array_equal(got, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def test_make_img_table(monkeypatch):
    args = (["x.png", "y.png"], [np.zeros((2, 2, 3))] * 2, [np.ones((2, 2, 3))] * 2, ["f", "a", "b"])
    if "wandb" not in sys.modules:
        assert logger.make_img_table(*args) is None
    fake = types.SimpleNamespace(
        Image=lambda arr, mode: ("image", mode, np.asarray(arr).tolist()),
        Table=lambda data, columns: {"data": data, "columns": columns})
    monkeypatch.setitem(sys.modules, "wandb", fake)
    assert logger.make_img_table(*args) == jlogger.make_img_table(*args)
    assert logger.make_img_table(*args)["data"][1][0] == "y.png"
