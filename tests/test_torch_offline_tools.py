"""Port parity: the offline dataset tools (``vq_seg_tpu_torch/tools/``, the
port's copies of the JAX package's ``vq_seg_tpu/tools/``) on the CPU.

Bounds:
  * ``slic`` (and its CIELAB conversion), ``lbp_8``, ``superpixel_features``
    and ``majority_labels`` equal the JAX package's exactly;
  * ``get_saliency_rbd`` equals the JAX package's within 1e-12 (the same
    numpy and scipy arithmetic); ``get_saliency_ft``, whose Gaussian blur
    is scipy's [1, 4, 6, 4, 1] / 16 correlation with a reflect-101 border
    where the JAX package calls OpenCV, within 1e-6 absolute (both blur in
    float32; skipped without OpenCV);
  * the forest's CART without bootstrap (every feature at each split)
    predicts exactly what sklearn's ``DecisionTreeClassifier`` with the
    same seed predicts, on continuous features, with all features and
    with 2 of 6 per split: the same split features, node for node
    (skipped without sklearn);
  * ``OBIAPseudoLabeler`` with the port's forest against the JAX package's
    (sklearn's forest, 100 trees each) on held-out superpixels: the pixel
    accuracy within 0.05 of the JAX labeler's (skipped without sklearn);
  * ``build_pseudo_labels`` writes one mask of the label pixels per
    unlabelled input.
"""
from _cleanup import delete_tmp_path  # noqa: F401 (autouse: tmp_path removed)
import os

import numpy as np
import pytest
from PIL import Image

from vq_seg_tpu.tools import obia as jobia
from vq_seg_tpu.tools import saliency as jsaliency
from vq_seg_tpu.tools import slic as jslic
from vq_seg_tpu_torch.tools import forest, obia, saliency, slic


def _scene(seed, h=48, w=64, noise=8):
    """Vertical stripes of three classes moved by a class in 8-pixel cells,
    coloured per class with noise: (image in [0, 1], class map)."""
    rng = np.random.default_rng(seed)
    stripes = (np.arange(w) * 6 // w)[None, :]
    shift = np.kron(rng.integers(0, 2, (h // 8 + 1, w // 8 + 1)), np.ones((8, 8), int))
    label = (stripes + shift[:h, :w]) % 3
    colours = np.array([[40, 40, 40], [60, 160, 60], [160, 60, 60]], np.float64)
    img = np.clip(colours[label] + rng.integers(-noise, noise + 1, (h, w, 3)), 0, 255) / 255.0
    return img, label


@pytest.mark.parametrize("seed,noise", [(0, 0), (1, 8), (2, 40)])
def test_slic_lbp_and_features_equal_jax(seed, noise):
    img, label = _scene(seed, noise=noise)
    np.testing.assert_array_equal(slic._rgb2lab(img), jslic._rgb2lab(img))
    sp = slic.slic(img, 30)
    np.testing.assert_array_equal(sp, jslic.slic(img, 30))
    assert sp.min() == 0 and sp.max() >= 5
    gray = (img.mean(-1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(obia.lbp_8(gray), jobia.lbp_8(gray))
    np.testing.assert_array_equal(obia.superpixel_features(img, sp),
                                  jobia.superpixel_features(img, sp))
    np.testing.assert_array_equal(obia.majority_labels(label, sp, 3),
                                  jobia.majority_labels(label, sp, 3))


def test_saliency_matches_jax():
    img, _ = _scene(3, noise=8)
    rbd = saliency.get_saliency_rbd(img, n_segments=40)
    assert rbd.shape == img.shape[:2] and 0.0 <= rbd.min() and rbd.max() <= 1.0
    np.testing.assert_allclose(rbd, jsaliency.get_saliency_rbd(img, n_segments=40), rtol=0,
                               atol=1e-12)
    pytest.importorskip("cv2")
    ft = saliency.get_saliency_ft(img)
    np.testing.assert_allclose(ft, jsaliency.get_saliency_ft(img), rtol=0, atol=1e-6)


def _tabular(seed, n=400, d=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n + 1000, d))
    y = ((X[:, 0] + 0.5 * X[:, 1] ** 2 - X[:, 2] * X[:, 3]
          + 0.8 * rng.standard_normal(n + 1000)) > 0).astype(int) + (X[:, 4] > 1)
    return X[:n], y[:n], X[n:]


@pytest.mark.parametrize("seed,max_features", [(0, None), (1, None), (2, 2)])
def test_tree_equals_sklearn_cart(seed, max_features):
    tree_mod = pytest.importorskip("sklearn.tree")
    X, y, X_test = _tabular(seed)
    sk = tree_mod.DecisionTreeClassifier(random_state=seed, max_features=max_features).fit(X, y)
    mine = forest.DecisionTree(max_features=max_features, seed=seed).fit(X, y)
    np.testing.assert_array_equal(mine.predict(X_test), sk.predict(X_test))
    np.testing.assert_array_equal(mine.predict(X), y)  # grown to pure leaves
    # node for node (sklearn marks a leaf -2, the port -1)
    np.testing.assert_array_equal(mine.feature, np.maximum(sk.tree_.feature, -1))
    np.testing.assert_array_equal(mine.threshold[mine.feature >= 0],
                                  sk.tree_.threshold[sk.tree_.feature >= 0])


def test_forest_labeler_accuracy_near_jax():
    pytest.importorskip("sklearn")
    train = [_scene(s, 64, 64, noise=24) for s in range(4)]
    held = [_scene(s, 64, 64, noise=24) for s in range(10, 13)]
    imgs, masks = [i for i, _ in train], [m for _, m in train]
    port = obia.OBIAPseudoLabeler(n_segments=60).fit(imgs, masks)
    jax_labeler = jobia.OBIAPseudoLabeler(n_segments=60).fit(imgs, masks)
    acc = np.mean([np.mean(port.predict(i) == m) for i, m in held])
    jacc = np.mean([np.mean(jax_labeler.predict(i) == m) for i, m in held])
    assert acc >= 0.6 and abs(acc - jacc) <= 0.05, (acc, jacc)
    assert isinstance(port.clf, forest.RandomForest) and len(port.clf.trees) == 100


def test_build_pseudo_labels_writes_masks(tmp_path):
    p2l = {"0": 0, "128": 1, "255": 2}
    for sub in ("input", "target"):
        os.makedirs(tmp_path / sub)
    for i in range(5):
        img, label = _scene(20 + i, noise=16)
        name = f"im{i:03d}.png"
        Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / "input" / name)
        if i < 3:
            Image.fromarray(np.array([0, 128, 255], np.uint8)[label], mode="L").save(
                tmp_path / "target" / name)
    labeler = obia.build_pseudo_labels(str(tmp_path), str(tmp_path / "obia"), p2l,
                                       n_segments=30)
    assert sorted(os.listdir(tmp_path / "obia")) == ["im003.png", "im004.png"]
    for name in os.listdir(tmp_path / "obia"):
        mask = np.asarray(Image.open(tmp_path / "obia" / name))
        assert mask.shape == (48, 64) and set(np.unique(mask)) <= {0, 128, 255}
    assert isinstance(labeler, obia.OBIAPseudoLabeler)
