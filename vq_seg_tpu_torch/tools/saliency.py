"""Saliency maps (reference saliency_map/saliency.py:74-262), the port's
copy of the JAX package's ``tools/saliency.py``.

``get_saliency_rbd`` — Robust Background Detection (Zhu et al., CVPR'14,
the method the reference implements): SLIC superpixels -> mean-lab graph
with boundary ring connected -> geodesic colour distances -> boundary
connectivity -> background weights -> quadratic saliency optimisation
(sparse linear system).  Re-implemented from the published formulation on
our own SLIC (tools/slic.py), so no skimage is needed.

``get_saliency_ft`` — frequency-tuned saliency (Achanta et al., CVPR'09):
distance of the blurred image to the mean lab colour.  The JAX package
blurs with OpenCV's ``GaussianBlur(lab, (5, 5), 0)``; here the same
separable [1, 4, 6, 4, 1] / 16 kernel (OpenCV's fixed 5-tap kernel when
sigma is 0) with its reflect-101 border runs through scipy, in float32.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage, sparse
from scipy.sparse.csgraph import shortest_path
from scipy.sparse.linalg import spsolve

from .slic import _rgb2lab, slic


def _superpixel_stats(labels: np.ndarray, lab: np.ndarray):
    n = labels.max() + 1
    h, w = labels.shape
    flat = labels.ravel()
    counts = np.bincount(flat, minlength=n).astype(np.float64)
    means = np.stack([
        np.bincount(flat, weights=lab[..., c].ravel(), minlength=n) for c in range(3)
    ], axis=1) / np.maximum(counts, 1)[:, None]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cy = np.bincount(flat, weights=yy.ravel(), minlength=n) / np.maximum(counts, 1)
    cx = np.bincount(flat, weights=xx.ravel(), minlength=n) / np.maximum(counts, 1)
    centers = np.stack([cy, cx], axis=1)
    return n, counts, means, centers


def _adjacency(labels: np.ndarray):
    pairs = set()
    a, b = labels[:, :-1].ravel(), labels[:, 1:].ravel()
    for i, j in zip(a, b):
        if i != j:
            pairs.add((min(i, j), max(i, j)))
    a, b = labels[:-1].ravel(), labels[1:].ravel()
    for i, j in zip(a, b):
        if i != j:
            pairs.add((min(i, j), max(i, j)))
    return pairs


def get_saliency_rbd(image: np.ndarray, n_segments: int = 200,
                     sigma_clr: float = 10.0, sigma_bndcon: float = 1.0,
                     sigma_spa: float = 0.25, mu: float = 0.1) -> np.ndarray:
    """image (H, W, 3) float [0,1] -> (H, W) float saliency in [0,1]."""
    h, w = image.shape[:2]
    lab = _rgb2lab(image)
    labels = slic(image, n_segments=n_segments)
    n, counts, means, centers = _superpixel_stats(labels, lab)

    pairs = _adjacency(labels)
    boundary = np.unique(np.concatenate([
        labels[0], labels[-1], labels[:, 0], labels[:, -1]]))
    # boundary superpixels form a connected ring (reference behaviour)
    for i in range(len(boundary)):
        for j in range(i + 1, len(boundary)):
            pairs.add((min(boundary[i], boundary[j]), max(boundary[i], boundary[j])))

    rows, cols, vals = [], [], []
    for i, j in pairs:
        d = np.linalg.norm(means[i] - means[j])
        rows += [i, j]
        cols += [j, i]
        vals += [d, d]
    graph = sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
    geo = shortest_path(graph, directed=False)
    geo[~np.isfinite(geo)] = geo[np.isfinite(geo)].max()

    # boundary connectivity (paper eqs. 1-3)
    aff = np.exp(-(geo**2) / (2 * sigma_clr**2))
    area = aff.sum(axis=1)
    len_bnd = aff[:, boundary].sum(axis=1)
    bnd_con = len_bnd / np.sqrt(np.maximum(area, 1e-12))
    w_bg = 1.0 - np.exp(-(bnd_con**2) / (2 * sigma_bndcon**2))

    # background-weighted contrast (paper eq. 5)
    diag = np.sqrt(h * h + w * w)
    pos = centers / diag
    spa = np.exp(-((pos[:, None] - pos[None]) ** 2).sum(-1) / (2 * sigma_spa**2))
    d_clr = np.linalg.norm(means[:, None] - means[None], axis=-1)
    ctr = (d_clr * spa * w_bg[None, :]).sum(axis=1)
    w_fg = ctr / max(ctr.max(), 1e-12)

    # saliency optimisation (paper eq. 8): (W_bg + W_fg + L) s = w_fg
    smooth_pairs = list(pairs)
    wij = np.array([np.exp(-np.linalg.norm(means[i] - means[j]) ** 2 / (2 * sigma_clr**2)) + mu
                    for i, j in smooth_pairs])
    rows = [p[0] for p in smooth_pairs] + [p[1] for p in smooth_pairs]
    cols = [p[1] for p in smooth_pairs] + [p[0] for p in smooth_pairs]
    Wm = sparse.csr_matrix((np.concatenate([wij, wij]), (rows, cols)), shape=(n, n))
    Lap = sparse.diags(np.asarray(Wm.sum(axis=1)).ravel()) - Wm
    A = sparse.diags(w_bg + w_fg) + Lap
    s = spsolve(A.tocsc(), w_fg)
    s = (s - s.min()) / max(s.max() - s.min(), 1e-12)
    return s[labels]


def get_saliency_ft(image: np.ndarray) -> np.ndarray:
    """Frequency-tuned saliency: ||gauss_blur(lab) - mean(lab)||, normalised."""
    lab = _rgb2lab(image)
    k = np.array([1, 4, 6, 4, 1], np.float32) / np.float32(16)
    blur = lab.astype(np.float32)
    for axis in (0, 1):
        blur = ndimage.correlate1d(blur, k, axis=axis, mode="mirror")
    sal = np.linalg.norm(blur - lab.reshape(-1, 3).mean(0), axis=-1)
    return (sal - sal.min()) / max(sal.max() - sal.min(), 1e-12)
