"""SLIC superpixels in numpy, the port's copy of the JAX package's
``tools/slic.py`` (which has no JAX in it; the port imports nothing of that
package).

The reference relies on skimage.segmentation.slic (saliency_map/saliency.py,
deprecated/obia_pseudolabel.py); this is a standalone implementation of the
SLIC algorithm (Achanta et al., 2012), so neither package needs skimage:
k-means in (l, a, b, x, y) space with a 2S x 2S locality window per center
and a compactness weight m, followed by a connectivity cleanup that merges
orphan components into their largest neighbour.
"""
from __future__ import annotations

import numpy as np


def _rgb2lab(rgb: np.ndarray) -> np.ndarray:
    """sRGB [0,1] -> CIELAB (D65), vectorised numpy."""
    rgb = np.clip(rgb, 0, 1)
    mask = rgb > 0.04045
    rgb_lin = np.where(mask, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    M = np.array([[0.4124564, 0.3575761, 0.1804375],
                  [0.2126729, 0.7151522, 0.0721750],
                  [0.0193339, 0.1191920, 0.9503041]])
    xyz = rgb_lin @ M.T
    xyz /= np.array([0.95047, 1.0, 1.08883])
    f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def slic(image: np.ndarray, n_segments: int = 200, compactness: float = 10.0,
         n_iters: int = 10, enforce_connectivity: bool = True) -> np.ndarray:
    """image (H, W, 3) float [0,1] -> (H, W) int32 superpixel labels."""
    h, w = image.shape[:2]
    lab = _rgb2lab(image)
    S = max(1, int(np.sqrt(h * w / n_segments)))
    ys = np.arange(S // 2, h, S)
    xs = np.arange(S // 2, w, S)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    cy, cx = cy.ravel(), cx.ravel()
    # perturb centers to lowest-gradient position in a 3x3 window
    gy, gx = np.gradient(lab[..., 0])
    grad = gy**2 + gx**2
    for i in range(len(cy)):
        y0, x0 = cy[i], cx[i]
        win = grad[max(0, y0 - 1):y0 + 2, max(0, x0 - 1):x0 + 2]
        dy, dx = np.unravel_index(np.argmin(win), win.shape)
        cy[i] = max(0, y0 - 1) + dy
        cx[i] = max(0, x0 - 1) + dx
    centers = np.concatenate([lab[cy, cx], cy[:, None], cx[:, None]], axis=1).astype(np.float64)

    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    labels = -np.ones((h, w), np.int32)
    dists = np.full((h, w), np.inf)
    m2s2 = (compactness / S) ** 2
    for _ in range(n_iters):
        labels.fill(-1)
        dists.fill(np.inf)
        for k in range(len(centers)):
            Lc, ac, bc, ycen, xcen = centers[k]
            y1, y2 = int(max(0, ycen - S)), int(min(h, ycen + S + 1))
            x1, x2 = int(max(0, xcen - S)), int(min(w, xcen + S + 1))
            patch = lab[y1:y2, x1:x2]
            dc = ((patch[..., 0] - Lc) ** 2 + (patch[..., 1] - ac) ** 2
                  + (patch[..., 2] - bc) ** 2)
            ds = ((yy[y1:y2, x1:x2] - ycen) ** 2 + (xx[y1:y2, x1:x2] - xcen) ** 2)
            d = dc + m2s2 * ds
            better = d < dists[y1:y2, x1:x2]
            dists[y1:y2, x1:x2] = np.where(better, d, dists[y1:y2, x1:x2])
            labels[y1:y2, x1:x2] = np.where(better, k, labels[y1:y2, x1:x2])
        # update centers
        flat = labels.ravel()
        data = np.concatenate([lab.reshape(-1, 3), yy.reshape(-1, 1), xx.reshape(-1, 1)], 1)
        for k in range(len(centers)):
            sel = flat == k
            if sel.any():
                centers[k] = data[sel].mean(axis=0)

    if enforce_connectivity:
        labels = _enforce_connectivity(labels, S * S // 4)
    return labels


def _enforce_connectivity(labels: np.ndarray, min_size: int) -> np.ndarray:
    """Relabel 4-connected components; absorb tiny ones into a neighbour."""
    from scipy import ndimage

    out = -np.ones_like(labels)
    next_id = 0
    for k in np.unique(labels):
        comp, n = ndimage.label(labels == k)
        for c in range(1, n + 1):
            mask = comp == c
            if mask.sum() < min_size and next_id > 0:
                # merge into an adjacent already-assigned label
                dil = ndimage.binary_dilation(mask) & ~mask
                neigh = out[dil]
                neigh = neigh[neigh >= 0]
                out[mask] = np.bincount(neigh).argmax() if neigh.size else next_id
            else:
                out[mask] = next_id
                next_id += 1
    return out
