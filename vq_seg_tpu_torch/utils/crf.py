"""Dense-CRF post-processing, counterpart of the JAX package's
``utils/crf.py`` (reference utils/crf.py:5-35).

  * ``dense_crf_exact`` — the brute-force NumPy form of the dense
    (all-pairs) mean field for small images: symmetric kernel normalisation
    ``m = n * (K @ (n * q))`` with ``n = 1/sqrt(K @ 1)`` (self-interaction
    included), Potts compatibility ``energy = unary + (sum_c m - m)``.  A
    copy of the JAX package's, the ground truth ``DenseCRF`` is held
    against.
  * ``DenseCRF`` — plain torch on the tensors' device, the JAX package's
    approximation: the spatial Gaussian is an exact truncated separable
    blur (zero padding); the bilateral term is an exact windowed sum within
    ``bilateral_radius`` (``torch.roll``, so the window wraps around the
    image edges, as ``jnp.roll`` does) plus a coarse-grid pass for the
    long-range mass, whose cells are ``stride`` x ``stride`` with ``stride
    = max(coarse_stride, ceil(max(h, w) / 48))``.  The mean field starts
    from ``prob_map``.

Defaults are the reference's (iter_max=10, bi_w=7, bi_xy_std=50,
bi_rgb_std=4, pos_w=3, pos_xy_std=3).  The window's and the coarse grid's
weights depend on the image alone, so the window's are computed once per
call and reused by the 11 bilateral passes (the normalisation and 10
mean-field steps).  The coarse grid's (pixels x cells) weights are made in
chunks of cells; the chunks that fit in ``_COARSE_CACHE_BYTES`` are kept
for the later passes and the rest are made again in each pass, so that
the whole matrix, 8.4 GB in f32 at CWFID's native 1296x966, is never held
(at 256x256 it is 0.46 GB and is kept whole).  Kept or made again, a
chunk's weights are the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import full_f32

# elements of one chunk's (pixels x cells x 3) colour differences
_COARSE_CHUNK_ELEMENTS = 1 << 27
# bytes of coarse-grid weights kept across the passes of one call
_COARSE_CACHE_BYTES = 2 << 30


# ---------------------------------------------------------------------------
# exact reference (NumPy, O(n^2), for tests and small images)
# ---------------------------------------------------------------------------
def dense_crf_exact(image, prob_map, iter_max: int = 10, bi_w: float = 7,
                    bi_xy_std: float = 50, bi_rgb_std: float = 4,
                    pos_w: float = 3, pos_xy_std: float = 3):
    """All-pairs mean-field dense CRF.  image (H,W,3) in [0,1]; prob_map
    (H,W,C) softmax scores.  Returns refined (H,W,C) Q."""
    h, w, c = prob_map.shape
    n = h * w
    yy, xx = np.mgrid[0:h, 0:w]
    pos = np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float64)

    def kernel(feats):
        d2 = ((feats[:, None, :] - feats[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2)

    k_pos = kernel(pos / pos_xy_std)
    rgb = (image.reshape(n, 3).astype(np.float64) * 255.0) / bi_rgb_std
    k_bi = kernel(np.concatenate([pos / bi_xy_std, rgb], -1))
    n_pos = 1.0 / np.sqrt(k_pos @ np.ones(n) + 1e-20)
    n_bi = 1.0 / np.sqrt(k_bi @ np.ones(n) + 1e-20)

    unary = -np.log(np.maximum(prob_map.reshape(n, c).astype(np.float64), 1e-12))
    q = prob_map.reshape(n, c).astype(np.float64)
    for _ in range(iter_max):
        m_pos = n_pos[:, None] * (k_pos @ (n_pos[:, None] * q))
        m_bi = n_bi[:, None] * (k_bi @ (n_bi[:, None] * q))
        pairwise = pos_w * m_pos + bi_w * m_bi
        energy = unary + (pairwise.sum(-1, keepdims=True) - pairwise)
        e = np.exp(-(energy - energy.min(-1, keepdims=True)))
        q = e / e.sum(-1, keepdims=True)
    return q.reshape(h, w, c).astype(np.float32)


# ---------------------------------------------------------------------------
# torch implementation
# ---------------------------------------------------------------------------
def _separable_blur(q: torch.Tensor, k: torch.Tensor, radius: int) -> torch.Tensor:
    """q (H, W, C); truncated Gaussian blur along H then W (self included),
    zero padding; the taps summed in order, as the JAX package does."""
    h, w = q.shape[:2]
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, radius, radius))
    qh = sum(k[i] * qp[i:i + h] for i in range(2 * radius + 1))
    qp = torch.nn.functional.pad(qh, (0, 0, radius, radius))
    return sum(k[i] * qp[:, i:i + w] for i in range(2 * radius + 1))


class _Bilateral:
    """The bilateral message of one image: the windowed sum over the
    (2R+1)^2 offsets and the coarse grid's long-range mass.  Everything
    that depends on the image alone is set up once."""

    def __init__(self, norm_img: torch.Tensor, xy_std: float, radius: int, stride: int):
        dev = norm_img.device
        h, w, _ = norm_img.shape
        self.offsets = [(dy, dx) for dy in range(-radius, radius + 1)
                        for dx in range(-radius, radius + 1)]
        spatial = np.exp(-0.5 * (np.asarray(self.offsets, np.float32) ** 2).sum(-1)
                         / (xy_std * xy_std))
        # per offset: spatial weight x colour weight, (H, W, 1)
        self.window = []
        for (dy, dx), sp in zip(self.offsets, spatial):
            img_s = torch.roll(norm_img, (dy, dx), dims=(0, 1))
            colour = torch.exp(-0.5 * torch.sum((norm_img - img_s) ** 2, dim=-1, keepdim=True))
            self.window.append(float(sp) * colour)

        self.stride, self.radius, self.xy_std = stride, radius, xy_std
        self.ch, self.cw = h // stride, w // stride
        if self.ch == 0 or self.cw == 0:
            return
        self.img_flat = norm_img.reshape(-1, norm_img.shape[-1])
        self.img_c = self._pool(norm_img)
        cy = ((np.arange(self.ch) + 0.5) * stride - 0.5).astype(np.float32)
        cx = ((np.arange(self.cw) + 0.5) * stride - 0.5).astype(np.float32)
        fy = torch.arange(h, dtype=torch.float32, device=dev)
        fx = torch.arange(w, dtype=torch.float32, device=dev)
        self.dy2 = (fy[:, None] - torch.from_numpy(cy).to(dev)[None, :]) ** 2  # (H, ch)
        self.dx2 = (fx[:, None] - torch.from_numpy(cx).to(dev)[None, :]) ** 2  # (W, cw)
        n_cells = self.ch * self.cw
        self.chunk = max(1, min(n_cells, _COARSE_CHUNK_ELEMENTS // (h * w * 3)))
        cells = torch.arange(n_cells, device=dev)
        self.jy, self.jx = cells // self.cw, cells % self.cw
        self.kept: dict = {}  # chunk start -> its (pixels, cells) weights
        self.kept_bytes = 0

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        """Means over the stride x stride cells of the first ch*stride rows
        and cw*stride columns, as (cells, channels) in row-major order."""
        s, c = self.stride, x.shape[-1]
        t = x[: self.ch * s, : self.cw * s].reshape(self.ch, s, self.cw, s, c)
        return t.mean(dim=(1, 3)).reshape(-1, c)

    def _weights(self, start: int) -> torch.Tensor:
        """The (pixels, cells) weights stride^2 * k_xy * k_rgb of the chunk
        of cells from ``start``: zero where the cell's center lies within
        ``radius`` of the pixel (the window covers that)."""
        if start in self.kept:
            return self.kept[start]
        jy = self.jy[start:start + self.chunk]
        jx = self.jx[start:start + self.chunk]
        d2 = (self.dy2[:, None, jy] + self.dx2[None, :, jx]).reshape(self.img_flat.shape[0], -1)
        k_xy = torch.exp(-0.5 * d2 / (self.xy_std * self.xy_std))
        k_xy = torch.where(d2 <= float(self.radius * self.radius), 0.0, k_xy)
        diff = self.img_flat[:, None, :] - self.img_c[None, start:start + self.chunk, :]
        k_rgb = torch.exp(-0.5 * torch.sum(diff ** 2, dim=-1))
        wgt = float(self.stride * self.stride) * k_xy * k_rgb
        size = wgt.numel() * wgt.element_size()
        if self.kept_bytes + size <= _COARSE_CACHE_BYTES:
            self.kept[start] = wgt
            self.kept_bytes += size
        return wgt

    def _coarse(self, q: torch.Tensor) -> torch.Tensor:
        """Each cell J adds stride^2 * k_xy(x_i, X_J) * k_rgb(c_i, C_J) *
        mean q_J to pixel i."""
        h, w, c = q.shape
        if self.ch == 0 or self.cw == 0:
            return torch.zeros_like(q)
        q_c = self._pool(q)
        out = torch.zeros(h * w, c, dtype=q.dtype, device=q.device)
        for start in range(0, q_c.shape[0], self.chunk):
            out += self._weights(start) @ q_c[start:start + self.chunk]
        return out.reshape(h, w, c)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        fine = torch.zeros_like(q)
        for (dy, dx), wgt in zip(self.offsets, self.window):
            fine = fine + wgt * torch.roll(q, (dy, dx), dims=(0, 1))
        return fine + self._coarse(q)


class DenseCRF:
    """``crf(image, prob_map)`` with image (H, W, 3) floats in [0, 1] and
    prob_map (H, W, C) softmax scores, channel-last as the JAX package's
    (the reference is CHW); returns the refined (H, W, C) Q as an f32
    tensor on the inputs' device.  Numpy inputs run on the CPU."""

    def __init__(self, iter_max: int = 10, bi_w: float = 7, bi_xy_std: float = 50,
                 bi_rgb_std: float = 4, pos_w: float = 3, pos_xy_std: float = 3,
                 bilateral_radius: int = 8, coarse_stride: int = 4):
        self.iter_max = iter_max
        self.bi_w = bi_w
        self.bi_xy_std = bi_xy_std
        self.bi_rgb_std = bi_rgb_std
        self.pos_w = pos_w
        self.pos_xy_std = pos_xy_std
        self.bilateral_radius = bilateral_radius
        self.coarse_stride = coarse_stride

    @torch.no_grad()
    def __call__(self, image, prob_map) -> torch.Tensor:
        image = torch.as_tensor(image).float()
        prob_map = torch.as_tensor(prob_map).float()
        with full_f32():  # the coarse grid's products in f32, never TF32
            return self._inference(image.to(prob_map.device), prob_map)

    def _inference(self, image: torch.Tensor, prob_map: torch.Tensor) -> torch.Tensor:
        unary = -torch.log(torch.clamp(prob_map, min=1e-12))  # unary_from_softmax
        spatial_radius = int(max(1, round(3 * self.pos_xy_std)))
        x = np.arange(-spatial_radius, spatial_radius + 1, dtype=np.float32)
        taps = [float(t) for t in np.exp(-0.5 * (x / self.pos_xy_std) ** 2)]
        norm_img = image * 255.0 / self.bi_rgb_std
        h, w = prob_map.shape[:2]
        # cells of at most ~48 per side: CWFID's native 1296x966 gives
        # 48 x 35 cells of 27 px; the bi_xy_std=50 kernel varies slowly
        # enough for them
        stride = max(self.coarse_stride, -(-max(h, w) // 48))
        bilateral = _Bilateral(norm_img, self.bi_xy_std, self.bilateral_radius, stride)
        ones = torch.ones(h, w, 1, dtype=prob_map.dtype, device=prob_map.device)
        # symmetric kernel normalisation, as pydensecrf's NORMALIZE_SYMMETRIC
        n_pos = torch.rsqrt(_separable_blur(ones, taps, spatial_radius) + 1e-20)
        n_bi = torch.rsqrt(bilateral(ones) + 1e-20)
        q = prob_map
        for _ in range(self.iter_max):
            m_pos = n_pos * _separable_blur(n_pos * q, taps, spatial_radius)
            m_bi = n_bi * bilateral(n_bi * q)
            pairwise = self.pos_w * m_pos + self.bi_w * m_bi
            # Potts compatibility: other-label message mass raises the energy
            energy = unary + (torch.sum(pairwise, dim=-1, keepdim=True) - pairwise)
            q = torch.softmax(-energy, dim=-1)
        return q
