"""Batched k-means for codebook initialisation.

Same algorithm as the JAX package's ``ops/kmeans.py``:

  * the initial means are a random sample of the rows: a permutation
    without replacement when N >= K, with replacement otherwise;
  * each iteration assigns rows to the nearest mean with the expanded form
    ``||x||^2 - 2 x.m + ||m||^2`` (or the cosine argmax), counts the bins and
    takes the bin means; a bin with no rows keeps its previous mean;
  * cosine mode l2-normalises the means every iteration.

Randomness comes from an explicit ``torch.Generator`` on the CPU; the sampled
indices move to the rows' device.  The product is a plain ``torch.matmul``.
"""
from __future__ import annotations

import torch


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)``: t / max(||t||, eps)."""
    n = torch.linalg.vector_norm(t, dim=dim, keepdim=True)
    return t / n.clamp_min(eps)


def sample_vectors(x: torch.Tensor, num: int, generator: torch.Generator) -> torch.Tensor:
    """Random row sample; without replacement when N >= num."""
    n = x.shape[0]
    if n >= num:
        idx = torch.randperm(n, generator=generator)[:num]
    else:
        idx = torch.randint(0, n, (num,), generator=generator)
    return x[idx.to(x.device)]


def kmeans_step(x: torch.Tensor, means: torch.Tensor, use_cosine_sim: bool = False,
                x_sq: torch.Tensor | None = None):
    """One k-means iteration from ``means`` (K, C) over rows x (N, C) f32.

    Returns (new_means (K, C), bins (K,) int64)."""
    k = means.shape[0]
    if use_cosine_sim:
        buckets = torch.argmax(x @ means.T, dim=-1)
    else:
        if x_sq is None:
            x_sq = torch.sum(x * x, dim=-1, keepdim=True)
        d2 = x_sq - 2.0 * (x @ means.T) + torch.sum(means * means, dim=-1)[None, :]
        buckets = torch.argmin(d2, dim=-1)
    bins = torch.bincount(buckets, minlength=k)
    sums = torch.zeros_like(means).index_add_(0, buckets, x)
    new_means = sums / bins.clamp_min(1)[:, None].to(x.dtype)
    if use_cosine_sim:
        new_means = l2norm(new_means)
    means = torch.where((bins == 0)[:, None], means, new_means)
    return means, bins


@torch.no_grad()
def kmeans(x: torch.Tensor, num_clusters: int, num_iters: int = 10,
           use_cosine_sim: bool = False, *, generator: torch.Generator):
    """K-means over rows x (N, C) -> (means (K, C) f32, bins (K,) int64)."""
    with torch.autocast(x.device.type, enabled=False):
        x = x.float()
        means = sample_vectors(x, num_clusters, generator)
        x_sq = torch.sum(x * x, dim=-1, keepdim=True)  # constant across iterations
        bins = torch.zeros(num_clusters, dtype=torch.int64, device=x.device)
        for _ in range(num_iters):
            means, bins = kmeans_step(x, means, use_cosine_sim, x_sq)
    return means, bins
