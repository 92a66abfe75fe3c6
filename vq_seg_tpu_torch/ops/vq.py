"""VQ codebook assignment: the hot op of the network.

Flatten features to rows, score every row against a (K, C) codebook, take
the argmin (euclidean) or argmax (cosine), gather the chosen code rows and
count how often each code was chosen.

``vq_assign`` dispatches on the tensor's device: a CUDA tensor goes to the
hand-written kernel (``ops/vq_cuda.py``) and a CPU tensor to the plain
version ``vq_assign_reference``.  There is no fallback between the two.  The
op is not differentiable; the straight-through estimator and the commitment
loss live in ``models/modules/vector_quantizer.py``.
"""
from __future__ import annotations

import torch

from .kmeans import l2norm
from .vq_cuda import vq_assign_cuda

METRICS = ("euclidean", "cosine")


def _check_metric(metric: str):
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}, expected one of {METRICS}")


@torch.no_grad()
def vq_assign_reference(x: torch.Tensor, codebook: torch.Tensor, metric: str = "euclidean"):
    """Plain version.  x (N, C), codebook (K, C) ->
    (idx (N,) int32, quantized (N, C) f32, counts (K,) int32).

    f32 with autocast off; euclidean scores are the expanded -2 x.E^T + ||e||^2
    (the row-constant ||x||^2 is dropped); argmin/argmax return the first
    index on ties; the gather is an exact f32 row copy."""
    _check_metric(metric)
    with torch.autocast(x.device.type, enabled=False):
        x = x.float()
        codebook = codebook.float()
        k = codebook.shape[0]
        if metric == "euclidean":
            scores = -2.0 * (x @ codebook.T) + torch.sum(codebook * codebook, dim=-1)[None, :]
            idx = torch.argmin(scores, dim=-1)
        else:  # the caller has l2-normalised x and the codebook
            idx = torch.argmax(x @ codebook.T, dim=-1)
        quantized = codebook.index_select(0, idx)
        counts = torch.bincount(idx, minlength=k).to(torch.int32)
    return idx.to(torch.int32), quantized, counts


def vq_assign(x: torch.Tensor, codebook: torch.Tensor, metric: str = "euclidean"):
    """Codebook assignment, dispatched by the device the tensors lie on."""
    if x.device.type == "cuda":
        return vq_assign_cuda(x, codebook, metric)
    if x.device.type == "cpu":
        return vq_assign_reference(x, codebook, metric)
    raise ValueError(f"vq_assign has no implementation for device {x.device}")


def code_usage_percent(counts: torch.Tensor) -> torch.Tensor:
    """100 * unused/K: lower is better."""
    return 100.0 * torch.sum(counts == 0).float() / counts.shape[0]


def quantize_ste(x: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the value is ``quantized``, the gradient
    flows to x."""
    return x + (quantized - x).detach()


def commitment_loss(x: torch.Tensor, quantized_ste: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """mse(detach(quantized), x) * weight: pulls the encoder toward the frozen
    codebook."""
    return weight * torch.mean((quantized_ste.detach() - x) ** 2)


def cosine_prep(x: torch.Tensor, codebook: torch.Tensor):
    """l2-normalise the rows and the codebook for the cosine metric."""
    return l2norm(x), l2norm(codebook)
