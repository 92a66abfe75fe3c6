"""Diagonal-cosine loss, counterpart of the JAX package's ``losses/dc.py``
(the ``semiweed`` trainer's loss between two views' MLP projections)."""
from __future__ import annotations

import torch


def dc_loss(phi1: torch.Tensor, phi2: torch.Tensor) -> torch.Tensor:
    """phi1, phi2: (N, D) rows; the mean over rows of diag(sim) / rowsum(sim),
    ``sim = phi1 @ phi2.T``."""
    sim = phi1 @ phi2.T
    return torch.mean(torch.diagonal(sim) / torch.sum(sim, dim=1))


class DCLoss:
    def __call__(self, phi1, phi2):
        return dc_loss(phi1, phi2)
