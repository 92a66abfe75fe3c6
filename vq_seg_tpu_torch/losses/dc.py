"""Diagonal-cosine loss, counterpart of the JAX package's ``losses/dc.py``
(the ``semiweed`` trainer's loss between two views' MLP projections)."""
from __future__ import annotations

import torch

from ..parallel.collectives import batch_gather, batch_mean, group_rank


def dc_loss(phi1: torch.Tensor, phi2: torch.Tensor) -> torch.Tensor:
    """phi1, phi2: (N, D) rows; the mean over rows of diag(sim) / rowsum(sim),
    ``sim = phi1 @ phi2.T``.  Inside ``parallel.data_parallel`` each rank's
    rows of ``phi1`` meet every row of the global ``phi2`` (gathered), and
    the mean is the global batch's."""
    phi2_all = batch_gather(phi2)
    sim = phi1 @ phi2_all.T
    n = phi1.shape[0]
    diag = torch.diagonal(sim, offset=group_rank() * n)
    return batch_mean(diag / torch.sum(sim, dim=1))


class DCLoss:
    def __call__(self, phi1, phi2):
        return dc_loss(phi1, phi2)
