"""Host transfer, counterpart of the JAX package's ``utils/processing.py``."""
from __future__ import annotations

import numpy as np
import torch


def detach_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor on any device -> host numpy (the reference's
    ``.detach().cpu().numpy()``)."""
    return x.detach().cpu().numpy()
