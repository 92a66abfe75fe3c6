"""Training utilities, counterpart of the JAX package's
``utils/train_tools.py``: ``reinit_modules``, the reference's decoder/head
re-initialisation that decorrelates the two CPS models."""
from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn

from ..models.layers import kaiming_normal


@torch.no_grad()
def reinit_modules(modules: Iterable[nn.Module], generator: torch.Generator):
    """Kaiming-normal (fan_out, relu) re-draw of every conv weight under each
    module, from ``generator`` (a CPU generator; the draw is copied to the
    weight's device); conv biases zeroed; BatchNorm untouched."""
    for module in modules:
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                w = kaiming_normal(torch.empty(m.weight.shape), generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
