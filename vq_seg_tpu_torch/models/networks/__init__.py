"""Network registry: ``register`` and ``make_model``.  Only the flagship
``vqreptunet1x1v2`` is ported; the other entries of the JAX registry are in
ROADMAP.md, queue 1, "The rest of the model zoo"."""
from __future__ import annotations

from typing import Optional

import torch

from ...device import resolve_device

network_dict: dict = {}


def register(name: str):
    def deco(ctor):
        network_dict[name] = ctor
        return ctor

    return deco


def make_model(model_cfg, *, device="cuda", generator: Optional[torch.Generator] = None):
    """Build a network by registry name on ``device``.

    The weights are drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; a fresh unseeded one if None) and then moved, so a
    seed gives the same weights on every device."""
    from . import vq_unet  # noqa: F401  (registers the flagship)

    name = model_cfg["name"]
    params = dict(model_cfg["params"])
    if name not in network_dict:
        raise NotImplementedError(
            f"network {name!r} is not ported yet: the port has {sorted(network_dict)}; "
            "the rest is in ROADMAP.md, queue 1, 'The rest of the model zoo'")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator()
    model = network_dict[name](**params, generator=generator)
    return model.to(device).eval()
