"""Network registry: ``register`` and ``make_model``.  Ported: the
flagship ``vqreptunet1x1v2``, the ``reptcps`` family (``vqreptunet1x1``,
``vqreptunetdouble1x1``, ``vqreptunet``, ``vqretemptunet``,
``vqreeuptunet``, ``vqonlyptunet1x1``), the supervised baselines ``unet``
and ``vqunet_v2``, the ``vqpt`` networks (``vqptunet``, ``vqeuptunet``,
``vqnedptunet``, ``vqashunet``, ``vqashunetv2``) and the attention networks
of ``plaincps``/``objcps`` (``vqatunet``, ``vqcanet``, ``vqcanetv2``,
``vqcanetv3``, ``vqcanetv4``, ``drsavqunet``, ``vqpatchunet``,
``vqimdbnet``, ``vqsegheadnet``), the angular networks of ``angularv3``
and ``reptcps`` (``vqreptunetangularv3``, ``vqreptunetangular``),
``supconvqunet``, the DeepLab networks (``deeplabv3``, ``deeplabv3plus``,
``semiweednet``) and the VQ-VAEs of ``selfsup`` (``vqvaev2``,
``vqvaev1``); the other entries of the JAX registry are in ROADMAP.md,
queue 1, "The rest of the model zoo"."""
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
    from . import (deeplabv3, semiweednet, unet, vq_unet, vqseghead,  # noqa: F401
                   vqvae)  # (register the networks)

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
