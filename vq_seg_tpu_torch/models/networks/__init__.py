"""Network registry: ``register`` and ``make_model``, with every name of
the JAX package's registry: the flagship ``vqreptunet1x1v2``, the
``reptcps`` family (``vqreptunet1x1``, ``vqreptunetdouble1x1``,
``vqreptunet``, ``vqretemptunet``, ``vqreeuptunet``, ``vqonlyptunet1x1``),
the ablations ``nopt`` and ``scheme6``, the supervised networks ``unet``,
``unetoriginal``, ``vqunet_v1``, ``vqunet_v2`` and ``fcn32s``, the ``vqpt``
networks (``vqptunet``, ``vqeuptunet``, ``vqnedptunet``, ``vqashunet``,
``vqashunetv2``), the attention networks of ``plaincps``/``objcps``
(``vqatunet``, ``vqcanet``, ``vqcanetv2``, ``vqcanetv3``, ``vqcanetv4``,
``drsavqunet``, ``vqpatchunet``, ``vqimdbnet``, ``vqsegheadnet``), the
angular networks of ``angularv3`` and ``reptcps``
(``vqreptunetangularv3``, ``vqreptunetangular``), ``supconvqunet``,
``VQUnetwithSalientloss`` (``salientcps``), the DeepLab networks
(``deeplabv3``, ``deeplabv3plus``, ``semiweednet``, ``unimatch``) and the
VQ-VAEs of ``selfsup`` (``vqvaev2``, ``vqvaev1``)."""
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
    from . import (ablation, deeplabv3, fcn, semiweednet, unet, vq_unet,  # noqa: F401
                   vqseghead, vqvae)  # (register the networks)

    name = model_cfg["name"]
    params = dict(model_cfg["params"])
    if name not in network_dict:
        raise KeyError(f"unknown network {name!r}: the registry has {sorted(network_dict)}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator()
    model = network_dict[name](**params, generator=generator)
    return model.to(device).eval()
