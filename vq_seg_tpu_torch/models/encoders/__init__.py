"""Encoder factory: ``resnet*``, ``cca``-prefixed resnets (per-stage CCA),
``ccavq``-prefixed resnets (per-stage CCA and in-encoder codebooks),
``vgg*`` (``vgg11`` ... ``vgg19_bn``) and ``convnext_*``: every name of the
JAX package's ``make_encoder``."""
from __future__ import annotations

import re
from typing import Optional

import torch

from .convnext import ConvNeXtEncoder, convnext_encoders
from .resnet import CCAVQResNetEncoder, ResNetEncoder, resnet_encoders
from .vgg import VGGEncoder, vgg_encoders

_CCAVQ_DEFAULT = {"num_embeddings": [0, 0, 512, 512, 512], "distance": "euclidean",
                  "kmeans_init": True}


def make_encoder(name: str, in_channels: int = 3, depth: int = 5,
                 padding_mode: str = "zeros", generator: Optional[torch.Generator] = None,
                 cca=None, vq_cfg=None, custom_stem=None, output_stride: int = 32):
    """Build an encoder by name.  Returns (module, encoder_channels).
    ``output_stride`` 16 or 8 dilates the deepest stages of a plain or
    ``cca`` resnet (the DeepLab networks); the other encoders take 32
    only.  ``cca`` gives the per-stage flags of a ``cca`` or ``ccavq``
    name (default: the last three stages); ``vq_cfg`` the
    in-encoder codebooks of a ``ccavq`` name; ``custom_stem`` replaces a
    resnet's conv1/bn1/ReLU.  A ConvNeXt has at most 4 stages: ``depth`` is
    clamped to 4."""
    if output_stride != 32 and ("ccavq" in name or "resnet" not in name):
        raise ValueError(f"encoder {name!r} has output stride 32 only, got {output_stride}")
    if "resnet" in name:
        default_cca = (False, False, True, True, True)
        if "ccavq" in name:
            p = resnet_encoders[re.sub("ccavq", "", name)]
            enc = CCAVQResNetEncoder(p["out_channels"], p["block"], p["layers"],
                                     vq_cfg if vq_cfg is not None else _CCAVQ_DEFAULT,
                                     depth=depth, in_channels=in_channels,
                                     padding_mode=padding_mode,
                                     cca=cca if cca is not None else default_cca,
                                     generator=generator)
            return enc, enc.encoder_channels()
        if "cca" in name:
            name = re.sub("cca", "", name)
            cca = cca if cca is not None else default_cca
        else:
            cca = None
        if name in resnet_encoders:
            p = resnet_encoders[name]
            enc = ResNetEncoder(p["out_channels"], p["block"], p["layers"], depth=depth,
                                in_channels=in_channels, padding_mode=padding_mode,
                                generator=generator, cca=cca, custom_stem=custom_stem,
                                output_stride=output_stride)
            return enc, enc.encoder_channels()
    if name in vgg_encoders:
        p = vgg_encoders[name]
        enc = VGGEncoder(p["out_channels"], p["config"], p["batch_norm"], depth=depth,
                         in_channels=in_channels, generator=generator)
        return enc, enc.encoder_channels()
    if name in convnext_encoders:
        p = convnext_encoders[name]
        enc = ConvNeXtEncoder(p["depths"], p["dims"], depth=min(depth, 4),
                              in_channels=in_channels, generator=generator)
        return enc, enc.encoder_channels()
    raise KeyError(f"unknown encoder {name!r}: the port has {sorted(resnet_encoders)} (also "
                   f"with a cca or ccavq prefix), {sorted(vgg_encoders)} and "
                   f"{sorted(convnext_encoders)}")
