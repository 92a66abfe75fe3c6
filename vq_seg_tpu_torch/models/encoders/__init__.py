"""Encoder factory.  Plain ``resnet*`` names only in this slice; the other
encoders of the JAX package are listed in ROADMAP.md, queue 1, "The rest of
the model zoo"."""
from __future__ import annotations

from typing import Optional

import torch

from .resnet import ResNetEncoder, resnet_encoders


def make_encoder(name: str, in_channels: int = 3, depth: int = 5,
                 padding_mode: str = "zeros", generator: Optional[torch.Generator] = None):
    """Build an encoder by name, at output stride 32.  Returns (module,
    encoder_channels)."""
    if name not in resnet_encoders:
        raise NotImplementedError(
            f"encoder {name!r} is not ported yet: the port has {sorted(resnet_encoders)}; "
            "the cca/ccavq resnets, vgg and convnext are in ROADMAP.md, queue 1, "
            "'The rest of the model zoo'")
    p = resnet_encoders[name]
    enc = ResNetEncoder(p["out_channels"], p["block"], p["layers"], depth=depth,
                        in_channels=in_channels, padding_mode=padding_mode,
                        generator=generator)
    return enc, enc.encoder_channels()
