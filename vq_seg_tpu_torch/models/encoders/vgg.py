"""Staged VGG encoders (NCHW), counterpart of the JAX package's
``models/encoders/vgg.py``.

The torchvision feature stack (configs A/B/D/E, with or without BN) is
split into U-Net stages at its max-pools: each stage *starts* with the
pool that ends the previous resolution, so stage 0 already carries 64
channels at the input's resolution and the outputs are (64, 128, 256, 512,
512, 512) channels at strides 1, 2, 4, 8, 16 and 32.

``features`` is an ``nn.Sequential`` indexed as torchvision's ``features.N``
(every conv, BN, ReLU and max-pool counted), so a torchvision VGG state
dict loads as it is (``classifier.*`` dropped).  Convs are 3x3 with a bias
and torch's default init; BNs are the port's flax-style ``BatchNorm2d``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from ..layers import ConvPad, batch_norm, torch_conv_default

# torchvision's vgg configs A/B/D/E
VGG_CFG = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "D": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"),
    "E": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
          512, 512, 512, 512, "M"),
}

_OUT = (64, 128, 256, 512, 512, 512)
vgg_encoders = {
    f"vgg{n}{bn}": dict(out_channels=_OUT, config=c, batch_norm=bool(bn))
    for n, c in (("11", "A"), ("13", "B"), ("16", "D"), ("19", "E")) for bn in ("", "_bn")
}


class VGGEncoder(nn.Module):
    """``forward(x)`` -> the ``depth + 1`` stage outputs, shallowest first."""

    def __init__(self, out_channels: Sequence[int], config: str, batch_norm_: bool = False,
                 depth: int = 5, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = tuple(out_channels)
        self.depth = depth
        layers = []
        # the index of the module whose output closes each stage (-1: the input
        # of features[0]); a stage ends where a max-pool begins
        self.stage_ends = []
        stage, ch = 0, in_channels
        cfg: Sequence[Union[int, str]] = VGG_CFG[config]
        for v in cfg:
            if v == "M":
                self.stage_ends.append(len(layers) - 1)
                stage += 1
                if stage > depth:
                    break
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(ConvPad(ch, int(v), 3, 1, 1, bias=True, init=torch_conv_default,
                                      generator=generator))
                if batch_norm_:
                    layers.append(batch_norm(int(v)))
                layers.append(nn.ReLU())
                ch = int(v)
        if stage <= depth:
            self.stage_ends.append(len(layers) - 1)
        self.features = nn.Sequential(*layers)

    def encoder_channels(self):
        return self.out_channels[: self.depth + 1]

    def forward(self, x):
        feats, ends = [], set(self.stage_ends)
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in ends:
                feats.append(x)
        return feats[: self.depth + 1]
