"""Staged ResNet encoders (NCHW), counterpart of the JAX package's
``models/encoders/resnet.py``.

Module names follow torchvision (``conv1``, ``bn1``, ``layer1..4``, blocks
``0..N``, ``downsample.0/1``), so a torchvision-layout state_dict loads as
it is.  The forward returns depth+1 feature maps
``[x, stem, maxpool+layer1, layer2, layer3, layer4][: depth + 1]`` at output
stride 32.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvPad, batch_norm, max_pool_same

resnet_encoders = {
    "resnet18": dict(out_channels=(3, 64, 64, 128, 256, 512), block="basic", layers=(2, 2, 2, 2)),
    "resnet34": dict(out_channels=(3, 64, 64, 128, 256, 512), block="basic", layers=(3, 4, 6, 3)),
    "resnet50": dict(out_channels=(3, 64, 256, 512, 1024, 2048), block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet101": dict(out_channels=(3, 64, 256, 512, 1024, 2048), block="bottleneck", layers=(3, 4, 23, 3)),
    "resnet152": dict(out_channels=(3, 64, 256, 512, 1024, 2048), block="bottleneck", layers=(3, 8, 36, 3)),
}


def _downsample(inplanes, out_ch, stride, generator):
    return nn.Sequential(ConvPad(inplanes, out_ch, 1, stride, 0, bias=False, generator=generator),
                         batch_norm(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 padding_mode: str = "zeros", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = ConvPad(inplanes, planes, 3, stride, 1, bias=False,
                             padding_mode=padding_mode, generator=generator)
        self.bn1 = batch_norm(planes)
        self.conv2 = ConvPad(planes, planes, 3, 1, 1, bias=False,
                             padding_mode=padding_mode, generator=generator)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = _downsample(inplanes, planes, stride, generator)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 padding_mode: str = "zeros", generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = ConvPad(inplanes, planes, 1, 1, 0, bias=False, generator=generator)
        self.bn1 = batch_norm(planes)
        self.conv2 = ConvPad(planes, planes, 3, stride, 1, bias=False,
                             padding_mode=padding_mode, generator=generator)
        self.bn2 = batch_norm(planes)
        self.conv3 = ConvPad(planes, out_ch, 1, 1, 0, bias=False, generator=generator)
        self.bn3 = batch_norm(out_ch)
        self.downsample = None
        if stride != 1 or inplanes != out_ch:
            self.downsample = _downsample(inplanes, out_ch, stride, generator)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNetEncoder(nn.Module):
    """Staged ResNet encoder with the 6-output stage contract."""

    def __init__(self, out_channels, block: str, layers, depth: int = 5,
                 in_channels: int = 3, padding_mode: str = "zeros",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = tuple(out_channels)
        self.depth = depth
        cls = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = ConvPad(in_channels, 64, 7, 2, 3, bias=False, padding_mode=padding_mode,
                             generator=generator)
        self.bn1 = batch_norm(64)
        inplanes = 64
        stages = list(zip((64, 128, 256, 512), layers))[: max(depth - 1, 0)]
        for li, (planes, n_blocks) in enumerate(stages):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                blocks.append(cls(inplanes, planes, stride, padding_mode, generator))
                inplanes = planes * cls.expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))

    def encoder_channels(self):
        return self.out_channels[: self.depth + 1]

    def forward(self, x) -> List[torch.Tensor]:
        feats = [x]
        if self.depth >= 1:
            y = F.relu(self.bn1(self.conv1(x)))
            feats.append(y)
        for i in range(2, self.depth + 1):
            li = i - 2
            if li == 0:
                y = max_pool_same(y, 3, 2, 1)
            y = getattr(self, f"layer{li + 1}")(y)
            feats.append(y)
        return feats
