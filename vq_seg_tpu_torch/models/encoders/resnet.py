"""Staged ResNet encoders (NCHW), counterpart of the JAX package's
``models/encoders/resnet.py``.

Module names follow torchvision (``conv1``, ``bn1``, ``layer1..4``, blocks
``0..N``, ``downsample.0/1``), so a torchvision-layout state_dict loads as
it is.  The forward returns depth+1 feature maps
``[x, stem, maxpool+layer1, layer2, layer3, layer4][: depth + 1]``.
``output_stride`` 16 replaces layer4's stride 2 with dilation 2, and 8
also layer3's with dilation 2 and layer4's with 4, in every 3x3 conv of
the stage, the padding equal to the dilation; the stage's first block
keeps its 1x1 downsample shortcut, at stride 1
(``stage_strides_dilations``).  The weights' keys do not change.

``cca`` (a flag per stage, ``depth`` of them) puts a ``CCA`` after the stem
(before the max-pool) and after each flagged layer, as ``cca_{i}``
(the JAX package's CCAResNetEncoder).  ``custom_stem`` replaces conv1/bn1/
ReLU (``VQPatchUNet``'s ConvMixer).  ``CCAVQResNetEncoder`` quantizes its
own stage outputs with in-encoder codebooks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvPad, batch_norm, max_pool_same
from ..modules.attention import CCA
from ..modules.vector_quantizer import make_vq_module, quantize_stages

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


def stage_strides_dilations(output_stride: int):
    """(stride, dilation) of layer1..4 at ``output_stride`` 32, 16 or 8."""
    if output_stride == 32:
        return ((1, 1), (2, 1), (2, 1), (2, 1))
    if output_stride == 16:
        return ((1, 1), (2, 1), (2, 1), (1, 2))
    if output_stride == 8:
        return ((1, 1), (2, 1), (1, 2), (1, 4))
    raise ValueError(f"Output stride should be 32, 16 or 8, got {output_stride}.")


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 padding_mode: str = "zeros", generator: Optional[torch.Generator] = None,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = ConvPad(inplanes, planes, 3, stride, dilation, bias=False,
                             padding_mode=padding_mode, generator=generator, dilation=dilation)
        self.bn1 = batch_norm(planes)
        self.conv2 = ConvPad(planes, planes, 3, 1, dilation, bias=False,
                             padding_mode=padding_mode, generator=generator, dilation=dilation)
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
                 padding_mode: str = "zeros", generator: Optional[torch.Generator] = None,
                 dilation: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = ConvPad(inplanes, planes, 1, 1, 0, bias=False, generator=generator)
        self.bn1 = batch_norm(planes)
        self.conv2 = ConvPad(planes, planes, 3, stride, dilation, bias=False,
                             padding_mode=padding_mode, generator=generator, dilation=dilation)
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
                 generator: Optional[torch.Generator] = None,
                 cca: Optional[Sequence[bool]] = None, custom_stem: Optional[nn.Module] = None,
                 output_stride: int = 32):
        super().__init__()
        strides_dilations = stage_strides_dilations(output_stride)
        self.out_channels = tuple(out_channels)
        self.depth = depth
        cls = BasicBlock if block == "basic" else Bottleneck
        if custom_stem is not None:
            # called as custom_stem(x); must give out_channels[1] at stride 2
            self.custom_stem = custom_stem
        else:
            self.custom_stem = None
            self.conv1 = ConvPad(in_channels, 64, 7, 2, 3, bias=False, padding_mode=padding_mode,
                                 generator=generator)
            self.bn1 = batch_norm(64)
        inplanes = 64
        stages = list(zip((64, 128, 256, 512), layers))[: max(depth - 1, 0)]
        for li, (planes, n_blocks) in enumerate(stages):
            blocks = []
            stride, dilation = strides_dilations[li]
            for bi in range(n_blocks):
                blocks.append(cls(inplanes, planes, stride if bi == 0 else 1, padding_mode,
                                  generator, dilation))
                inplanes = planes * cls.expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.cca = None
        if cca is not None:
            if len(cca) != depth:
                raise ValueError("the length of cca list must match depth")
            self.cca = tuple(bool(f) for f in cca)
            for i, on in enumerate(self.cca):
                if on:
                    ch = self.out_channels[i + 1]
                    self.add_module(f"cca_{i}", CCA(ch, ch, generator))

    def encoder_channels(self):
        return self.out_channels[: self.depth + 1]

    def _att(self, i: int, y):
        return getattr(self, f"cca_{i}")(y) if self.cca is not None and self.cca[i] else y

    def forward(self, x) -> List[torch.Tensor]:
        feats = [x]
        if self.depth >= 1:
            if self.custom_stem is not None:
                y = self.custom_stem(x)
            else:
                y = F.relu(self.bn1(self.conv1(x)))
            y = self._att(0, y)
            feats.append(y)
        for i in range(2, self.depth + 1):
            li = i - 2
            if li == 0:
                y = max_pool_same(y, 3, 2, 1)
            y = getattr(self, f"layer{li + 1}")(y)
            y = self._att(li + 1, y)
            feats.append(y)
        return feats


class CCAVQResNetEncoder(nn.Module):
    """A ``backbone`` (ResNet with per-stage CCA) whose stage outputs are
    quantized by the encoder's own ``codebooks``.  ``forward(x, train,
    init_codebook, generator)`` -> (features, commitment / depth, usage
    vector); features[0] is the input, features[1:] the quantized stages."""

    def __init__(self, out_channels, block: str, layers, vq_cfg, depth: int = 5,
                 in_channels: int = 3, padding_mode: str = "zeros",
                 cca: Sequence[bool] = (False, False, True, True, True),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = ResNetEncoder(out_channels, block, layers, depth, in_channels,
                                      padding_mode, generator, cca=cca)
        self.codebooks = make_vq_module(vq_cfg, list(out_channels), depth, generator)

    def encoder_channels(self):
        return self.backbone.encoder_channels()

    def forward(self, x, train: bool = False, init_codebook: bool = False,
                generator: Optional[torch.Generator] = None):
        feats = self.backbone(x)
        features = list(feats[1:])
        commit, usage = quantize_stages(self.codebooks, features, x, train, init_codebook,
                                        generator)
        return [feats[0]] + features, commit, usage
