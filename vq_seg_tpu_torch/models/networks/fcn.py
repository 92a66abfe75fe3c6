"""FCN-32s, counterpart of the JAX package's ``models/networks/fcn.py``:
a VGG encoder, ``fc6`` (a VALID 7x7 conv to 4096 channels) and ``fc7`` (a
1x1 conv to 4096), each followed by ReLU and, in training, dropout 0.5,
then the 1x1 ``score`` conv and the x32 transposed conv ``upscore`` from a
bilinear kernel, resized (half-pixel bilinear) to the input where it
differs.  The convs have a bias and torch's default init.

``upscore`` is flax's ``nn.ConvTranspose((64, 64), strides=32)`` with its
default "SAME" padding, which correlates the stride-dilated input with the
kernel as it is: ``nn.ConvTranspose2d(k=64, s=32, p=16)`` with the flax
kernel flipped in both spatial axes and its in/out axes swapped
(``utils/convert.py``).  Its kernel starts as the bilinear one (the same
filter on every class's diagonal, zero elsewhere) and trains.  (The JAX
module also holds that starting kernel as a parameter ``upscore_kernel``
that its forward never reads; the port keeps no copy of it.)

Dropout is flax's (``deeplabv3.apply_dropout``): ``forward(x, train,
dropout)`` takes None (PyTorch's global generator) or a callable ``shape
-> keep mask``, called for ``fc6``'s output and then ``fc7``'s.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..encoders import make_encoder
from ..layers import ConvPad, resize_bilinear, torch_conv_default
from . import register
from .deeplabv3 import apply_dropout


def bilinear_upsampling_kernel(channels: int, kernel_size: int) -> np.ndarray:
    """(channels, channels, k, k) float32: the 2D bilinear filter on the
    diagonal (reference ``get_upsampling_weight``)."""
    factor = (kernel_size + 1) // 2
    center = factor - 1 if kernel_size % 2 == 1 else factor - 0.5
    og = np.ogrid[:kernel_size, :kernel_size]
    filt = (1 - abs(og[0] - center) / factor) * (1 - abs(og[1] - center) / factor)
    w = np.zeros((channels, channels, kernel_size, kernel_size), np.float32)
    for i in range(channels):
        w[i, i] = filt
    return w


@register("fcn32s")
class FCN32s(nn.Module):
    """``forward(x, train=False, dropout=None)`` -> (logits, None).
    ``bn_eps``/``bn_momentum`` (the trainers' decoder BN settings) are
    accepted and not read: the network has no decoder BN."""

    def __init__(self, encoder_name: str, num_classes: int,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder, enc_ch = make_encoder(encoder_name, in_channels, 5, generator=generator)
        conv = dict(bias=True, init=torch_conv_default, generator=generator)
        self.fc6 = ConvPad(enc_ch[-1], 4096, 7, **conv)
        self.fc7 = ConvPad(4096, 4096, 1, **conv)
        self.score = ConvPad(4096, num_classes, 1, **conv)
        self.upscore = nn.ConvTranspose2d(num_classes, num_classes, 64, stride=32, padding=16,
                                          bias=False)
        with torch.no_grad():
            self.upscore.weight.copy_(torch.from_numpy(
                bilinear_upsampling_kernel(num_classes, 64)))

    def forward(self, x, train: bool = False, dropout=None):
        y = F.relu(self.fc6(self.encoder(x)[-1]))
        if train:
            y = apply_dropout(y, 0.5, dropout)
        y = F.relu(self.fc7(y))
        if train:
            y = apply_dropout(y, 0.5, dropout)
        y = self.upscore(self.score(y))
        if y.shape[-2:] != x.shape[-2:]:
            y = resize_bilinear(y, x.shape[-2:])
        return y, None
