"""SemiWeedNet, counterpart of the JAX package's
``models/networks/semiweednet.py``: DeepLab v3+ (output stride 16, atrous
rates 6/12/18) with ``SKA`` on the deepest feature, and a projection MLP
(two dense layers, flax ``Dense`` init) on the global average of the
deepest feature *before* the SKA, for the ``semiweed`` trainer's
diagonal-cosine loss."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..layers import dense, global_avg_pool
from ..modules.attention import SKA
from . import register
from .deeplabv3 import DeepLabV3Plus


@register("semiweednet")
class SemiWeedNet(DeepLabV3Plus):
    """``forward(x, issup=False, train=False, dropout=None)`` -> (logits,
    the (N, 128) MLP output in training when not ``issup``, else None)."""

    def __init__(self, encoder_name: str, num_classes: int,
                 encoder_weights: Optional[str] = None, in_channels: int = 3,
                 decoder_channels: int = 256, depth: int = 5, encoder_output_stride: int = 16,
                 decoder_atrous_rates: Sequence[int] = (6, 12, 18), upsampling: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__(encoder_name, num_classes, encoder_weights, in_channels,
                         decoder_channels, depth, encoder_output_stride, decoder_atrous_rates,
                         upsampling, generator)
        ch = self.encoder.encoder_channels()[-1]
        self.ska = SKA(ch, generator=generator)
        self.mlp_0 = dense(ch, ch, generator)
        self.mlp_1 = dense(ch, 128, generator)

    def forward(self, x, issup: bool = False, train: bool = False, dropout=None):
        feats = list(self.encoder(x))
        last = feats[-1]
        feats[-1] = self.ska(last)
        out = self._logits(x, feats, train, dropout)
        if train and not issup:
            g = global_avg_pool(last, keepdims=False).reshape(x.shape[0], -1)
            return out, self.mlp_1(F.relu(self.mlp_0(g)))
        return out, None
