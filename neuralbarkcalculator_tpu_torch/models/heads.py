"""The FCN segmentation head (reference models.py:113-124), in PyTorch.

3x3 conv (in -> in/4, no bias) + BN + ReLU + Dropout + 1x1 conv
(-> classes, with bias), as an ``nn.Sequential`` so its state-dict keys
are the reference's ``classifier.0`` / ``.1`` / ``.4``. ``valid_h``
(feature-resolution valid heights, [B]) masks the input of the 3x3 conv
for exact ragged-height batching (see models/resnet.py).

In train mode with ``dropout > 0``, ``classifier.3`` + ``classifier.4``
(dropout, then the 1x1 conv) run as one op, ``ops/fused_dropout_matmul``,
on the 1x1 conv's own weight and bias; the step's ``dropout_seed`` keys its
mask. Eval mode, and dropout 0, run the modules one by one.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.fused_dropout_matmul import fused_dropout_matmul
from .resnet import BN_EPS, apply_row_mask


class FCNHead(nn.Sequential):
    def __init__(self, in_channels: int, channels: int,
                 dropout: float = 0.1, folded: bool = False):
        inter = in_channels // 4
        super().__init__(
            nn.Conv2d(in_channels, inter, 3, padding=1, bias=folded),
            nn.Identity() if folded else nn.BatchNorm2d(inter, eps=BN_EPS),
            nn.ReLU(),
            nn.Dropout(dropout),
            nn.Conv2d(inter, channels, 1),
        )
        self.in_channels = in_channels
        self.channels = channels
        self.dropout = dropout
        self.folded = folded

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                dropout_seed: int | None = None) -> torch.Tensor:
        x = apply_row_mask(x, valid_h)
        if not (self.training and self.dropout > 0):
            for layer in self:
                x = layer(x)
            return x
        if dropout_seed is None:
            raise ValueError("FCNHead in train mode with dropout > 0 needs "
                             "the step's dropout_seed")
        for layer in list(self)[:3]:
            x = layer(x)
        conv = self[4]
        w = conv.weight.view(conv.out_channels, conv.in_channels).t()
        return fused_dropout_matmul(x, w, conv.bias, dropout_seed,
                                    self.dropout)
