"""Segmentation heads: FCN (reference models.py:113-124) and DeepLabV3
(torchvision's, used by reference models.py:46-71), in PyTorch.

- ``FCNHead``: 3x3 conv (in -> in/4, no bias) + BN + ReLU + Dropout + 1x1
  conv (-> classes, with bias), as an ``nn.Sequential`` so its state-dict
  keys are the reference's ``classifier.0`` / ``.1`` / ``.4``.
- ``DeepLabHead``: ASPP (a 1x1 branch, atrous 3x3 branches at rates
  12/24/36 with padding = rate, a pooled branch), projected to 256
  channels, then 3x3 conv + BN + ReLU + the 1x1 classifier. The module
  names are torchvision's (``classifier.0.convs.{0..4}``,
  ``classifier.0.project``, ``classifier.{1,2,4}``), so a reference
  ``best_model.pt`` loads unchanged.

``valid_h`` (feature-resolution valid heights, [B]) masks the input of
every row-mixing op for exact ragged-height batching (see
models/resnet.py): the FCN head's 3x3 conv; DeepLab's ASPP input and its
3x3 conv. DeepLab's pooled branch is a masked mean, the sum over the rows
divided by ``valid_h * W``, broadcast to every row.

In train mode with ``dropout > 0``, the FCN head's ``classifier.3`` +
``classifier.4`` (dropout, then the 1x1 conv) run as one op,
``ops/fused_dropout_matmul``, on the 1x1 conv's own weight and bias; the
step's ``dropout_seed`` keys its mask. Eval mode, and dropout 0, run the
modules one by one. The DeepLab head has no train mode in the port yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_dropout_matmul import fused_dropout_matmul
from .resnet import BN_EPS, apply_row_mask

ASPP_RATES = (12, 24, 36)
ASPP_CHANNELS = 256


def _norm(channels: int, folded: bool) -> nn.Module:
    return nn.Identity() if folded else nn.BatchNorm2d(channels, eps=BN_EPS)


class FCNHead(nn.Sequential):
    def __init__(self, in_channels: int, channels: int,
                 dropout: float = 0.1, folded: bool = False):
        inter = in_channels // 4
        super().__init__(
            nn.Conv2d(in_channels, inter, 3, padding=1, bias=folded),
            _norm(inter, folded),
            nn.ReLU(),
            nn.Dropout(dropout),
            nn.Conv2d(inter, channels, 1),
        )
        self.in_channels = in_channels
        self.channels = channels
        self.dropout = dropout
        self.folded = folded

    def folded_twin(self) -> "FCNHead":
        """The same head with BN folded (models/fold.py)."""
        return FCNHead(self.in_channels, self.channels, self.dropout,
                       folded=True)

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


class AtrousConv2d(nn.Conv2d):
    """An ASPP branch's 3x3 conv at dilation d and padding d, computed as
    one undilated conv over the input's d x d phases (space-to-batch): the
    same products, output pixel by output pixel. cuDNN's own dilated conv
    at these rates in bf16 channels_last runs its direct kernel, with or
    without cudnn.benchmark: seconds for a batch of 8 at 2048 x 128 x 128
    on an H100, against milliseconds this way (chip_smoke.py's
    atrous_times; the figures are in PERF.md)."""

    def __init__(self, cin: int, cout: int, rate: int, bias: bool):
        super().__init__(cin, cout, 3, padding=rate, dilation=rate,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dilation[0]
        b, c, h, w = x.shape
        # pad by d, then up to a multiple of d: phase (r, s) takes the
        # padded rows r, r + d, ... and the columns s, s + d, ...
        ph, pw = -(-(h + 2 * d) // d) * d, -(-(w + 2 * d) // d) * d
        xp = F.pad(x, (d, pw - w - d, d, ph - h - d))
        qh, qw = ph // d, pw // d
        # [b, c, qh, d, qw, d] -> channels_last [b * d * d, c, qh, qw]
        xs = (xp.reshape(b, c, qh, d, qw, d).permute(0, 3, 5, 2, 4, 1)
              .reshape(b * d * d, qh, qw, c).permute(0, 3, 1, 2))
        ys = F.conv2d(xs, self.weight, self.bias)
        o, rh, rw = ys.shape[1:]
        # row q of phase (r, s)'s output is output row q * d + r
        y = (ys.permute(0, 2, 3, 1).reshape(b, d, d, rh, rw, o)
             .permute(0, 3, 1, 4, 2, 5).reshape(b, rh * d, rw * d, o)
             .permute(0, 3, 1, 2))
        return y[:, :, :h, :w]


def _conv_bn_relu(conv: nn.Conv2d, folded: bool) -> nn.Sequential:
    """torchvision's ASPP branch layout: conv (no bias), BN, ReLU."""
    return nn.Sequential(conv, _norm(conv.out_channels, folded), nn.ReLU())


class ASPPPooling(nn.Sequential):
    """torchvision's ASPPPooling: index 0 is the global pool, then conv, BN,
    ReLU. The pool here is the masked mean of the module docstring, and
    the 1x1 result is broadcast to every position (torchvision's bilinear
    upsample of a 1x1 map is exactly that)."""

    def __init__(self, cin: int, cout: int, folded: bool):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         nn.Conv2d(cin, cout, 1, bias=folded),
                         _norm(cout, folded), nn.ReLU())

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None
                ) -> torch.Tensor:
        # the sum in float32: a bf16 sum over 128 x 128 positions drifts
        total = x.sum(dim=(2, 3), keepdim=True, dtype=torch.float32)
        count = (x.shape[2] if valid_h is None
                 else valid_h.to(torch.float32).view(-1, 1, 1, 1))
        pooled = (total / (count * x.shape[3])).to(x.dtype)
        for layer in list(self)[1:]:
            pooled = layer(pooled)
        return pooled.expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    """torchvision's ASPP: ``convs`` (the 1x1 branch, three atrous
    branches, the pooled branch) concatenated and projected back to 256
    channels, then ReLU and Dropout(0.5)."""

    def __init__(self, in_channels: int, rates: Sequence[int] = ASPP_RATES,
                 folded: bool = False):
        super().__init__()
        c = ASPP_CHANNELS
        self.convs = nn.ModuleList(
            [_conv_bn_relu(nn.Conv2d(in_channels, c, 1, bias=folded),
                           folded)]
            + [_conv_bn_relu(AtrousConv2d(in_channels, c, rate, folded),
                             folded) for rate in rates]
            + [ASPPPooling(in_channels, c, folded)])
        self.project = nn.Sequential(
            nn.Conv2d(c * len(self.convs), c, 1, bias=folded),
            _norm(c, folded), nn.ReLU(), nn.Dropout(0.5))

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None
                ) -> torch.Tensor:
        x = apply_row_mask(x, valid_h)  # the atrous branches mix rows
        branches = [conv(x) for conv in self.convs[:-1]]
        branches.append(self.convs[-1](x, valid_h))
        return self.project(torch.cat(branches, dim=1))


class DeepLabHead(nn.Sequential):
    """torchvision's DeepLabHead: ASPP, 3x3 conv, BN, ReLU, 1x1 classifier
    (with bias). Eval only in this port: train mode raises."""

    def __init__(self, in_channels: int, channels: int,
                 folded: bool = False):
        c = ASPP_CHANNELS
        super().__init__(
            ASPP(in_channels, folded=folded),
            nn.Conv2d(c, c, 3, padding=1, bias=folded),
            _norm(c, folded),
            nn.ReLU(),
            nn.Conv2d(c, channels, 1),
        )
        self.in_channels = in_channels
        self.channels = channels
        self.folded = folded

    def folded_twin(self) -> "DeepLabHead":
        """The same head with BN folded (models/fold.py)."""
        return DeepLabHead(self.in_channels, self.channels, folded=True)

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                dropout_seed: int | None = None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training the DeepLabV3 head (its ASPP dropout) is not ported "
                "yet: ROADMAP Queue A item 6")
        x = self[0](x, valid_h)
        x = apply_row_mask(x, valid_h)
        for layer in list(self)[1:]:
            x = layer(x)
        return x


__all__ = ["ASPP", "ASPPPooling", "AtrousConv2d", "DeepLabHead", "FCNHead"]
