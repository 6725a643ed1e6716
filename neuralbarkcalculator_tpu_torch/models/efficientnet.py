"""EfficientNet-B0..B7 feature extractor, in PyTorch.

The reference's alternate backbones (models.py:86-110) wrap
``efficientnet_pytorch.EfficientNet.from_pretrained('efficientnet-b{n}')``
as ``self.model`` and use ``extract_features``: stem -> MBConv stages ->
1x1 head conv, before the pool, at output stride 32 with
``EFFICIENTNET_INPLANES[n]`` channels. The module names are
efficientnet_pytorch's under ``backbone.model.`` (``_conv_stem``, ``_bn0``,
``_blocks.{j}._expand_conv`` / ``._bn0`` / ``._depthwise_conv`` /
``._bn1`` / ``._se_reduce`` / ``._se_expand`` / ``._project_conv`` /
``._bn2``, ``_conv_head``, ``_bn1``), so a reference checkpoint loads
unchanged (its unused ImageNet ``_fc`` is dropped by models/convert.py).

- Convolutions pad TF-style "SAME": ``total = max((ceil(n/s) - 1) * s + k
  - n, 0)`` per axis, ``total // 2`` before and the rest after, from the
  input's own size (efficientnet_pytorch's ``Conv2dStaticSamePadding``, and
  flax's ``"SAME"``). A stride-2 conv on an even size pads one row more at
  the bottom than at the top.
- BatchNorm: eps 1e-3, torch momentum 0.01 (flax's 0.99); in train mode
  batch statistics, the running ones updated. Activations are swish
  (``F.silu``); squeeze-excite pools, reduces with bias, swish, expands
  with bias, sigmoid.
- Stochastic depth in train mode, on the residual blocks only (stride 1,
  in == out): each sample's branch is dropped with probability
  ``DROP_CONNECT_RATE * j / blocks`` for block j (0.2, efficientnet_
  pytorch's and the JAX package's), survivors rescaled by 1 / keep; the
  draws come from the step's backbone generator (models/seeding.py).
- ``folded``: BN folded into the producer convs (models/fold.py).

Ragged batches are not supported: the stride-2 SAME padding depends on
the true height's parity, so a zero-padded batch cannot reproduce each
image's own conv phase; the predict engine runs these backbones at exact
heights.

The tables are the JAX package's (neuralbarkcalculator_tpu/models/
efficientnet.py), which mirror efficientnet_pytorch's params; the port
keeps its own copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .seeding import BACKBONE_STREAM, drop_path, layer_generator

# (width_mult, depth_mult) per variant b0..b7 (efficientnet_pytorch params)
SCALING = [
    (1.0, 1.0), (1.0, 1.1), (1.1, 1.2), (1.2, 1.4),
    (1.4, 1.8), (1.6, 2.2), (1.8, 2.6), (2.0, 3.1),
]

# base blocks: (expand_ratio, channels, repeats, stride, kernel)
BASE_BLOCKS = [
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

EFFICIENTNET_INPLANES = [1280, 1280, 1408, 1536, 1792, 2048, 2304, 2560]

BN_EPS = 1e-3  # efficientnet_pytorch's batch_norm_epsilon
BN_MOMENTUM = 0.01  # torch's convention for flax's 0.99
SE_RATIO = 0.25
DROP_CONNECT_RATE = 0.2


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:  # prevent >10% reduction
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def block_table(variant: int) -> list[tuple[int, int]]:
    """The flat ``_blocks.{j}`` order as (stage, index in stage)."""
    _, depth_mult = SCALING[variant]
    return [(stage, i)
            for stage, (_, _, repeats, _, _) in enumerate(BASE_BLOCKS)
            for i in range(round_repeats(repeats, depth_mult))]


def same_padding(n: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF "SAME" padding of one axis of length n: (before, after)."""
    total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` (same state-dict names) with TF "SAME" padding from
    the input's size. Symmetric padding goes to the convolution itself;
    asymmetric padding (a stride-2 conv on an even size) is an explicit
    ``F.pad`` first."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_padding(x.shape[2], kh, sh)
        left, right = same_padding(x.shape[3], kw, sw)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (top, left), 1, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1,
                        self.groups)


def _norm(channels: int, folded: bool) -> nn.Module:
    return (nn.Identity() if folded
            else nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM))


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite
    (efficientnet_pytorch's MBConvBlock); ``drop_rate`` is its stochastic
    depth in train mode."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int,
                 kernel: int, stride: int, folded: bool = False,
                 drop_rate: float = 0.0):
        super().__init__()
        mid = in_ch * expand_ratio
        self.skip = stride == 1 and in_ch == out_ch
        self.drop_rate = drop_rate
        if expand_ratio != 1:
            self._expand_conv = nn.Conv2d(in_ch, mid, 1, bias=folded)
            self._bn0 = _norm(mid, folded)
        else:
            self._expand_conv = None
        self._depthwise_conv = SameConv2d(mid, mid, kernel, stride=stride,
                                          groups=mid, bias=folded)
        self._bn1 = _norm(mid, folded)
        squeezed = max(1, int(in_ch * SE_RATIO))
        self._se_reduce = nn.Conv2d(mid, squeezed, 1)
        self._se_expand = nn.Conv2d(squeezed, mid, 1)
        self._project_conv = nn.Conv2d(mid, out_ch, 1, bias=folded)
        self._bn2 = _norm(out_ch, folded)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = x
        if self._expand_conv is not None:
            h = F.silu(self._bn0(self._expand_conv(h)))
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        # the pool in float32, as the ASPP's (models/heads.py)
        s = h.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(h.dtype)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        h = h * torch.sigmoid(s)
        h = self._bn2(self._project_conv(h))
        if not self.skip:
            return h
        if self.training and self.drop_rate > 0:
            h = drop_path(h, self.drop_rate, generator)
        return h + x


class EfficientNetFeatures(nn.Module):
    """``extract_features``: stem -> MBConv blocks -> 1x1 head conv, each
    with BN and swish. NCHW in, NCHW [B, inplanes, ceil(H/32), ceil(W/32)]
    out. ``generator`` draws the stochastic depth in train mode."""

    def __init__(self, variant: int = 0, folded: bool = False):
        super().__init__()
        width_mult, _ = SCALING[variant]
        in_ch = round_filters(32, width_mult)
        self._conv_stem = SameConv2d(3, in_ch, 3, stride=2, bias=folded)
        self._bn0 = _norm(in_ch, folded)
        blocks = []
        table = block_table(variant)
        for j, (stage, i) in enumerate(table):
            expand, ch, _, stride, kernel = BASE_BLOCKS[stage]
            out_ch = round_filters(ch, width_mult)
            blocks.append(MBConvBlock(
                in_ch, out_ch, expand, kernel, stride if i == 0 else 1,
                folded, DROP_CONNECT_RATE * j / len(table)))
            in_ch = out_ch
        self._blocks = nn.ModuleList(blocks)
        self._conv_head = nn.Conv2d(in_ch, EFFICIENTNET_INPLANES[variant], 1,
                                    bias=folded)
        self._bn1 = _norm(EFFICIENTNET_INPLANES[variant], folded)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = F.silu(self._bn0(self._conv_stem(x)))
        for block in self._blocks:
            x = block(x, generator)
        return F.silu(self._bn1(self._conv_head(x)))


class EfficientNetBackbone(nn.Module):
    """The reference's EfficientNet feature extractor: the net as
    ``self.model`` (so its keys read ``backbone.model._...``)."""

    supports_ragged = False  # TF-SAME phase: exact heights only
    feature_stride = 32
    bn_eps = BN_EPS

    def __init__(self, variant: int = 0, folded: bool = False):
        super().__init__()
        self.variant = variant
        self.folded = folded
        self.model = EfficientNetFeatures(variant, folded)
        self.out_channels = EFFICIENTNET_INPLANES[variant]

    def folded_twin(self) -> "EfficientNetBackbone":
        """The same backbone with BN folded (models/fold.py)."""
        return EfficientNetBackbone(self.variant, folded=True)

    def forward(self, x: torch.Tensor, dropout_seed: int | None = None
                ) -> torch.Tensor:
        """In train mode ``dropout_seed`` (the step's) keys the stochastic
        depth."""
        generator = None
        if self.training and any(b.drop_rate > 0 for b in self.model._blocks):
            if dropout_seed is None:
                raise ValueError("EfficientNet in train mode needs the "
                                 "step's dropout_seed for its stochastic "
                                 "depth")
            generator = layer_generator(dropout_seed, BACKBONE_STREAM,
                                        x.device)
        return self.model(x, generator)

    def valid_feature_height(self, valid_h):
        raise NotImplementedError(
            "ragged batched inference is supported for the ResNet backbones "
            "only: the TF-SAME stride-2 padding depends on the true input "
            "height's parity, so padded batches cannot be exact for "
            "EfficientNet")
