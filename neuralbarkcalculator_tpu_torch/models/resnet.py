"""Dilated ResNet backbones with torchvision state-dict names, in PyTorch.

The reference backbone is torchvision ``resnet50`` with
``replace_stride_with_dilation=[False, True, True]`` wrapped in
``IntermediateLayerGetter({'layer4': 'out'})`` (reference
models.py:127-139). Module names follow torchvision's, so a reference
``best_model.pt`` loads with ``load_state_dict``. Output stride is 8;
layer3/layer4 run at dilation 2/4 and the 3x3 conv carries the stride
(ResNet v1.5).

Public tensors are NHWC, like the JAX package's; inside, the modules run
NCHW (an NHWC tensor viewed as NCHW is already ``channels_last``).

``folded``: every BatchNorm has been constant-folded into its producer
conv (models/fold.py). The BN modules are ``nn.Identity`` and the convs
carry biases.

Ragged-height batching (``valid_h``): images of different trimmed heights
are zero-padded to one static height. A row mask zeroes the input of
every op whose kernel mixes rows (each block's 3x3 conv and the max pool;
the head masks its 3x3 conv), which is what per-image conv zero padding
gives at the true bottom edge. 1x1 convs, BN and ReLU are pointwise, so
the rows they make past ``valid_h`` are cleaned at the next masked op.
Per-stage valid heights follow ``conv_out_size``.

Width partitioning (``width``, the model group of a mesh, JAX's ``model``
axis): each rank holds a strip of the width. The stem, the max pool and
each block's ``conv2`` run through parallel/spatial.py's halo exchange;
the 1x1 convs, the strided 1x1 downsample included, run on the strip as
they are. Rows are not split, so the row masks do not change. The int8
twins split the same way: the float stem reads the input's halo, the max
pool and each block's int8 ``conv2`` exchange theirs (models/qops.py's
``widen``), the 1x1 convs run on the strip.

``QuantizedResNet`` / ``QuantizedBottleneck`` are the int8 inference
twins (JAX ``resnet.py`` with ``quantized=True``; models/quantize.py
builds them): NHWC from the stem to the features, every conv but the
float stem an int8 GEMM (models/qops.py), the same row masks on int8
tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.distributed import World
from ..parallel.spatial import (STEM_HALO, STRIP_MULTIPLE, conv2d_rows,
                                conv2d_w, is_split, max_pool2d_w)
from .qops import QConv, mask_rows, quantize_act, widen

BN_EPS = 1e-5  # torchvision BatchNorm2d default


def conv_out_size(h, kernel: int, stride: int, padding: int):
    """Conv output length along one dim (ints or integer tensors)."""
    return (h + 2 * padding - kernel) // stride + 1


def row_mask(valid_h: torch.Tensor, height: int,
             dtype: torch.dtype) -> torch.Tensor:
    """[B] valid heights -> [B, 1, height, 1] {0,1} mask (NCHW rows)."""
    rows = torch.arange(height, device=valid_h.device)
    return (rows[None, :] < valid_h[:, None]).to(dtype)[:, None, :, None]


def apply_row_mask(x: torch.Tensor, valid_h: torch.Tensor | None
                   ) -> torch.Tensor:
    """Zero rows >= valid_h of an NCHW tensor; no-op when valid_h is None."""
    if valid_h is None:
        return x
    return x * row_mask(valid_h, x.shape[2], x.dtype)


def _norm(channels: int, folded: bool) -> nn.Module:
    return nn.Identity() if folded else nn.BatchNorm2d(channels, eps=BN_EPS)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4, stride on the 3x3 conv)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 folded: bool = False):
        super().__init__()
        bias = folded
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=bias)
        self.bn1 = _norm(planes, folded)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=bias)
        self.bn2 = _norm(planes, folded)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=bias)
        self.bn3 = _norm(planes * 4, folded)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=bias),
                _norm(planes * 4, folded))

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                width: World | None = None) -> torch.Tensor:
        """``width``: the model group that splits the width, or None."""
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        # conv2 is the only row-mixing op in the block, and the only one
        # that reads across a strip's edge
        out = apply_row_mask(out, valid_h)
        out = F.relu(self.bn2(conv2d_w(self.conv2, out, width)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class _ResNetLayers(nn.Module):
    """The stage layout shared by the float and the int8 backbones:
    ``layer1`` ... ``layer4`` of blocks made by ``make_block(inplanes,
    planes, stride, dilation, has_downsample)``, torchvision's stride ->
    dilation replacement, and the valid-row arithmetic of the masked
    forward."""

    supports_ragged = True  # row masks make padded batches exact
    # width partitioning: a strip is a multiple of the stride before
    # layer3, and the 7x7/2 stem's halo comes with the input
    strip_multiple = STRIP_MULTIPLE
    stem_halo = STEM_HALO

    def _build_layers(self, stage_sizes: Sequence[int],
                      replace_stride_with_dilation: Sequence[bool],
                      make_block) -> None:
        self.stage_sizes = tuple(stage_sizes)
        self.replace_stride_with_dilation = tuple(
            replace_stride_with_dilation)
        self._strides = []  # each stage's stride after dilation replacement
        inplanes, dilation = 64, 1
        for stage, num_blocks in enumerate(self.stage_sizes):
            planes = 64 * (2 ** stage)
            stride = 1 if stage == 0 else 2
            prev_dilation = dilation
            if stage > 0 and self.replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            blocks = []
            for block in range(num_blocks):
                first = block == 0
                blocks.append(make_block(
                    inplanes, planes, stride if first else 1,
                    prev_dilation if first else dilation,
                    first and (stride != 1 or inplanes != planes * 4)))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            self._strides.append(stride)
        self.out_channels = inplanes

    @property
    def feature_stride(self) -> int:
        """Output stride: stem (2) x pool (2) x each non-dilated stage."""
        stride = 4
        for s in self._strides:
            stride *= s
        return stride

    def _blocks(self, x: torch.Tensor, h, **block_kwargs) -> torch.Tensor:
        """Every block in order; ``h`` the valid rows after the max pool
        (or None), updated at each stage's strided conv; ``block_kwargs``
        passed on to each block."""
        for stage, stride in enumerate(self._strides):
            for i, block in enumerate(getattr(self, f"layer{stage + 1}")):
                x = block(x, valid_h=h, **block_kwargs)
                if i == 0 and h is not None and stride != 1:
                    h = conv_out_size(h, 3, stride, 1)
        return x

    def valid_feature_height(self, valid_h):
        """Valid rows of the feature map for input valid_h (the same conv
        arithmetic the masked forward uses)."""
        h = conv_out_size(valid_h, 7, 2, 3)   # stem conv
        h = conv_out_size(h, 3, 2, 1)         # max pool
        for stride in self._strides:
            if stride != 1:
                h = conv_out_size(h, 3, stride, 1)  # stage's strided conv2
        return h


class DilatedResNet(_ResNetLayers):
    """ResNet backbone with stride->dilation replacement, returning the
    layer4 feature map."""

    supports_quantize = True  # an int8 twin (QuantizedResNet)
    bn_eps = BN_EPS

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 replace_stride_with_dilation: Sequence[bool] = (
                     False, True, True),
                 folded: bool = False):
        super().__init__()
        self.folded = folded
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=folded)
        self.bn1 = _norm(64, folded)
        self._build_layers(
            stage_sizes, replace_stride_with_dilation,
            lambda cin, planes, stride, dilation, ds: Bottleneck(
                cin, planes, stride, dilation, ds, folded=folded))

    def folded_twin(self) -> "DilatedResNet":
        """The same backbone with BN folded (models/fold.py)."""
        return DilatedResNet(self.stage_sizes,
                             self.replace_stride_with_dilation, folded=True)

    def quantized_twin(self) -> "QuantizedResNet":
        """The int8 backbone of the same layout (models/quantize.py fills
        it)."""
        return QuantizedResNet(self.stage_sizes,
                               self.replace_stride_with_dilation)

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                dropout_seed: int | None = None,
                shard: tuple[int, int] = (0, 1),
                width: World | None = None) -> torch.Tensor:
        """NCHW input (zero below valid_h) -> NCHW layer4 features. The
        ResNet has no random layer: ``dropout_seed`` and ``shard`` are
        taken, as every backbone takes them, and ignored. ``width``: the
        model group that splits the width; then ``x`` is this rank's
        strip with the stem's halo (``stem_halo`` columns,
        zero past the image's edges) and the features are its strip."""
        if is_split(width):
            x = conv2d_rows(self.conv1, x)
        else:
            x = self.conv1(x)
        x = F.relu(self.bn1(x))
        h = None if valid_h is None else conv_out_size(valid_h, 7, 2, 3)
        # masked zeros equal max_pool2d's -inf padding here because the
        # pool's input is post-ReLU (>= 0); so do a strip's edge zeros
        x = apply_row_mask(x, h)
        x = max_pool2d_w(x, width)
        if h is not None:
            h = conv_out_size(h, 3, 2, 1)
        return self._blocks(x, h, width=width)


class QuantizedBottleneck(nn.Module):
    """The int8 bottleneck (JAX ``Bottleneck._quantized_forward``): int8
    NHWC at the input's scale s_in -> int8 at the block's s_out. conv3's
    epilogue and the downsample branch land in s_out units, so the whole
    residual add runs there: the main branch dequantized (m, b divided by
    s_out), the identity either the downsample branch requantized to int8
    at s_out (a symmetric clip) or ``x_q * s_ratio`` (s_in / s_out). The
    sum is rounded and clipped to [0, 127], which is also its ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = QConv(inplanes, planes)
        self.conv2 = QConv(planes, planes, 3, stride, dilation)
        self.conv3 = QConv(planes, planes * 4)
        self.downsample = (QConv(inplanes, planes * 4, 1, stride)
                           if has_downsample else None)
        if not has_downsample:
            self.register_buffer("s_ratio", torch.ones(()))

    def forward(self, x_q: torch.Tensor,
                valid_h: torch.Tensor | None = None,
                width: World | None = None) -> torch.Tensor:
        """``width``: the model group that splits the width, or None."""
        # conv2 is the only row-mixing op in the block, and the only one
        # that reads across a strip's edge
        t1 = mask_rows(self.conv1.relu(x_q), valid_h)
        out = self.conv3.dequant(self.conv2.relu(*widen(self.conv2, t1,
                                                        width)))
        if self.downsample is not None:
            out.add_(self.downsample.signed(x_q))
        else:
            out.add_(x_q * self.s_ratio)
        return out.round_().clamp_(0, 127).to(torch.int8)


class QuantizedResNet(_ResNetLayers):
    """The int8 dilated ResNet (JAX ``DilatedResNet`` with
    ``quantized=True``). The stem stays a float conv (BN folded, with a
    bias; float32 weights, run at the input's dtype), then ReLU, the row
    mask and the max pool;
    the pooled map is quantized by ``inv_s_stem`` (the pool is a max of
    post-ReLU values, so quantizing after it equals quantizing before it)
    and every block runs int8. NHWC in, int8 NHWC features out."""


    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 replace_stride_with_dilation: Sequence[bool] = (
                     False, True, True)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=True)
        self.register_buffer("inv_s_stem", torch.ones(()))
        self._build_layers(stage_sizes, replace_stride_with_dilation,
                           QuantizedBottleneck)

    def stem(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
             width: World | None = None) -> torch.Tensor:
        """NHWC images (zero below valid_h) -> the int8 NHWC map after the
        max pool. The conv runs at ``x``'s dtype (the engine's), its
        float32 weights cast to it, as the JAX package casts them.
        ``width``: as ``DilatedResNet.forward``'s (``x`` carries the
        stem's halo)."""
        conv = self.conv1
        padding = (conv.padding[0], 0) if is_split(width) else conv.padding
        y = F.relu(F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                            conv.bias.to(x.dtype), conv.stride, padding))
        h = None if valid_h is None else conv_out_size(valid_h, 7, 2, 3)
        y = max_pool2d_w(apply_row_mask(y, h), width)
        return quantize_act(y.permute(0, 2, 3, 1),
                            self.inv_s_stem).contiguous()

    def blocks(self, x_q: torch.Tensor, valid_h: torch.Tensor | None = None,
               width: World | None = None) -> torch.Tensor:
        """The int8 blocks from the stem's int8 map; ``valid_h`` are the
        images' valid rows (not the map's)."""
        h = None if valid_h is None else conv_out_size(
            conv_out_size(valid_h, 7, 2, 3), 3, 2, 1)
        return self._blocks(x_q, h, width=width)

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                width: World | None = None) -> torch.Tensor:
        """NHWC images -> int8 NHWC features; ``width``: the model group
        that splits the width (``x`` is the rank's strip with the stem's
        halo, the features its strip), or None."""
        return self.blocks(self.stem(x, valid_h, width), valid_h, width)


def resnet50_dilated() -> DilatedResNet:
    """Backbone of reference fcn_resnet50 / deeplabv3_resnet50
    (models.py:127-134)."""
    return DilatedResNet(stage_sizes=(3, 4, 6, 3))


def resnet101_dilated() -> DilatedResNet:
    """Backbone of reference fcn_resnet101 / deeplabv3_resnet101
    (models.py:142-149)."""
    return DilatedResNet(stage_sizes=(3, 4, 23, 3))
