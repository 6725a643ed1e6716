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

``QuantizedFCNHead``, ``QuantizedASPP`` and ``QuantizedDeepLabHead`` are
the int8 inference twins (JAX ``heads.py`` with ``quantized=True``): int8
NHWC features in, float32 NHWC logits out.

``valid_h`` (feature-resolution valid heights, [B]) masks the input of
every row-mixing op for exact ragged-height batching (see
models/resnet.py): the FCN head's 3x3 conv; DeepLab's ASPP input and its
3x3 conv. DeepLab's pooled branch is a masked mean, the sum over the rows
divided by ``valid_h * W``, broadcast to every row.

In train mode with ``dropout > 0``, the FCN head's ``classifier.3`` +
``classifier.4`` (dropout, then the 1x1 conv) run as one op,
``ops/fused_dropout_matmul``, on the 1x1 conv's own weight and bias; the
step's ``dropout_seed`` keys its mask; in a data-parallel run the rank's
element offset in the global batch places its mask (models/seeding.py).
Eval mode, and dropout 0, run the modules one by one.

Width partitioning (``width``, the model group of a mesh; eval mode):
every head runs on this rank's strip of the width (parallel/spatial.py).
The 3x3 convs take a halo of 1 column from each neighbour. The ASPP's
three atrous branches share one exchange at the widest rate that reads
beyond its centre tap (36 columns at 1024 rows), each taking its slice,
and may span several ranks' strips; a branch whose rate reaches past the
whole map (the centre-tap shortcut, decided on the full map's width)
runs on the strip as it is. The pooled branch sums the column sums
gathered over the group (``sum_width_f32``; the int8 ASPP all-reduces
its int32 sums), divided by the full width, so it is the one process's
bit for bit on the CPU. The int8 heads split the same way. In
train mode the DeepLab head's BatchNorms use batch statistics and update
their running ones, and the ASPP's Dropout(0.5) is an inverted dropout
drawn from the step's head generator (models/seeding.py).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_dropout_matmul import fused_dropout_matmul
from ..parallel.distributed import World
from ..parallel.spatial import (all_reduce_int32, conv2d_w, exchange_halo,
                                exchange_halo_nhwc, is_split, sum_width_f32)
from .qops import QConv, mask_rows, quantize_act, widen
from .resnet import BN_EPS, apply_row_mask
from .seeding import HEAD_STREAM, inverted_dropout, layer_generator

ASPP_RATES = (12, 24, 36)
ASPP_CHANNELS = 256


def _norm(channels: int, folded: bool) -> nn.Module:
    return nn.Identity() if folded else nn.BatchNorm2d(channels, eps=BN_EPS)


class FCNHead(nn.Sequential):
    supports_quantize = True  # an int8 twin (QuantizedFCNHead)
    supports_width = True  # its 3x3 conv takes a halo in eval mode

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

    def quantized_twin(self) -> "QuantizedFCNHead":
        """The int8 head of the same widths (models/quantize.py)."""
        return QuantizedFCNHead(self.in_channels, self.channels)

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                dropout_seed: int | None = None,
                shard: tuple[int, int] = (0, 1),
                width: World | None = None) -> torch.Tensor:
        """``shard``: (rank, size) of a data-parallel batch; ``width``:
        the model group that splits the width in eval mode, or None."""
        x = apply_row_mask(x, valid_h)
        if not (self.training and self.dropout > 0):
            x = conv2d_w(self[0], x, width)
            for layer in list(self)[1:]:
                x = layer(x)
            return x
        if dropout_seed is None:
            raise ValueError("FCNHead in train mode with dropout > 0 needs "
                             "the step's dropout_seed")
        for layer in list(self)[:3]:
            x = layer(x)
        # the kernel takes float32 only: under bf16 autocast the ReLU's
        # output is bf16, and this is one extra copy of it (the JAX package
        # runs this layer in bf16, models/heads.py:54-56)
        x = x.float().contiguous()
        conv = self[4]
        w = conv.weight.view(conv.out_channels, conv.in_channels).t()
        # this rank's rows start at row rank * B of the global batch
        return fused_dropout_matmul(x, w, conv.bias, dropout_seed,
                                    self.dropout,
                                    offset=shard[0] * x.numel())


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

    def centre_only(self, h: int, w: int) -> bool:
        """Whether on an h x w map every tap but the centre reads only
        padding (EfficientNet's 16 x 16 maps at crop 512, any map at rate
        36 from 1024 rows / 32)."""
        d = self.dilation[0]
        return d >= h and d >= w

    def forward(self, x: torch.Tensor, halo: bool = False) -> torch.Tensor:
        """``halo``: ``x`` is a strip of the width widened by d columns on
        each side (parallel/spatial.exchange_halo), which takes no width
        padding; the output is the strip's columns. The caller decides the
        centre-tap shortcut on the full map and passes the strip as it is
        when it holds."""
        d = self.dilation[0]
        b, c, h, w = x.shape
        if not halo and self.centre_only(h, w):
            # a 1x1 conv of the centre tap, the same nonzero products
            return F.conv2d(x, self.weight[:, :, 1:2, 1:2], self.bias)
        # pad by d (the width by 0 on a widened strip), then up to a
        # multiple of d: phase (r, s) takes the padded rows r, r + d, ...
        # and the columns s, s + d, ...
        wpad = 0 if halo else d
        ph, pw = -(-(h + 2 * d) // d) * d, -(-(w + 2 * wpad) // d) * d
        xp = F.pad(x, (wpad, pw - w - wpad, d, ph - h - d))
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
        return y[:, :, :h, :w + 2 * (wpad - d)]


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

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                width: World | None = None) -> torch.Tensor:
        """``width``: the model group whose strips make the map's width;
        the mean is the full map's, broadcast to the strip."""
        # the sum in float32: a bf16 sum over 128 x 128 positions drifts
        total = sum_width_f32(x, width)[:, :, None, None]
        count = (x.shape[2] if valid_h is None
                 else valid_h.to(torch.float32).view(-1, 1, 1, 1))
        full_w = x.shape[3] * (width.size if is_split(width) else 1)
        pooled = (total / (count * full_w)).to(x.dtype)
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

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                shard: tuple[int, int] = (0, 1),
                width: World | None = None) -> torch.Tensor:
        """``generator`` draws the dropout's mask in train mode; ``shard``:
        (rank, size) of a data-parallel batch; ``width``: the model group
        that splits the width in eval mode, or None."""
        x = apply_row_mask(x, valid_h)  # the atrous branches mix rows
        branches = [self.convs[0](x)]
        h, w = x.shape[2:]
        full_w = w * width.size if is_split(width) else w
        haloed = [conv[0].dilation[0] for conv in self.convs[1:-1]
                  if is_split(width)
                  and not conv[0].centre_only(h, full_w)]
        if haloed:  # one exchange at the widest rate for every branch
            reach = max(haloed)
            wide = exchange_halo(x, reach, reach, width)
        for conv in self.convs[1:-1]:
            atrous, d = conv[0], conv[0].dilation[0]
            y = (atrous(wide[..., reach - d:reach + w + d], halo=True)
                 if d in haloed else atrous(x))
            for layer in list(conv)[1:]:
                y = layer(y)
            branches.append(y)
        branches.append(self.convs[-1](x, valid_h, width))
        y = torch.cat(branches, dim=1)
        for layer in list(self.project)[:3]:
            y = layer(y)
        if not self.training:
            return y
        if generator is None:
            raise ValueError("the ASPP in train mode needs the step's "
                             "generator for its dropout")
        return inverted_dropout(y, self.project[3].p, generator, shard)


class DeepLabHead(nn.Sequential):
    """torchvision's DeepLabHead: ASPP, 3x3 conv, BN, ReLU, 1x1 classifier
    (with bias). In train mode the step's ``dropout_seed`` keys the ASPP's
    dropout."""

    supports_quantize = True  # an int8 twin (QuantizedDeepLabHead)
    supports_width = True  # halo exchanges and a pooled sum, in eval mode

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

    def quantized_twin(self) -> "QuantizedDeepLabHead":
        """The int8 head of the same widths (models/quantize.py)."""
        return QuantizedDeepLabHead(self.in_channels, self.channels)

    def forward(self, x: torch.Tensor, valid_h: torch.Tensor | None = None,
                dropout_seed: int | None = None,
                shard: tuple[int, int] = (0, 1),
                width: World | None = None) -> torch.Tensor:
        """``width``: the model group that splits the width in eval mode,
        or None."""
        generator = None
        if self.training:
            if dropout_seed is None:
                raise ValueError("DeepLabHead in train mode needs the step's "
                                 "dropout_seed")
            generator = layer_generator(dropout_seed, HEAD_STREAM, x.device)
        x = self[0](x, valid_h, generator, shard, width)
        x = conv2d_w(self[1], apply_row_mask(x, valid_h), width)
        for layer in list(self)[2:]:
            x = layer(x)
        return x


class QuantizedFCNHead(nn.Module):
    """The int8 FCN head (JAX ``FCNHead._quantized_forward``): int8 NHWC
    backbone features (their scale is in ``conv1``'s epilogue) -> float32
    NHWC logits. The row mask zeroes the 3x3 conv's input; the dropout is
    an inference no-op and left out."""

    supports_width = True  # its 3x3 conv takes an int8 halo

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv1 = QConv(in_channels, in_channels // 4, 3)
        self.conv2 = QConv(in_channels // 4, channels)

    def forward(self, x_q: torch.Tensor,
                valid_h: torch.Tensor | None = None,
                width: World | None = None) -> torch.Tensor:
        """``width``: the model group that splits the width, or None."""
        return self.conv2.dequant(self.conv1.relu(
            *widen(self.conv1, mask_rows(x_q, valid_h), width)))


class QuantizedASPP(nn.Module):
    """The int8 ASPP (JAX ``ASPP._quantized_forward``): int8 NHWC at s_in
    -> int8 at s_proj. The 1x1 branch ``b0`` and the atrous branches
    ``b1``-``b3`` run int8 and requantize to one concat scale s_cat. The
    pooled branch sums the int8 map exactly in int32 (so a padded batch
    equals per-image runs), dequantizes by ``s_in``, divides by the true
    pixel count (valid_h * W), runs the 1x1 conv in float32
    (``pool_kernel`` [cin, 256], ``pool_bias``), and quantizes its ReLU by
    ``inv_s_cat``, broadcast to every pixel. ``project`` maps the concat
    to 256; the dropout is left out. On a strip of the width the atrous
    branches share one int8 exchange at the widest halo their live taps
    read, and the int32 sums are all-reduced over the model group."""

    def __init__(self, in_channels: int, rates: Sequence[int] = ASPP_RATES):
        super().__init__()
        c = ASPP_CHANNELS
        self.b0 = QConv(in_channels, c)
        self.rates = tuple(rates)
        for i, rate in enumerate(self.rates):
            self.add_module(f"b{i + 1}", QConv(in_channels, c, 3, 1, rate))
        self.register_buffer("pool_kernel", torch.zeros(in_channels, c))
        self.register_buffer("pool_bias", torch.zeros(c))
        self.register_buffer("s_in", torch.ones(()))
        self.register_buffer("inv_s_cat", torch.ones(()))
        self.project = QConv(c * (len(self.rates) + 2), c)

    def pooled(self, x_q: torch.Tensor,
               valid_h: torch.Tensor | None = None,
               width: World | None = None) -> torch.Tensor:
        """The pooled branch of a masked int8 map (or of the strips of the
        model group ``width``): int8 [B, 256] at s_cat."""
        sums = x_q.sum(dim=(1, 2), dtype=torch.int32)
        full_w = x_q.shape[2]
        if is_split(width):
            sums = all_reduce_int32(sums, width)
            full_w *= width.size
        denom = (float(x_q.shape[1] * full_w) if valid_h is None
                 else (valid_h.float() * full_w)[:, None])
        pooled = sums.float() * self.s_in / denom
        pooled = pooled @ self.pool_kernel + self.pool_bias
        return quantize_act(F.relu(pooled), self.inv_s_cat)

    def forward(self, x_q: torch.Tensor,
                valid_h: torch.Tensor | None = None,
                width: World | None = None) -> torch.Tensor:
        """``width``: the model group that splits the width, or None."""
        x_q = mask_rows(x_q, valid_h)  # the atrous branches mix rows
        atrous = [getattr(self, f"b{i + 1}") for i in range(len(self.rates))]
        branches = [self.b0.relu(x_q)]
        if is_split(width):
            w = x_q.shape[2]
            full = w * width.size
            reach = max(max(conv.halo(full)) for conv in atrous)
            wide = (exchange_halo_nhwc(x_q, reach, reach, width) if reach
                    else x_q)
            for conv in atrous:
                left, right = conv.halo(full)
                branches.append(conv.relu(
                    wide[:, :, reach - left:reach + w + right], full))
        else:
            branches += [conv.relu(x_q) for conv in atrous]
        pooled_q = self.pooled(x_q, valid_h, width)
        branches.append(pooled_q[:, None, None, :].expand(
            *x_q.shape[:3], pooled_q.shape[1]))
        return self.project.relu(torch.cat(branches, dim=-1))


class QuantizedDeepLabHead(nn.Module):
    """The int8 DeepLabV3 head (JAX ``DeepLabHead._quantized_forward``):
    the int8 ASPP, the row mask, the 3x3 ``conv`` and the 1x1
    ``classifier`` -> float32 NHWC logits."""

    supports_width = True  # int8 halos and an all-reduced pooled sum

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        c = ASPP_CHANNELS
        self.aspp = QuantizedASPP(in_channels)
        self.conv = QConv(c, c, 3)
        self.classifier = QConv(c, channels)

    def forward(self, x_q: torch.Tensor,
                valid_h: torch.Tensor | None = None,
                width: World | None = None) -> torch.Tensor:
        """``width``: the model group that splits the width, or None."""
        x = mask_rows(self.aspp(x_q, valid_h, width), valid_h)
        return self.classifier.dequant(self.conv.relu(
            *widen(self.conv, x, width)))


__all__ = ["ASPP", "ASPPPooling", "AtrousConv2d", "DeepLabHead", "FCNHead",
           "QuantizedASPP", "QuantizedDeepLabHead", "QuantizedFCNHead"]
