"""Width partitioning: the halo exchanges that GSPMD inserts for the JAX
mesh's ``model`` axis (JAX parallel/mesh.py ``ShardingRules.image_batch``,
``P("data", None, "model", None)``; docs/SCALING.md), made explicit for
the port's convolutions.

A model group of n ranks splits the image width into n equal strips, rank
m owning the global columns [m w, (m + 1) w). An op of kernel k, stride
s, dilation d and padding p, on a strip whose global input columns [a, b)
are multiples of s, owns the outputs [a/s, b/s) and reads the input
columns [a - p, b - s + d(k - 1) - p + 1): a left halo of p columns and a
right halo of d(k - 1) - p - s + 1 (``halo``). ``exchange_halo`` fetches
them from the neighbours, with zeros past the image's outer edges (the
op's own zero padding), and the op runs on the widened strip with width
padding 0 and its height padding as before, so the rank gets exactly its
columns of the full-width op. For the dilated ResNet and the heads, in
float and in int8 (models/qops.py):

| Op | Left | Right |
| --- | --- | --- |
| stem 7x7/2 | 3 | 2 (``STEM_HALO``, taken from the input) |
| max pool 3x3/2 | 1 | 0 |
| layer2's strided 3x3/2 | 1 | 0 |
| 3x3 at dilation 1 / 2 / 4 | 1 / 2 / 4 | 1 / 2 / 4 |
| FCN head 3x3, DeepLab head 3x3 | 1 | 1 |
| ASPP atrous 3x3 at rate 12 / 24 / 36 | 36 | 36 (one exchange, sliced) |
| 1x1 convs, the strided 1x1 downsample too | 0 | 0 |
| EfficientNet stem 3x3/2 SAME | 0 | 1 (its ``stem_halo``, from the input) |
| SAME 3x3/1 / 5x5/1 (depthwise) | 1 / 2 | 1 / 2 |
| SAME 3x3/2 / 5x5/2 (depthwise) | 0 / 1 | 1 / 2 |

An ASPP branch whose rate is at least the map's height and full width
reads only its centre tap (models/heads.py) and takes no halo. A TF-SAME
conv (models/efficientnet.py) of kernel k and stride s on a width that s
divides pads (k - s) // 2 columns before and the rest after, so its halo
is ``same_halo(k, s)`` = ``halo(k, s, 1, (k - s) // 2)``, the SAME
padding of the full width: EfficientNet's strips are multiples of its
feature stride 32, so every stage's full width and strips divide by its
strides.

The max pool's zeros at the outer edges equal its -inf padding because
its input is post-ReLU (models/resnet.py relies on the same for rows).
The stem's halo comes with the input: every rank reads the whole image,
so the engine uploads the rank's columns with the backbone's
``stem_halo`` more (3 + 2 for the ResNets' 7x7/2, 0 + 1 for
EfficientNet's 3x3/2; ``stem_columns``) and the zeros at the image's
edges (``stem_edge_pads``) are added after normalization.

A strip's width must be a multiple of the backbone's ``strip_multiple``
(8 for the dilated ResNets, the stride before layer3; 32 for
EfficientNet, its feature stride), so that each strided op's strip
starts on a multiple of its stride; it raises ``ValueError`` otherwise. A
backbone without one (SegFormer, whose attention is global) is refused by
``check_width_split``.

The exchange is one ``all_gather`` over the model group of each rank's
two edge strips, made contiguous first (a channels_last tensor's column
slice is a view): its first ``min(right, w)`` columns and its last
``min(left, w)``. A halo wider than the neighbour's strip (DeepLab's ASPP
at rate 36 on strips of 32 feature columns) is stitched from as many
ranks as it spans, with zeros past the image's outer edges.
``EXCHANGES`` counts the exchanges a process made and the halo bytes it
received from other ranks (not the zeros). ``exchange_halo_nhwc`` is the
same exchange on an NHWC strip (the int8 path's, models/qops.py).

Two reductions over the model group take the whole width and do not
depend on the split: ``sum_width_f32``, the float32 sum over rows and
columns as the column sums over the rows (added pairwise, each column on
its own), gathered to the full width and summed over it in one order
(DeepLab's pooled branch takes the same sum on one process, so its
split is bit-equal to it; EfficientNet's squeeze-excite takes it on a
strip only and keeps the plain mean on one process); and ``all_reduce_int32``, an integer sum, exact in any
order. ``REDUCTIONS`` counts them and the bytes of the full-width tensor
each reduces.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .distributed import World

# the dilated ResNets' stride before layer3 (their last strided op)
STRIP_MULTIPLE = 8


def halo(kernel: int, stride: int, dilation: int, padding: int
         ) -> tuple[int, int]:
    """(left, right) input columns an op reads beyond its strip."""
    return padding, dilation * (kernel - 1) - padding - stride + 1


def same_halo(kernel: int, stride: int) -> tuple[int, int]:
    """The halo of a TF-SAME conv on a width its stride divides: the
    full width's SAME padding, (k - s) // 2 before and the rest after."""
    return halo(kernel, stride, 1, (kernel - stride) // 2)


STEM_HALO = halo(7, 2, 1, 3)  # (3, 2), the ResNets' 7x7/2 stem


class ExchangeCounter:
    """A thread-safe count of collectives and of their bytes."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.bytes = 0

    def add(self, nbytes: int) -> None:
        with self._lock:
            self.count += 1
            self.bytes += nbytes

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.bytes = 0


EXCHANGES = ExchangeCounter()
# the reductions over the model group, and the bytes of the full-width
# tensor each reduced
REDUCTIONS = ExchangeCounter()


def is_split(model: World | None) -> bool:
    """Whether ``model`` splits the width (a group of more than one)."""
    return model is not None and model.size > 1


def check_width_split(backbone) -> None:
    """Raise for a backbone whose width cannot be split (``strip_multiple``
    None: SegFormer, whose attention is global, so a strip's queries need
    every column's keys)."""
    if getattr(backbone, "strip_multiple", None) is None:
        raise ValueError(
            f"{type(backbone).__name__} cannot run on strips of the width "
            f"(global attention over a strip is not the model)")


def strip_range(width: int, model: World, multiple: int
                ) -> tuple[int, int]:
    """The global columns [start, stop) of this rank's strip of an image
    ``width`` wide; each strip must be a multiple of ``multiple`` columns
    (the backbone's ``strip_multiple``)."""
    strip = width // model.size
    if width % model.size or strip % multiple:
        raise ValueError(
            f"width {width} over {model.size} ranks: each strip must be a "
            f"multiple of {multiple} columns (the backbone's "
            f"strip_multiple, the stride of its last strided op)")
    return model.rank * strip, (model.rank + 1) * strip


def stem_edge_pads(model: World, stem_halo: tuple[int, int]
                   ) -> tuple[int, int]:
    """The stem's zero columns past the image's outer edges: on the left
    of the first strip, on the right of the last. ``stem_halo``: the
    backbone's."""
    left, right = stem_halo
    return (left if model.rank == 0 else 0,
            right if model.rank == model.size - 1 else 0)


def stem_columns(width: int, model: World, stem_halo: tuple[int, int],
                 multiple: int) -> slice:
    """The image columns this rank's stem reads: its strip and the stem's
    halo (the backbone's ``stem_halo``; its strips multiples of
    ``multiple``), clipped to the image (``stem_edge_pads`` adds the
    rest)."""
    start, stop = strip_range(width, model, multiple)
    return slice(max(start - stem_halo[0], 0),
                 min(stop + stem_halo[1], width))


def _layout(x: torch.Tensor) -> torch.memory_format:
    if x.is_contiguous():
        return torch.contiguous_format
    if x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def exchange_halo(x: torch.Tensor, left: int, right: int, model: World
                  ) -> torch.Tensor:
    """NCHW strip [B, C, H, w] -> [B, C, H, left + w + right]: the strip
    widened by the columns of the ranks beside it, as many ranks as the
    halo spans, zeros past the image's outer edges, in ``x``'s memory
    layout."""
    w = x.shape[3]
    lo_w, hi_w = min(left, w), min(right, w)
    edges = torch.cat([x[..., :hi_w], x[..., w - lo_w:]], dim=3).contiguous()
    parts = [torch.empty_like(edges) for _ in range(model.size)]
    dist.all_gather(parts, edges, group=model.group)
    m, n = model.rank, model.size
    # the left halo, global columns [m w - left, m w): zeros before column
    # 0, then the last columns of ranks first // w ... m - 1
    first = max(m * w - left, 0)
    pieces = [x.new_zeros((*x.shape[:3], first - (m * w - left)))]
    for j in range(first // w, m):
        take = (j + 1) * w - max(first, j * w)  # <= min(left, w)
        pieces.append(parts[j][..., hi_w + lo_w - take:])
    pieces.append(x)
    # the right halo, global columns [(m + 1) w, (m + 1) w + right): the
    # first columns of ranks m + 1 ..., then zeros past column n w
    stop = min((m + 1) * w + right, n * w)
    for j in range(m + 1, -(-stop // w)):
        pieces.append(parts[j][..., :min(stop, (j + 1) * w) - j * w])
    pieces.append(x.new_zeros((*x.shape[:3], (m + 1) * w + right - stop)))
    received = (m * w - first) + (stop - (m + 1) * w)  # columns
    EXCHANGES.add(received * x[..., :1].numel() * x.element_size())
    return torch.cat(pieces, dim=3).contiguous(memory_format=_layout(x))


def exchange_halo_nhwc(x: torch.Tensor, left: int, right: int,
                       model: World) -> torch.Tensor:
    """``exchange_halo`` of an NHWC strip [B, h, w, C] (viewed as
    channels_last NCHW, so the exchange keeps its layout): the widened
    strip, contiguous NHWC."""
    return exchange_halo(x.permute(0, 3, 1, 2), left, right,
                         model).permute(0, 2, 3, 1)


def conv2d_rows(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` with its height padding only: on a strip that already
    carries its halo."""
    return F.conv2d(x, conv.weight, conv.bias, conv.stride,
                    (conv.padding[0], 0), conv.dilation)


def conv2d_w(conv: nn.Conv2d, x: torch.Tensor, model: World | None
             ) -> torch.Tensor:
    """``conv(x)`` on this rank's strip of the width: exactly its columns
    of the full-width conv. Without a split, ``conv(x)``."""
    if not is_split(model):
        return conv(x)
    stride = conv.stride[1]
    if x.shape[3] % stride:
        raise ValueError(f"a strip of {x.shape[3]} columns is no multiple "
                         f"of the conv's stride {stride}")
    left, right = halo(conv.kernel_size[1], stride, conv.dilation[1],
                       conv.padding[1])
    return conv2d_rows(conv, exchange_halo(x, left, right, model))


def max_pool2d_w(x: torch.Tensor, model: World | None) -> torch.Tensor:
    """The backbone's 3x3/2 max pool (padding 1) of a post-ReLU strip:
    exactly this rank's columns of the full-width pool."""
    if not is_split(model):
        return F.max_pool2d(x, 3, stride=2, padding=1)
    if x.shape[3] % 2:
        raise ValueError(f"a strip of {x.shape[3]} columns is no multiple "
                         f"of the pool's stride 2")
    return F.max_pool2d(exchange_halo(x, *halo(3, 2, 1, 1), model), 3,
                        stride=2, padding=(1, 0))


def gather_width(x: torch.Tensor, model: World, dim: int = -1
                 ) -> torch.Tensor:
    """Every rank's strip, concatenated along the width ``dim`` (equal
    shapes on every rank; NCHW's last by default): the full-width tensor,
    contiguous."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(model.size)]
    dist.all_gather(parts, x, group=model.group)
    return torch.cat(parts, dim=dim)


def _sum_rows_f32(x: torch.Tensor) -> torch.Tensor:
    """NCHW [B, C, H, w] -> the float32 column sums [B, C, w], the rows
    added pairwise in one order whatever the width (row r and row r + H/2,
    halving; an odd row left over joins the next round). Each column is
    its own chain of elementwise adds, so a strip's sums are the full
    map's columns bit for bit; a reduction's order (``x.sum(2)``) depends
    on the width on the CPU."""
    x = x.to(torch.float32)
    while x.shape[2] > 1:
        half = x.shape[2] // 2
        y = x[:, :, :half] + x[:, :, half:2 * half]
        x = y if x.shape[2] % 2 == 0 else torch.cat(
            [y, x[:, :, 2 * half:]], dim=2)
    return x[:, :, 0]


def sum_width_f32(x: torch.Tensor, model: World | None) -> torch.Tensor:
    """The float32 sum of an NCHW map over its rows and columns, [B, C]:
    the column sums over the rows (``_sum_rows_f32``), [B, C, W], summed
    over the full width in one order. On a strip the column sums are
    gathered from the model group first, so the split's sum is the one
    process's bit for bit."""
    cols = _sum_rows_f32(x)
    if is_split(model):
        cols = gather_width(cols, model)
        REDUCTIONS.add(cols.numel() * cols.element_size())
    return cols.contiguous().sum(-1)


def all_reduce_int32(x: torch.Tensor, model: World) -> torch.Tensor:
    """``x`` (int32) summed over the model group, in place: an integer
    sum, exact in any order."""
    dist.all_reduce(x, group=model.group)
    REDUCTIONS.add(x.numel() * x.element_size())
    return x


__all__ = ["EXCHANGES", "REDUCTIONS", "STEM_HALO", "STRIP_MULTIPLE",
           "check_width_split",
           "all_reduce_int32", "conv2d_rows", "conv2d_w", "exchange_halo",
           "exchange_halo_nhwc", "gather_width", "halo", "is_split",
           "max_pool2d_w", "same_halo", "stem_columns", "stem_edge_pads",
           "strip_range", "sum_width_f32"]
