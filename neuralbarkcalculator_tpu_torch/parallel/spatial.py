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
columns of the full-width op. For the dilated ResNet and the FCN head:

| Op | Left | Right |
| --- | --- | --- |
| stem 7x7/2 | 3 | 2 (``STEM_HALO``, taken from the input) |
| max pool 3x3/2 | 1 | 0 |
| layer2's strided 3x3/2 | 1 | 0 |
| 3x3 at dilation 1 / 2 / 4 | 1 / 2 / 4 | 1 / 2 / 4 |
| FCN head 3x3 | 1 | 1 |
| 1x1 convs, the strided 1x1 downsample too | 0 | 0 |

The max pool's zeros at the outer edges equal its -inf padding because
its input is post-ReLU (models/resnet.py relies on the same for rows).
The stem's halo comes with the input: every rank reads the whole image,
so the engine uploads the rank's columns with 3 + 2 more
(``stem_columns``) and the zeros at the image's edges
(``stem_edge_pads``) are added after normalization.

A strip's width must be a multiple of 8, the stride before layer3, so
that each strided op's strip starts on a multiple of its stride; and a
halo may not be wider than the neighbour's strip: layer4's dilation 4
needs 4 feature columns a rank, W / n >= 32. Both raise ``ValueError``.

The exchange is one ``all_gather`` over the model group of each rank's
two edge strips, made contiguous first (a channels_last tensor's column
slice is a view): every rank takes its left neighbour's last ``left``
columns and its right neighbour's first ``right``. ``EXCHANGES`` counts
the exchanges a process made and the halo bytes it received from its
neighbours.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .distributed import World

# the backbone's stride before layer3 (its last strided op)
STRIP_MULTIPLE = 8


def halo(kernel: int, stride: int, dilation: int, padding: int
         ) -> tuple[int, int]:
    """(left, right) input columns an op reads beyond its strip."""
    return padding, dilation * (kernel - 1) - padding - stride + 1


STEM_HALO = halo(7, 2, 1, 3)  # (3, 2)


class ExchangeCounter:
    """A thread-safe count of halo exchanges and of the halo bytes they
    received from other ranks."""

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


def is_split(model: World | None) -> bool:
    """Whether ``model`` splits the width (a group of more than one)."""
    return model is not None and model.size > 1


def strip_range(width: int, model: World) -> tuple[int, int]:
    """The global columns [start, stop) of this rank's strip of an image
    ``width`` wide."""
    strip = width // model.size
    if width % model.size or strip % STRIP_MULTIPLE:
        raise ValueError(
            f"width {width} over {model.size} ranks: each strip must be a "
            f"multiple of {STRIP_MULTIPLE} columns (the backbone's stride "
            f"before layer3)")
    return model.rank * strip, (model.rank + 1) * strip


def stem_edge_pads(model: World) -> tuple[int, int]:
    """The stem's zero columns past the image's outer edges: on the left
    of the first strip, on the right of the last."""
    left, right = STEM_HALO
    return (left if model.rank == 0 else 0,
            right if model.rank == model.size - 1 else 0)


def stem_columns(width: int, model: World) -> slice:
    """The image columns this rank's stem reads: its strip and the stem's
    halo, clipped to the image (``stem_edge_pads`` adds the rest)."""
    start, stop = strip_range(width, model)
    return slice(max(start - STEM_HALO[0], 0),
                 min(stop + STEM_HALO[1], width))


def _layout(x: torch.Tensor) -> torch.memory_format:
    if x.is_contiguous():
        return torch.contiguous_format
    if x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def exchange_halo(x: torch.Tensor, left: int, right: int, model: World
                  ) -> torch.Tensor:
    """NCHW strip [B, C, H, w] -> [B, C, H, left + w + right]: the strip
    widened by its neighbours' edge columns, zeros at the image's outer
    edges, in ``x``'s memory layout."""
    w = x.shape[3]
    if max(left, right) > w:
        raise ValueError(
            f"a halo of {max(left, right)} columns is wider than the "
            f"neighbour's strip of {w}: split the width over fewer ranks")
    edges = torch.cat([x[..., :right], x[..., w - left:]], dim=3).contiguous()
    parts = [torch.empty_like(edges) for _ in range(model.size)]
    dist.all_gather(parts, edges, group=model.group)
    m = model.rank
    received = 0
    if m > 0:
        lo = parts[m - 1][..., right:]
        received += lo.numel()
    else:
        lo = x.new_zeros((*x.shape[:3], left))
    if m < model.size - 1:
        hi = parts[m + 1][..., :right]
        received += hi.numel()
    else:
        hi = x.new_zeros((*x.shape[:3], right))
    EXCHANGES.add(received * x.element_size())
    return torch.cat([lo, x, hi], dim=3).contiguous(memory_format=_layout(x))


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


def gather_width(x: torch.Tensor, model: World) -> torch.Tensor:
    """Every rank's NCHW strip, concatenated along the width (equal shapes
    on every rank): the full-width tensor, contiguous."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(model.size)]
    dist.all_gather(parts, x, group=model.group)
    return torch.cat(parts, dim=3)


__all__ = ["EXCHANGES", "STEM_HALO", "STRIP_MULTIPLE", "conv2d_rows",
           "conv2d_w", "exchange_halo", "gather_width", "halo", "is_split",
           "max_pool2d_w", "stem_columns", "stem_edge_pads", "strip_range"]
