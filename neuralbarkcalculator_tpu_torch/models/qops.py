"""int8 inference primitives (post-training quantization), in PyTorch.

The scheme is the JAX package's (``neuralbarkcalculator_tpu/models/
qops.py``): symmetric per-output-channel weight scales, one static scale
per activation tensor, calibrated offline (models/quantize.py):

- weights:     W_q[..., c] = round(W[..., c] / s_w[c]) in [-127, 127];
- activations: x_q = round(x / s_x) clipped to [-127, 127];
- conv:        acc = conv(x_q, W_q), int8 x int8 -> int32, exact;
- epilogue:    y = acc * m + b with m[c] = s_x * s_w[c] / s_y and
  b[c] = bias[c] / s_y precomputed, then round (half to even, as
  ``jnp.round``), clip and cast to int8. ReLU is the clip's lower bound.

Activations are NHWC. A conv is one ``torch._int_mm`` (cuBLAS's int8
GEMM on the card): a 1x1 conv over the activation viewed as [pixels, C],
a k x k conv over an NHWC im2col whose taps run in (ky, kx, cin) order,
built from zero padding and strided slices (there is no int8
``F.unfold``). On a strip of the width (a mesh's model axis) the conv
takes the halo its live column taps read (``strip_halo``, ``widen``),
and the taps are those of the full map. Integer sums are exact in any
order, so the card, the CPU and the JAX package give the same int32
accumulators, and the epilogues, written as separate float32 operations
(no fused multiply-add; the int32 accumulator converts to float32 as the
multiply loads it), the same int8 tensors.

Weights are stored as ``[N, K]`` int8: the JAX package's HWIO kernel
flattened to [kh * kw * cin, cout], transposed, with N padded up to a
multiple of 8 by zero rows. ``torch._int_mm`` on the card needs K and N
multiples of 8 and more than 16 rows (``int8_mm``); handed a contiguous
[K, N] weight, cuBLAS refuses some shapes (CUBLAS_STATUS_NOT_SUPPORTED)
and runs the others several times slower than the transposed view of
an [N, K] one (seen on an H100 with torch 2.11).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.distributed import World
from ..parallel.spatial import exchange_halo_nhwc, is_split

# torch._int_mm on the card needs more than this many rows
_MIN_ROWS = 16


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K]`` int8 (contiguous) times ``w [N, K]`` int8, transposed
    -> int32 [M, N], exact. Fewer than 17 rows are padded with zero rows
    for cuBLAS and cut off again."""
    m = a.shape[0]
    if m <= _MIN_ROWS:
        a = torch.cat([a, a.new_zeros(2 * _MIN_ROWS - m, a.shape[1])])
    return torch._int_mm(a, w.t())[:m]


def _live_taps(n_in: int, n_out: int, k: int, stride: int, dilation: int,
               pad: int) -> list[int]:
    """The taps of one axis that read at least one input position (not
    only padding): tap t reads o * stride - pad + t * dilation for the
    outputs o."""
    return [t for t in range(k)
            if (n_out - 1) * stride - pad + t * dilation >= 0
            and t * dilation - pad < n_in]


def _col_taps(w: int, k: int, stride: int, dilation: int) -> list[int]:
    """The live column taps of a conv over a map ``w`` wide."""
    pad = dilation * (k // 2)
    wo = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    return _live_taps(w, wo, k, stride, dilation, pad)


def strip_halo(k: int, stride: int, dilation: int, full_width: int
               ) -> tuple[int, int]:
    """(left, right) columns a strip of a map ``full_width`` wide reads
    beyond itself for the live column taps of the full map
    (parallel/spatial.halo of those taps): (0, 0) when only the centre
    tap reads the map."""
    pad = dilation * (k // 2)
    cols = _col_taps(full_width, k, stride, dilation)
    return (max(pad - cols[0] * dilation, 0),
            max(cols[-1] * dilation - pad - stride + 1, 0))


def qconv(x_q: torch.Tensor, w_q: torch.Tensor, k: int = 1,
          stride: int = 1, dilation: int = 1,
          full_width: int | None = None) -> torch.Tensor:
    """int8 NHWC conv -> int32 accumulator ``[B, Ho, Wo, N]``, with the
    model's symmetric ``dilation * (k // 2)`` zero padding (JAX
    ``qops.qconv``). ``w_q`` is ``[N, k * k * cin]`` (module docstring).
    Taps that read only padding (a rate past the map: the ASPP's rates on
    a small map) are left out with their weight columns: the same sums.

    ``full_width``: ``x_q`` is a strip of a map that wide, widened by
    ``strip_halo`` (parallel/spatial.exchange_halo_nhwc); the width takes
    no padding and the column taps are the full map's, so the result is
    exactly the strip's columns of the full conv."""
    b, h, w, cin = x_q.shape
    n = w_q.shape[0]
    if w_q.shape[1] != k * k * cin:
        raise ValueError(f"qconv: weight {tuple(w_q.shape)} does not take "
                         f"a {k}x{k} conv over {cin} channels")
    pad = dilation * (k // 2)
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    rows = _live_taps(h, ho, k, stride, dilation, pad)
    if full_width is None:
        wpad = pad
        wo = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
        cols = _live_taps(w, wo, k, stride, dilation, pad)
    else:
        cols = _col_taps(full_width, k, stride, dilation)
        left, right = strip_halo(k, stride, dilation, full_width)
        wo = (w - left - right) // stride
        # tap c of output j reads the widened column j * stride + c *
        # dilation - pad + left: pad - left zero columns in front (read by
        # no live tap) keep the one-process indexing
        wpad = pad - left
    if len(rows) * len(cols) < k * k:
        w_q = w_q.view(n, k, k, cin)[:, rows][:, :, cols].reshape(n, -1)
    if len(rows) == len(cols) == 1:
        # one tap: a strided view of the input itself
        r0, c0 = rows[0] * dilation - pad, cols[0] * dilation - wpad
        a = x_q[:, r0:r0 + (ho - 1) * stride + 1:stride,
                c0:c0 + (wo - 1) * stride + 1:stride]
    else:
        xp = F.pad(x_q, (0, 0, wpad, wpad, pad, pad))
        a = torch.cat([xp[:, r * dilation:r * dilation + (ho - 1) * stride
                          + 1:stride,
                          c * dilation:c * dilation + (wo - 1) * stride
                          + 1:stride]
                       for r in rows for c in cols], dim=-1)
    return int8_mm(a.reshape(b * ho * wo, -1), w_q).view(b, ho, wo, n)


def requant_relu(acc: torch.Tensor, m: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """dequant + bias + ReLU + quantize to the next tensor's scale: int8
    in [0, 127]. ``m``, ``b`` carry s_in * s_w / s_next and bias /
    s_next."""
    y = acc * m  # the int32 converts to float32 as the multiply loads it
    y.add_(b)
    return y.round_().clamp_(0, 127).to(torch.int8)


def requant_signed(acc: torch.Tensor, m: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """``requant_relu`` without the ReLU (a symmetric clip): the
    downsample branch of a bottleneck, in the block output's scale."""
    y = acc * m
    y.add_(b)
    return y.round_().clamp_(-127, 127).to(torch.int8)


def dequant(acc: torch.Tensor, m: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Affine epilogue to float32: acc * m + b (two roundings, as JAX)."""
    return (acc * m).add_(b)


def quantize_act(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """A float tensor -> int8 at a static scale (``inv_scale`` = 1 / s),
    in float32 whatever ``x``'s dtype. Zeros stay zeros, so zero-padded
    ragged rows stay zero."""
    return torch.round(x.float() * inv_scale).clamp_(-127, 127).to(
        torch.int8)


def mask_rows(x_q: torch.Tensor, valid_h: torch.Tensor | None
              ) -> torch.Tensor:
    """Zero the rows >= valid_h of an NHWC tensor (a 0 / 1 multiply in its
    own dtype); no-op when valid_h is None."""
    if valid_h is None:
        return x_q
    rows = torch.arange(x_q.shape[1], device=x_q.device)
    keep = (rows[None, :] < valid_h[:, None]).to(x_q.dtype)
    return x_q * keep[:, :, None, None]


class QConv(nn.Module):
    """One int8 conv's parameters: ``q`` the [N, k * k * cin] int8 weight
    (N = cout padded to a multiple of 8), ``m`` and ``b`` the float32
    epilogue's multiplier and offset [cout]. ``full_width``: the input is
    a widened strip of a map that wide (``qconv``, ``widen``)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.cout, self.k, self.stride, self.dilation = (cout, k, stride,
                                                         dilation)
        self.register_buffer("q", torch.zeros(_pad8(cout), k * k * cin,
                                              dtype=torch.int8))
        self.register_buffer("m", torch.zeros(cout))
        self.register_buffer("b", torch.zeros(cout))

    def halo(self, full_width: int) -> tuple[int, int]:
        """The columns a strip of a map ``full_width`` wide reads beyond
        itself (``strip_halo``)."""
        return strip_halo(self.k, self.stride, self.dilation, full_width)

    def acc(self, x_q: torch.Tensor, full_width: int | None = None
            ) -> torch.Tensor:
        """The int32 accumulator of this conv over NHWC int8 ``x_q``."""
        acc = qconv(x_q, self.q, self.k, self.stride, self.dilation,
                    full_width)
        return acc if acc.shape[-1] == self.cout else acc[..., :self.cout]

    def relu(self, x_q: torch.Tensor, full_width: int | None = None
             ) -> torch.Tensor:
        return requant_relu(self.acc(x_q, full_width), self.m, self.b)

    def signed(self, x_q: torch.Tensor) -> torch.Tensor:
        return requant_signed(self.acc(x_q), self.m, self.b)

    def dequant(self, x_q: torch.Tensor, full_width: int | None = None
                ) -> torch.Tensor:
        return dequant(self.acc(x_q, full_width), self.m, self.b)


def widen(conv: QConv, x_q: torch.Tensor, width: World | None
          ) -> tuple[torch.Tensor, int | None]:
    """(input, full_width) of ``conv`` on this rank's NHWC strip ``x_q``
    when the model group ``width`` splits the map: the strip widened by
    the halo the conv reads (parallel/spatial.exchange_halo_nhwc) and the
    map's width; ``(x_q, None)`` without a split."""
    if not is_split(width):
        return x_q, None
    full = x_q.shape[2] * width.size
    left, right = conv.halo(full)
    if left or right:
        x_q = exchange_halo_nhwc(x_q, left, right, width)
    return x_q, full


__all__ = ["QConv", "dequant", "int8_mm", "mask_rows", "qconv",
           "quantize_act", "requant_relu", "requant_signed", "strip_halo",
           "widen"]
