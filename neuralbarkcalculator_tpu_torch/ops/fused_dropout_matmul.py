"""Fused dropout + 1x1 conv, forward and backward: the CUDA kernels and
their plain version.

``fused_dropout_matmul(h, w, b, seed, rate, offset)`` computes the FCN head's
``Dropout(rate) -> Conv2d(C, K, 1)`` on NCHW float32 activations ``h [B,
C, H, W]`` with ``w [C, K]`` and ``b [K]``, giving ``y [B, K, H, W]``. It
replaces the Pallas TPU kernel
``neuralbarkcalculator_tpu/ops/pallas_kernels.py::fused_dropout_matmul``
(which takes NHWC ``[B, Hf, Wf, C]``; the port reads the layout its head
produces). Gradients flow to ``h``, ``w`` and ``b``. Like the JAX custom
VJP, the autograd function saves ``h``, ``w`` and the seed, and no mask:
the backward regenerates it.

The mask: element ``i`` of ``h`` (its linear NCHW index) takes word
``(offset + i) & 3`` of Philox4x32-10 at counter ``(offset + i) >> 2``
under the 64-bit key ``seed``, and is kept, scaled by ``1/keep``, iff
those 32 bits are below ``keep_threshold(rate)``. The element offset, a
multiple of 4 (0 by default), places ``h`` inside a larger tensor: a
data-parallel rank whose rows start at row ``r`` of the global batch
passes ``r * C * H * W`` and draws exactly those rows of the global
batch's mask, as a sharded flax dropout does. The threshold is the Pallas kernel's
``min(int(keep * 2**32), 2**32 - 1)``, except that rate 0 keeps every
element (the exact identity, as ``nn.Dropout(0)`` is). The plain version
computes the same bits with int64 torch ops, so the kernel can be held
against it bit for bit.

- On CUDA tensors the wrapper launches the hand-written kernels
  (``csrc/fused_dropout_matmul.cu``, built at first use) or raises: the
  forward is one kernel that writes ``y``; the backward one kernel that
  writes ``dh`` and per-block ``dw`` / ``db`` partials and a small one
  that sums them in order. The wrapper only allocates; it launches no
  torch kernel.
- On CPU tensors it runs the plain version. That is the only case the plain
  version serves.

``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count the op's launches (one per
call, whatever the library runs inside it), so a run can show that its
main path went through them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .kernels import LaunchCounter, check_launch, kernel_lib

FWD_LAUNCHES = LaunchCounter()
BWD_LAUNCHES = LaunchCounter()

# Philox4x32-10 constants (Random123)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """Keep an element iff its 32 random bits are below this (2**32 at
    rate 0 keeps all)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    if rate == 0.0:
        return 2 ** 32
    return min(int((1.0 - rate) * 2 ** 32), 2 ** 32 - 1)


def keep_scale(rate: float) -> float:
    """1/keep rounded to float32, the value a kept element is scaled by."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"dropout seed must lie in [0, 2**64), got {seed}")
    return seed


def _check_offset(offset: int) -> int:
    offset = int(offset)
    if not 0 <= offset < 2 ** 62 or offset % 4:
        raise ValueError(f"dropout element offset must be a multiple of 4 "
                         f"in [0, 2**62), got {offset}")
    return offset


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of a * m for int64 tensors a < 2**32 and a
    32-bit constant m, from 16-bit halves so no product overflows int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    mid = a_lo * m_hi + a_hi * m_lo                 # < 2**33
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)      # < 2**33
    hi = (a_hi * m_hi + (mid >> 16) + (low >> 32)) & _MASK32
    return hi, low & _MASK32


def philox4x32_10(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 of 64-bit counters (int64 tensor, counter words 2 and
    3 zero) under the 64-bit key ``seed``: [n] -> [n, 4] int64 holding
    uint32 values."""
    c0, c1 = counter & _MASK32, counter >> 32
    c2 = torch.zeros_like(counter)
    c3 = torch.zeros_like(counter)
    k0, k1 = seed & _MASK32, seed >> 32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def dropout_mask(shape, seed: int, rate: float, offset: int = 0,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """The float32 mask in {0, 1/keep} that the kernels apply to a tensor
    of ``shape`` (NCHW order of the linear index) at element ``offset``."""
    seed = _check_seed(seed)
    offset = _check_offset(offset)
    thresh = keep_threshold(rate)
    n = math.prod(shape)
    counters = torch.arange(offset // 4, offset // 4 + (n + 3) // 4,
                            dtype=torch.int64, device=device)
    bits = philox4x32_10(counters, seed).reshape(-1)[:n]
    scale = torch.tensor(keep_scale(rate), dtype=torch.float32,
                         device=device)
    return torch.where(bits < thresh, scale,
                       torch.zeros((), dtype=torch.float32, device=device)
                       ).reshape(shape)


def fused_dropout_matmul_plain(h: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor, seed: int, rate: float,
                               offset: int = 0) -> torch.Tensor:
    """The forward as plain torch ops: materialize the mask, then the 1x1
    conv as an einsum (run with TF32 off on a card)."""
    hm = h * dropout_mask(h.shape, seed, rate, offset, h.device)
    return torch.einsum("bchw,ck->bkhw", hm, w) + b.view(1, -1, 1, 1)


def fused_dropout_matmul_backward_plain(
        h: torch.Tensor, w: torch.Tensor, g: torch.Tensor, seed: int,
        rate: float, offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh, dw, db) for the upstream gradient g [B, K, H, W], as plain
    torch ops on a regenerated mask."""
    m = dropout_mask(h.shape, seed, rate, offset, h.device)
    dh = torch.einsum("bkhw,ck->bchw", g, w) * m
    dw = torch.einsum("bchw,bkhw->ck", h * m, g)
    return dh, dw, g.sum(dim=(0, 2, 3))


def _check(h: torch.Tensor, w: torch.Tensor, other: torch.Tensor,
           other_shape: tuple[int, ...], other_name: str) -> None:
    for name, t in (("h", h), ("w", w), (other_name, other)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_dropout_matmul: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != h.device:
            raise ValueError(f"fused_dropout_matmul: {name} is on "
                             f"{t.device}, h on {h.device}")
    if h.dim() != 4:
        raise ValueError(f"fused_dropout_matmul: h must be [B, C, H, W], "
                         f"got {tuple(h.shape)}")
    if not h.is_contiguous():
        raise ValueError("fused_dropout_matmul: h must be contiguous NCHW")
    if w.dim() != 2 or w.shape[0] != h.shape[1]:
        raise ValueError(f"fused_dropout_matmul: w must be [{h.shape[1]}, "
                         f"K], got {tuple(w.shape)}")
    if tuple(other.shape) != other_shape:
        raise ValueError(f"fused_dropout_matmul: {other_name} must be "
                         f"{list(other_shape)}, got {tuple(other.shape)}")


def _check_aligned(**tensors: torch.Tensor) -> None:
    """The kernels read their inputs as float4: 16-byte aligned pointers."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"fused_dropout_matmul: {name} must be 16-byte "
                             f"aligned")


def _kernel_args(h: torch.Tensor, w: torch.Tensor, seed: int, rate: float,
                 offset: int = 0):
    """Shape checks of the kernels, and their common arguments."""
    bsz, c, hh, ww = h.shape
    p, k = hh * ww, w.shape[1]
    if p % 4:
        raise ValueError(f"fused_dropout_matmul: the kernels take H*W % 4 == "
                         f"0, got {hh}x{ww}")
    if k < 1:
        raise ValueError("fused_dropout_matmul: the kernels take at least "
                         "1 output channel, got 0")
    lib = kernel_lib("fused_dropout_matmul")
    if k > lib.fdm_max_classes():
        raise ValueError(f"fused_dropout_matmul: the kernels take 1 to "
                         f"{lib.fdm_max_classes()} output channels, got {k}")
    return lib, (bsz, c, p, k, _check_seed(seed), _check_offset(offset),
                 keep_threshold(rate), keep_scale(rate))


def fused_dropout_matmul_forward(h: torch.Tensor, w: torch.Tensor,
                                 b: torch.Tensor, seed: int, rate: float,
                                 offset: int = 0) -> torch.Tensor:
    """y [B, K, H, W] (no autograd): the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check(h, w, b, (w.shape[1],), "b")
    if h.device.type == "cpu":
        return fused_dropout_matmul_plain(h, w, b, seed, rate, offset)
    if h.device.type != "cuda":
        raise ValueError(f"fused_dropout_matmul: no kernel for device "
                         f"{h.device}")
    _check_aligned(h=h)
    lib, (bsz, c, p, k, seed, offset, thresh, scale) = _kernel_args(
        h, w, seed, rate, offset)
    b = b.contiguous()
    y = torch.empty((bsz, k, h.shape[2], h.shape[3]), dtype=torch.float32,
                    device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.fdm_forward_launch(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, c,
            p, k, *w.stride(), seed, offset, thresh, scale, stream)
    check_launch("fused_dropout_matmul forward", rc)
    FWD_LAUNCHES.add()
    return y


def fused_dropout_matmul_backward(
        h: torch.Tensor, w: torch.Tensor, g: torch.Tensor, seed: int,
        rate: float, offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh, dw, db) for g [B, K, H, W]: the kernels on CUDA tensors (the
    library sums the per-block dw and db partials itself, in order), the
    plain version on CPU tensors."""
    bsz, _, hh, ww = h.shape
    g = g.contiguous()
    _check(h, w, g, (bsz, w.shape[1], hh, ww), "g")
    if h.device.type == "cpu":
        return fused_dropout_matmul_backward_plain(h, w, g, seed, rate,
                                                   offset)
    if h.device.type != "cuda":
        raise ValueError(f"fused_dropout_matmul: no kernel for device "
                         f"{h.device}")
    _check_aligned(h=h, g=g)
    lib, (bsz, c, p, k, seed, offset, thresh, scale) = _kernel_args(
        h, w, seed, rate, offset)
    dh = torch.empty_like(h)
    dw = torch.empty((c, k), dtype=torch.float32, device=h.device)
    db = torch.empty(k, dtype=torch.float32, device=h.device)
    rows = lib.fdm_partial_rows(bsz, p)
    dw_part = torch.empty((rows, c, k), dtype=torch.float32, device=h.device)
    db_part = torch.empty((rows, k), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.fdm_backward_launch(
            h.data_ptr(), w.data_ptr(), g.data_ptr(), dh.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), dw.data_ptr(),
            db.data_ptr(), bsz, c, p, k, *w.stride(), seed, offset, thresh,
            scale, stream)
    check_launch("fused_dropout_matmul backward", rc)
    BWD_LAUNCHES.add()
    return dh, dw, db


class _FusedDropoutMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, seed, rate, offset):
        ctx.save_for_backward(h, w)
        ctx.seed, ctx.rate, ctx.offset = seed, rate, offset
        return fused_dropout_matmul_forward(h, w, b, seed, rate, offset)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh, dw, db = fused_dropout_matmul_backward(h, w, g, ctx.seed,
                                                   ctx.rate, ctx.offset)
        return dh, dw, db, None, None, None


def fused_dropout_matmul(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         seed: int, rate: float, offset: int = 0
                         ) -> torch.Tensor:
    """y = dropout(h, rate) 1x1-conv w + b, differentiable in h, w and b.

    h: [B, C, H, W] float32 contiguous (the head's post-ReLU activations);
    w: [C, K]; b: [K]; seed: the step's dropout seed, 0 <= seed < 2**64;
    rate: in [0, 1); offset: the mask's element offset, a multiple of 4
    (``h``'s first element in the global batch). Returns [B, K, H, W]
    float32.
    """
    return _FusedDropoutMatmul.apply(h, w, b, _check_seed(seed), rate,
                                     _check_offset(offset))
