"""Separable resize operators: the preprocess's B-spline resize and the
bicubic upsample of the head logits.

Both are linear maps per axis, so each is a 1-D operator matrix built on
the host in float64 exactly as the JAX package builds it (the two packages
hold identical operators) and applied as two matrix products:

- the preprocessor's ``skimage.transform.resize(..., order=3,
  mode='reflect', anti_aliasing=False)`` (reference models.py:194-198):
  scipy's prefiltered cubic B-spline with the 'mirror' boundary, output
  pixel *i* sampled at input coordinate ``(i + 0.5) * in/out - 0.5``
  (``bspline_resize_matrix``, ``spline_resize``), and its host twin for
  a runtime without the native library (``spline_resize_host``: scipy's
  IIR prefilter and the 4 B-spline taps, in numpy);
- the model head's ``F.interpolate(mode='bicubic', align_corners=False)``
  (reference models.py:38-41): Keys cubic convolution with a = -0.75,
  half-pixel sampling, edge-clamped taps, no prefilter. Ragged batches
  carry one embedded row operator per image (``embedded_bicubic_rows``);
  the width operator is shared.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.linalg import solve_banded


def _mirror_index(idx: np.ndarray, n: int) -> np.ndarray:
    """scipy 'mirror' boundary: reflect about edge samples without repeating.

    Sequence for n=4: ... 2 1 | 0 1 2 3 | 2 1 0 1 ...  (period 2n-2).
    """
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _bspline3(u: np.ndarray) -> np.ndarray:
    """Cubic B-spline basis function beta^3(u)."""
    u = np.abs(u)
    out = np.zeros_like(u)
    m1 = u < 1
    out[m1] = (4.0 - 6.0 * u[m1] ** 2 + 3.0 * u[m1] ** 3) / 6.0
    m2 = (u >= 1) & (u < 2)
    out[m2] = (2.0 - u[m2]) ** 3 / 6.0
    return out


@functools.lru_cache(maxsize=32)
def bspline_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float64 operator: prefiltered cubic-B-spline
    resize, matching scipy.ndimage.map_coordinates(order=3, mode='mirror',
    prefilter=True) at coords ``(i + 0.5) * in/out - 0.5``. It is the
    interpolation matrix S (4 B-spline taps per row) times the inverse of
    the tridiagonal prefilter system B, from a banded solve. The cached
    array is shared; callers must not write to it."""
    n = in_size
    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5

    # Interpolation matrix S: 4 B-spline taps around floor(x).
    base = np.floor(x).astype(np.int64)
    S = np.zeros((out_size, n), dtype=np.float64)
    for k in range(-1, 3):
        idx = _mirror_index(base + k, n)
        w = _bspline3(x - (base + k))
        np.add.at(S, (np.arange(out_size), idx), w)

    if n == 1:
        return S  # single sample: coefficients equal samples

    # Prefilter system B c = f with mirror BC: f[j] = (c[j-1]+4c[j]+c[j+1])/6,
    # c[-1] -> c[1], c[n] -> c[n-2]. Tridiagonal; solve R = S @ B^{-1} via
    # B^T R^T = S^T using a banded solver.
    lower = np.full(n - 1, 1.0 / 6.0)
    upper = np.full(n - 1, 1.0 / 6.0)
    diag = np.full(n, 4.0 / 6.0)
    upper[0] = 2.0 / 6.0  # row 0: c[-1]=c[1] folds into the (0,1) entry
    lower[-1] = 2.0 / 6.0  # row n-1: c[n]=c[n-2] folds into (n-1,n-2)
    # Banded form of B^T: (1 sub, 1 super).
    ab = np.zeros((3, n), dtype=np.float64)
    ab[0, 1:] = lower  # superdiag of B^T = subdiag of B
    ab[1, :] = diag
    ab[2, :-1] = upper  # subdiag of B^T = superdiag of B
    Rt = solve_banded((1, 1), ab, S.T)
    return np.ascontiguousarray(Rt.T)


@functools.lru_cache(maxsize=8)
def _bspline_operator(in_size: int, out_size: int,
                      device: torch.device) -> torch.Tensor:
    """``bspline_resize_matrix`` as float32 on ``device``, uploaded once
    (16 MB for 4096 -> 1024)."""
    return torch.as_tensor(bspline_resize_matrix(in_size, out_size),
                           dtype=torch.float32, device=device)


def spline_resize(batch: torch.Tensor, out_h: int, out_w: int
                  ) -> torch.Tensor:
    """skimage-parity cubic resize of a float [B, H, W, 3] batch to [B,
    out_h, out_w, 3] float32, each image clipped to its own min and max
    (skimage's clip=True; the JAX package vmaps its resize, so its clip is
    per image).

    Two products in the JAX contraction order, rows then columns, in full
    float32: TF32 is turned off for them (process-wide, as the flag is; it
    is torch's default) and autocast does not reach them. The row product
    is one [out_h, H] x [H, W*3] product per image; the column product
    runs as one [B*out_h*3, W] x [W, out_w] product on the channel planes,
    copied contiguous first: on their strided view cuBLAS runs B*out_h
    products of 3 rows each, far from the card's rate (PERF.md).
    """
    if batch.ndim != 4 or batch.shape[-1] != 3:
        raise ValueError(f"expected [B, H, W, 3], got {tuple(batch.shape)}")
    b, h, w, c = batch.shape
    dev = batch.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    x = batch.float()
    with torch.autocast(dev.type, enabled=False):
        rows = _bspline_operator(h, out_h, dev)
        cols = _bspline_operator(w, out_w, dev)
        out = torch.matmul(rows, x.reshape(b, h, w * c))  # [B, oh, W*3]
        planes = out.view(b, out_h, w, c).permute(0, 1, 3, 2).contiguous()
        out = torch.matmul(planes, cols.t())  # [B, oh, 3, ow]
    out = out.permute(0, 1, 3, 2)
    lo = x.amin(dim=(1, 2, 3)).view(b, 1, 1, 1)
    hi = x.amax(dim=(1, 2, 3)).view(b, 1, 1, 1)
    return torch.clamp(out, lo, hi).contiguous()


def _bspline_taps(in_size: int,
                  out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Evaluation taps of the cubic B-spline resize: ([4, out] mirror
    indices, [4, out] float32 weights). Summing ``w_k * coef[idx_k]`` over
    k is ``S @ coef``, the interpolation half of bspline_resize_matrix."""
    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    base = np.floor(x).astype(np.int64)
    idxs, ws = [], []
    for k in range(-1, 3):
        idxs.append(_mirror_index(base + k, in_size))
        ws.append(_bspline3(x - (base + k)).astype(np.float32))
    return np.stack(idxs), np.stack(ws)


def spline_resize_host(img: np.ndarray, out_h: int,
                       out_w: int) -> np.ndarray:
    """The B-spline resize on the host, for a runtime without the native
    library (pipeline/preprocess.py): scipy's IIR spline prefilter along
    each axis, then the 4-tap B-spline evaluation, in float32 as the
    reference resizes its float32 image (models.py:192-198). The same
    function as ``spline_resize`` (S @ B^-1 per axis), summed in another
    order.

    img: [H, W, C] or [H, W] float; returns float32 clipped to the input's
    range (skimage's clip=True).
    """
    from scipy.ndimage import spline_filter1d

    img = np.ascontiguousarray(img, dtype=np.float32)
    lo, hi = float(img.min()), float(img.max())
    coef = spline_filter1d(img, order=3, axis=0, mode="mirror",
                           output=np.float32)
    coef = spline_filter1d(coef, order=3, axis=1, mode="mirror",
                           output=np.float32)
    trail = (1,) * (img.ndim - 1)
    ridx, rw = _bspline_taps(img.shape[0], out_h)
    out = rw[0].reshape(-1, *trail) * coef[ridx[0]]
    for k in range(1, 4):
        out += rw[k].reshape(-1, *trail) * coef[ridx[k]]
    cidx, cw = _bspline_taps(img.shape[1], out_w)
    trail = (1,) * (img.ndim - 2)
    out2 = cw[0].reshape(1, -1, *trail) * out[:, cidx[0]]
    for k in range(1, 4):
        out2 += cw[k].reshape(1, -1, *trail) * out[:, cidx[k]]
    return np.clip(out2, lo, hi)


def _keys_cubic(s: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel W(s) with parameter a."""
    s = np.abs(s)
    out = np.zeros_like(s)
    m1 = s <= 1
    out[m1] = (a + 2) * s[m1] ** 3 - (a + 3) * s[m1] ** 2 + 1
    m2 = (s > 1) & (s < 2)
    out[m2] = a * s[m2] ** 3 - 5 * a * s[m2] ** 2 + 8 * a * s[m2] - 4 * a
    return out


@functools.lru_cache(maxsize=32)
def bicubic_resize_matrix(in_size: int, out_size: int,
                          a: float = -0.75) -> np.ndarray:
    """[out_size, in_size] float64 operator for torch ``interpolate(
    mode='bicubic', align_corners=False)``: Keys cubic with a=-0.75,
    half-pixel mapping, taps clamped to the edge, no prefilter. The cached
    array is shared; callers must not write to it."""
    n = in_size
    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    base = np.floor(x).astype(np.int64)
    R = np.zeros((out_size, n), dtype=np.float64)
    for k in range(-1, 3):
        idx = np.clip(base + k, 0, n - 1)
        w = _keys_cubic(x - (base + k), a)
        np.add.at(R, (np.arange(out_size), idx), w)
    return R


def embedded_bicubic_rows(feat_h: int, out_h: int, pad_feat: int,
                          pad_out: int) -> np.ndarray:
    """The (feat_h -> out_h) bicubic row operator embedded top-left in a
    zero float32 [pad_out, pad_feat] matrix: zero columns make padded
    feature rows inert and zero rows make padded output rows zero, so one
    static-shape batched product serves mixed heights exactly."""
    if feat_h > pad_feat or out_h > pad_out:
        raise ValueError("embedded operator larger than its padding")
    out = np.zeros((pad_out, pad_feat), dtype=np.float32)
    out[:out_h, :feat_h] = bicubic_resize_matrix(feat_h, out_h)
    return out


def column_operator_t(in_w: int, out_w: int) -> np.ndarray:
    """The transposed width operator [in_w, out_w] float32, contiguous."""
    return np.ascontiguousarray(
        bicubic_resize_matrix(in_w, out_w).T).astype(np.float32)


def bicubic_upsample_ragged(x: torch.Tensor, row_ops: torch.Tensor,
                            out_w: int) -> torch.Tensor:
    """Per-image-row-operator bicubic upsample of NHWC feature maps, in
    float32 (the caller turns TF32 off on a card).

    x: [N, F, Wf, C]; row_ops: [N, OH, F] (from embedded_bicubic_rows);
    returns [N, OH, out_w, C] float32. The width uses the shared
    (Wf -> out_w) operator: the reference trims rows only.
    """
    r_cols = torch.as_tensor(
        bicubic_resize_matrix(x.shape[2], out_w).astype(np.float32),
        device=x.device)
    out = torch.einsum("nof,nfwc->nowc", row_ops.float(), x.float())
    return torch.einsum("pw,nowc->nopc", r_cols, out)
