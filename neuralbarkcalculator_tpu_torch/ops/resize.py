"""Bicubic resize operators for the upsample of the head logits.

The model head's ``F.interpolate(mode='bicubic', align_corners=False)``
(reference models.py:38-41) is a linear map per axis: Keys cubic
convolution with a = -0.75, half-pixel sampling, edge-clamped taps, no
prefilter. The 1-D operator matrices are built on the host in float64
exactly as the JAX package builds them, so the two packages hand their
kernels identical operators. Ragged batches carry one embedded row
operator per image (``embedded_bicubic_rows``); the width operator is
shared.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


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
