"""Structured synthetic bark-log images and their dual masks: a frozen
copy of ``neuralbarkcalculator_tpu_torch/tools/bench_data.py`` (the
benchmark keeps its own, so a change to the program cannot change the
traffic).

Masks use the dataset's classes {0: nothing, 1: bark, 2: node}: a
dominant blobby bark region spanning the image, dark background bands at
the top and bottom edges, small bright node islands inside the bark, and
sub-150-px speckles of every class for ``remove_small_zones`` to clean
up. Images colour the classes like real logs (dark background, brown
bark texture, lighter node wood). Pure numpy.
"""
from __future__ import annotations

import numpy as np


def _box(a: np.ndarray, k: int, axis: int) -> np.ndarray:
    """(2k+1)-wide box blur along ``axis`` via padded cumsum."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (k, k)
    ap = np.pad(a, pad, mode="edge")
    c = np.cumsum(ap, axis=axis, dtype=np.float64)
    zeros = list(c.shape)
    zeros[axis] = 1
    c = np.concatenate([np.zeros(zeros), c], axis=axis)
    n = a.shape[axis]
    hi = np.take(c, np.arange(n) + 2 * k + 1, axis=axis)
    lo = np.take(c, np.arange(n), axis=axis)
    return (hi - lo) / (2 * k + 1)


def _smooth_field(rng: np.random.Generator, h: int, w: int,
                  cell: int = 48) -> np.ndarray:
    """Low-frequency random field in roughly [-1, 1] (blobby contours)."""
    g = rng.standard_normal((h // cell + 2, w // cell + 2))
    up = np.kron(g, np.ones((cell, cell)))[:h, :w]
    k = cell // 2
    f = _box(_box(up, k, 0), k, 1)
    return f / max(np.abs(f).max(), 1e-9)


def structured_dual_mask(rng: np.random.Generator, h: int,
                         w: int) -> np.ndarray:
    """Class map {0,1,2} with real-dual-like component statistics."""
    mask = np.ones((h, w), np.uint8)

    # wavy background bands at the top and bottom (the trim leaves a thin
    # dark margin on real processed images)
    def wobble():
        v = _box(rng.standard_normal((1, w)), 40, 1)[0]
        v = v / max(np.abs(v).max(), 1e-9)
        return h * 0.06 * (1.2 + v)

    yy = np.arange(h)[:, None]
    mask[(yy < wobble()[None, :])] = 0
    mask[(yy > h - 1 - wobble()[None, :])] = 0

    # blobby background lakes inside the log (missing-bark patches)
    field = _smooth_field(rng, h, w)
    mask[(field > np.quantile(field, 0.88)) & (mask == 1)] = 0

    # node islands: elliptical, mostly > 150 px, a few below the threshold
    n_nodes = int(rng.integers(8, 16))
    xs = np.arange(w)[None, :]
    ys = np.arange(h)[:, None]
    for _ in range(n_nodes):
        cy = rng.uniform(0.15 * h, 0.85 * h)
        cx = rng.uniform(0.02 * w, 0.98 * w)
        ry = rng.uniform(4, 22)
        rx = ry * rng.uniform(0.8, 2.5)
        ell = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1.0
        mask[ell & (mask == 1)] = 2

    # sub-150-px speckles of every class: the postprocess work-load
    for cls in (0, 1, 2):
        for _ in range(int(rng.integers(10, 20))):
            cy = rng.uniform(0.1 * h, 0.9 * h)
            cx = rng.uniform(0, w)
            r = rng.uniform(1.5, 6.0)  # area <= ~113 < 150
            disc = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
            mask[disc] = cls
    return mask


# class base colors: dark background, brown bark, pale node wood
_COLORS = np.array([[24, 20, 16], [158, 112, 66], [214, 190, 150]],
                   np.float32)


def structured_image(rng: np.random.Generator,
                     mask: np.ndarray) -> np.ndarray:
    """RGB uint8 image whose texture follows the mask's classes."""
    h, w = mask.shape
    img = _COLORS[mask]
    # low-frequency illumination + per-pixel grain
    shade = 1.0 + 0.18 * _smooth_field(rng, h, w, cell=64)[..., None]
    grain = rng.normal(0.0, 14.0, size=(h, w, 1))
    img = img * shade + grain
    # bark gets horizontal fiber streaks (logs are unrolled horizontally)
    streaks = 22.0 * _box(rng.standard_normal((h, w)), 10, 1)
    img += (mask == 1)[..., None] * streaks[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)
