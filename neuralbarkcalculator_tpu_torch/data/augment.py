"""Paired augmentation: host-side pad_resize, device-side random pipeline.

The reference training transform (__main__.py:155-166) is, per sample:
pad_resize(1024) -> ColorJitter(saturation=0.2, brightness=0.1) ->
RandomCrop(crop) -> RandomHorizontalFlip -> RandomVerticalFlip, applied to
sample and target with a shared seed (dataset.py:176-183), plus Normalize
on the input only.

- ``pad_resize`` is deterministic and runs once on the host when the
  dataset loads (reference utils.py:242-247: numpy reflect pad, then PIL's
  antialiased bilinear resize, reproduced exactly as a linear operator).
- The random part runs on the device on a batch gathered from the
  device-resident uint8 dataset. All draws come from one explicit
  ``torch.Generator`` (``draw_augment_params``); the functions that apply
  them are deterministic. Each crop window is gathered straight out of the
  uint8 dataset with its flips folded into the gather's indices; the
  colour jitter, pointwise, runs after the crop, which gives the same
  values as before it (JAX ``gather_augment_batch``, augment.py:166-209).
  Jitter applies to the image only: on {0, 127, 255} duals a 0.9-1.1
  brightness factor never moves a value across the class-decode rounding.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


# ---------------------------------------------------------------- host side

@functools.lru_cache(maxsize=32)
def pil_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """PIL Image.resize(BILINEAR) as a 1-D linear operator (antialiased
    triangle filter, the PIL>=2.7 convolution resampler torchvision 0.3's
    Resize delegates to)."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    R = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        js = np.arange(xmin, xmax)
        w = 1.0 - np.abs((js + 0.5 - center) / support)
        w = np.clip(w, 0.0, None)
        s = w.sum()
        if s > 0:
            R[i, xmin:xmax] = w / s
    return R


def pad_resize(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Reference utils.py:242-247: reflect-pad by ceil((target-size)/2) on
    each side, then PIL-bilinear resize to (height, width).

    image: [H, W, C] or [H, W] float.
    """
    ph = math.ceil((height - image.shape[0]) / 2)
    pw = math.ceil((width - image.shape[1]) / 2)
    pad_spec = [(ph, ph), (pw, pw)] + [(0, 0)] * (image.ndim - 2)
    if ph or pw:
        image = np.pad(image, pad_spec, mode="reflect")
    if image.shape[:2] == (height, width):
        return image
    rr = pil_bilinear_matrix(image.shape[0], height)
    rc = pil_bilinear_matrix(image.shape[1], width)
    out = np.tensordot(rr, image, axes=(1, 0))
    out = np.moveaxis(np.tensordot(rc, out, axes=(1, 1)), 0, 1)
    return out.astype(image.dtype, copy=False)


def pad_resize_pair(sample: np.ndarray, target: np.ndarray,
                    size: int) -> tuple[np.ndarray, np.ndarray]:
    """Paired pad_resize for (float sample, int label); labels resize with
    the same operator then re-round to classes (nearest behavior for the
    near-identity scales this path sees)."""
    sample = pad_resize(sample, size, size)
    lab = pad_resize(target.astype(np.float32), size, size)
    return sample, np.rint(lab).astype(np.int32)


# -------------------------------------------------------------- device side

def draw_augment_params(n: int, height: int, width: int, crop: int,
                        brightness: float, saturation: float,
                        generator: torch.Generator) -> dict:
    """One batch's random draws, on the generator's device: crop offsets
    (uniform over the valid windows), jitter factors U[1-x, 1+x] (lower
    end clamped at 0, torchvision ColorJitter), the jitter order and the
    two flips (p = 0.5 each)."""
    dev = generator.device

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return torch.empty(n, device=dev).uniform_(lo, hi,
                                                   generator=generator)

    def coin() -> torch.Tensor:
        return torch.rand(n, device=dev, generator=generator) < 0.5

    return {
        "oy": torch.randint(0, height - crop + 1, (n,), device=dev,
                            generator=generator),
        "ox": torch.randint(0, width - crop + 1, (n,), device=dev,
                            generator=generator),
        "fb": uniform(max(0.0, 1 - brightness), 1 + brightness),
        "fs": uniform(max(0.0, 1 - saturation), 1 + saturation),
        "bright_first": coin(),
        "flip_h": coin(),
        "flip_v": coin(),
    }


def gather_crops(images: torch.Tensor, labels: torch.Tensor,
                 idx: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                 flip_h: torch.Tensor, flip_v: torch.Tensor, crop: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Crop windows of images [N, H, W, C] and labels [N, H, W] at
    (oy, ox) for the samples idx [B], each flipped horizontally and/or
    vertically within its window: one gather, no host sync."""
    ar = torch.arange(crop, device=images.device)
    rows = oy[:, None] + torch.where(flip_v[:, None], crop - 1 - ar, ar)
    cols = ox[:, None] + torch.where(flip_h[:, None], crop - 1 - ar, ar)
    sel = (idx[:, None, None], rows[:, :, None], cols[:, None, :])
    return images[sel], labels[sel]


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, the torchvision grayscale used by saturation."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b)[..., None]


def color_jitter(img: torch.Tensor, fb: torch.Tensor, fs: torch.Tensor,
                 bright_first: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter(brightness, saturation) on [B, H, W, 3]
    float images in [0, 1] with per-sample factors fb, fs [B]: brightness
    then saturation where bright_first, else the other order; each step
    clamps to [0, 1]."""
    fb = fb.view(-1, 1, 1, 1)
    fs = fs.view(-1, 1, 1, 1)

    def bright(x):
        return torch.clamp(x * fb, 0.0, 1.0)

    def sat(x):
        gray = _grayscale(x)
        return torch.clamp(gray + fs * (x - gray), 0.0, 1.0)

    return torch.where(bright_first.view(-1, 1, 1, 1), sat(bright(img)),
                       bright(sat(img)))


def gather_augment_batch(images_u8: torch.Tensor, labels_u8: torch.Tensor,
                         idx: torch.Tensor, crop: int, mean: torch.Tensor,
                         std: torch.Tensor, generator: torch.Generator,
                         brightness: float = 0.1, saturation: float = 0.2,
                         batch_rows: tuple[int, int] | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training batch for dataset rows idx [B] of the device-resident
    uint8 images [N, H, W, 3] and labels [N, H, W]: random crop + flips,
    colour jitter, Normalize. Returns (float32 [B, crop, crop, 3], int64
    labels [B, crop, crop]).

    ``batch_rows = (start, n_global)``: idx holds rows [start, start + B)
    of a global batch of n_global (a data-parallel rank's). The global
    batch's parameters are drawn, the same on every rank, and the rank
    keeps its rows of them, so each sample is augmented as in the
    single-process step (JAX ``gather_augment_batch`` draws per-sample
    keys from the global key and shape, augment.py:205)."""
    start, n_global = batch_rows or (0, idx.shape[0])
    p = draw_augment_params(n_global, images_u8.shape[1],
                            images_u8.shape[2], crop, brightness,
                            saturation, generator)
    if n_global != idx.shape[0]:
        p = {k: v[start:start + idx.shape[0]] for k, v in p.items()}
    img, lab = gather_crops(images_u8, labels_u8, idx, p["oy"], p["ox"],
                            p["flip_h"], p["flip_v"], crop)
    img = color_jitter(img.float() / 255.0, p["fb"], p["fs"],
                       p["bright_first"])
    return (img - mean) / std, lab.long()
