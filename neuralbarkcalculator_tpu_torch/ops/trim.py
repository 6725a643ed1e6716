"""Dark-band trimming (reference models.py:157-166).

The reference keeps rows from the first to the last row whose fraction of
"non-black" pixels (channel-sum > 1e-3) exceeds 0.85. Both are row
reductions, computed where the batch lies (on the card in the device
preprocess); the host does the ragged slice.
"""
from __future__ import annotations

import torch

from ..config import TRIM_PIXEL_THRESHOLD, TRIM_ROW_FRACTION


def trim_bounds_batch(imgs: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(first, last) row bounds of each image of a float [N, H, W, C]
    batch, as int64 [N] tensors. Reference semantics:
        keep = (img.sum(-1) > 1e-3).mean(-1) > 0.85   (float32 mean)
        first = argmax(keep); last = H - argmax(keep[::-1])
    An image with no kept row gives (0, H): no trim. ``torch.argmax``
    takes no bool tensor and returns the first maximum, so ``keep`` is
    cast to uint8 first."""
    h = imgs.shape[1]
    nonblack = imgs.sum(dim=-1) > TRIM_PIXEL_THRESHOLD
    keep = (nonblack.float().mean(dim=-1) > TRIM_ROW_FRACTION).to(
        torch.uint8)
    first = keep.argmax(dim=1)
    last = h - keep.flip(1).argmax(dim=1)
    return first, last


def trim_bounds(img: torch.Tensor) -> tuple[int, int]:
    """(first, last) row bounds of one float [H, W, C] image."""
    first, last = trim_bounds_batch(img[None])
    return int(first[0]), int(last[0])
