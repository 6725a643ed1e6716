"""The plain reference of the application's steps around the model: the
dark-band trim of a square scan, the small-zone clean-up, the per-image
statistics of final_stats.csv, and a whole image's class map.

- Trim (reference application, models.py:157-166): a row is kept when
  more than 85 % of its pixels have a channel sum above 1e-3 (on the
  image scaled to [0, 1]); the image keeps the rows from the first kept
  row to the last. Only a square image is trimmed, and an image with no
  kept row is left whole.
- Small zones (utils.py:135-148, skimage's remove_small_holes then
  remove_small_objects, area threshold 150, 8-connectivity): on the mask
  ``img == 0``, complement components smaller than 150 pixels are filled,
  then mask components smaller than 150 are removed; a removed class-0
  pixel becomes bark (1), a filled non-zero pixel becomes 0. Labelled with
  ``scipy.ndimage.label``.
- Statistics (models.py:323-332): bark and node pixel shares of the
  trimmed image in percent, and their areas at 3.6 x 3.6 mm^2 a pixel.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from . import Ops, module_for, normalize

SMALL_ZONE = 150
MM2_PER_PIXEL = 3.6 * 3.6
EIGHT = np.ones((3, 3), bool)


def trim_rows(img_u8: np.ndarray) -> tuple[int, int]:
    """(first, last) kept rows of a square uint8 [H, W, 3] scan."""
    h, w = img_u8.shape[:2]
    if h != w:
        return 0, h
    x = img_u8.astype(np.float32) / np.float32(255.0)
    keep = (x.sum(-1) > 1e-3).astype(np.float32).mean(-1) > 0.85
    if not keep.any():
        return 0, h
    first = int(np.argmax(keep))
    return first, h - int(np.argmax(keep[::-1]))


def _drop_small(mask: np.ndarray) -> np.ndarray:
    """``mask`` without its 8-connected components of < 150 pixels."""
    lab, n = ndimage.label(mask, structure=EIGHT)
    if n == 0:
        return mask
    area = np.bincount(lab.ravel(), minlength=n + 1)
    small = area < SMALL_ZONE
    small[0] = False
    return mask & ~small[lab]


def remove_small_zones(cmap: np.ndarray) -> np.ndarray:
    """The clean-up of a uint8 class map [H, W] in {0, 1, 2}."""
    zero = cmap == 0
    filled = ~_drop_small(~zero)          # remove_small_holes
    kept = _drop_small(filled)            # remove_small_objects
    out = cmap.copy()
    out[~kept & zero] = 1
    out[kept & ~zero] = 0
    return out


def stats(cmap: np.ndarray) -> dict:
    """final_stats.csv's numbers of one cleaned map, and its class counts."""
    return stats_of_counts(np.bincount(cmap.ravel(), minlength=3),
                           cmap.size)


def stats_of_counts(counts, n: int) -> dict:
    """The same numbers from the class counts of an image of n pixels."""
    counts = np.asarray(counts, np.int64)
    return {"counts": counts.tolist(),
            "bark_percent": counts[1] / n * 100.0,
            "bark_area_mm2": counts[1] * MM2_PER_PIXEL,
            "node_percent": counts[2] / n * 100.0,
            "node_area_mm2": counts[2] * MM2_PER_PIXEL}


def logits_and_map(state: dict, img_u8: np.ndarray, config: dict, device,
                   ops: Ops | None = None
                   ) -> tuple[torch.Tensor, np.ndarray]:
    """One trimmed uint8 [H, W, 3] image -> (its float32 logits [3, H, W]
    on ``device``, its cleaned class map): the forward of the
    configuration's reference model at the image's own size, with its
    upsample, the argmax (the first class on a tie), the small-zone
    clean-up."""
    x = normalize(torch.from_numpy(np.array(img_u8))[None].to(device),
                  config["mean"], config["std"])
    with torch.no_grad():
        logits = module_for(config).logits(state, x, config["model"],
                                           ops)[0]
    raw = logits.argmax(0).to(torch.uint8).cpu().numpy()
    return logits, remove_small_zones(raw)


TIE = 0.05
DECISIVE = 0.1


def logit_gaps(logits: torch.Tensor, want: np.ndarray,
               got: np.ndarray) -> dict:
    """How far a class map lies from the reference's, on the reference's
    own logits, in units of the logits' spatial standard deviation:
    ``deficit``, the mean over all pixels of |logit of the reference's
    class - logit of ``got``'s class| (0 where the maps agree), and
    ``flip``, the median of that gap over the pixels where they differ (0
    where none does): the size of a typical flip; ``tie_deficit``, the
    deficit over the density of near ties (the share of pixels whose
    reference top-2 margin is under TIE spreads, over TIE): noise of
    amplitude e flips about that density x e of the pixels by about e / 2
    each, so the quotient grows as e^2 whatever the network's share of
    near-tie pixels, which differs from seed to seed."""
    dev = logits.device
    w = torch.from_numpy(want.astype(np.int64)).to(dev)[None]
    g = torch.from_numpy(got.astype(np.int64)).to(dev)[None]
    gap = (logits.gather(0, w) - logits.gather(0, g)).abs()[0]
    spread = (logits - logits.mean((1, 2), keepdim=True)).std()
    differ = torch.from_numpy(want != got).to(dev)
    flips = gap[differ]
    top2 = logits.topk(2, dim=0).values
    margin = (top2[0] - top2[1]) / spread
    ties = float((margin < TIE).float().mean()) / TIE
    deficit = float(gap.mean() / spread)
    return {"deficit": deficit,
            "flip": float(flips.median() / spread) if flips.numel() else 0.0,
            "tie_deficit": deficit / ties if ties else (
                0.0 if deficit == 0 else float("inf")),
            "decisive": float((differ & (margin > DECISIVE)).float().mean())}
