"""Pieces the drivers share: the run's weights as the program loads them,
the device's memory peak, and the reference's copy of the weights."""
from __future__ import annotations

import gc
import os

import numpy as np
import torch

from portbench.lib import weights
from portbench.reference import model as M


def checkpoint(run, calibration: list, dtype: torch.dtype = torch.bfloat16
               ) -> str:
    """The run's random weights (lib/weights.py, drawn on the device from
    the seed), their BatchNorm statistics calibrated on the uint8 [h, w, 3]
    images ``calibration`` (a centre crop of each, 512 x 512 or the
    smallest side), written as a
    torchvision-named state dict in ``dtype``, the type they are served
    in; returns the file's path. The program loads the file; the
    reference reads it back (``reference_state``)."""
    cfg = run.cell.config
    state = weights.random_state_dict(M.param_shapes(cfg["model"]),
                                      run.seed, run.device)
    side = min(CALIB_SIDE, *(d for im in calibration for d in im.shape[:2]))
    crops = torch.stack([torch.from_numpy(np.array(crop(im, side)))
                         for im in calibration]).to(run.device)
    weights.calibrate_bn(state, cfg["model"], crops, cfg["mean"], cfg["std"])
    path = os.path.join(run.workdir, "model.pt")
    torch.save({k: (v.to(dtype) if v.is_floating_point() else v).cpu()
                for k, v in state.items()}, path)
    del state
    return path


CALIB_SIDE = 512
CALIB_IMAGES = 4


def crop(img: np.ndarray, side: int) -> np.ndarray:
    """The centre side x side crop of an image at least that large."""
    h, w = img.shape[:2]
    y, x = (h - side) // 2, (w - side) // 2
    return img[y:y + side, x:x + side]


def read_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_gray(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def calibration_images(paths: list[str]) -> list[np.ndarray]:
    """The first CALIB_IMAGES of the run's own images."""
    return [read_rgb(p) for p in paths[:CALIB_IMAGES]]


def reference_state(path: str, device) -> dict[str, torch.Tensor]:
    """The weights of ``path`` as float32 tensors on ``device``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.float() if v.is_floating_point() else v).to(device)
            for k, v in state.items()}


def reset_peak(device) -> int:
    """The peak so far; the counter then starts again."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def peak(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
