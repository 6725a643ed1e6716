"""Pieces the drivers share: the run's weights as the program loads them,
the device's memory peak, the reference's copy of the weights, and what
the ranks of a run agree on (``Steps``, ``max_over``, ``mean_over``,
``leave``)."""
from __future__ import annotations

import gc
import os

import numpy as np
import torch

from portbench.lib import weights


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
    state = weights.random_state_dict(cfg, run.seed, run.device)
    side = min(CALIB_SIDE, *(d for im in calibration for d in im.shape[:2]))
    crops = torch.stack([torch.from_numpy(np.array(crop(im, side)))
                         for im in calibration]).to(run.device)
    weights.calibrate_bn(cfg, state, crops)
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


class Steps:
    """Whether a window goes on: in one process the caller's own answer;
    under a ``world``, rank 0's answer on every rank (one int broadcast a
    step over a gloo group, host to host, which waits for no device), so
    that every rank runs the same steps and no collective waits for a rank
    that has stopped."""

    def __init__(self, world) -> None:
        self.group = None
        if world is not None:
            import torch.distributed as dist
            self.group = dist.new_group(backend="gloo")

    def go(self, flag: bool) -> bool:
        if self.group is None:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)])
        dist.broadcast(t, 0, group=self.group)
        return bool(t.item())


def max_over(world, *values: int) -> list[int]:
    """Each value's largest over the ranks of ``world`` (the values as they
    are in one process)."""
    if world is None:
        return list(values)
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.int64, device=world.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world.group)
    return [int(v) for v in t.tolist()]


def mean_over(world, value: float) -> float:
    """``value``'s mean over the ranks of ``world``."""
    if world is None:
        return value
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.float64, device=world.device)
    dist.all_reduce(t, group=world.group)
    return float(t) / world.size


def leave(world) -> None:
    """Every rank leaves the process group (rank 0 then checks alone)."""
    if world is not None:
        from neuralbarkcalculator_tpu_torch.parallel.distributed import \
            shutdown_distributed
        shutdown_distributed()
