"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. ``cuda`` (the default)
    raises when no card is present: a run never carries on on the CPU
    unless the caller asked for it with ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            f"pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def set_float32_exact(dev: torch.device) -> None:
    """Full float32 on the card: cuDNN convolutions default to TF32
    (``torch.backends.cudnn.allow_tf32`` is True), matmuls do not; set
    both flags off so float32 runs keep float32's precision. Process-wide,
    as those flags are."""
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
