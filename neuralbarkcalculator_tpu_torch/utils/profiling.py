"""Stage timers: wall-clock time per named pipeline stage, with a
process-wide report (near-zero cost when disabled); and ``device_trace``,
a profiler trace of a block of work.

Stages that end in a device pull (``predict/pull_h*``) include the device
work they wait for; the others are host time.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

_STAGES: dict[str, list[float]] = defaultdict(list)
_LOCK = threading.Lock()
_ENABLED = True


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate wall time under ``name`` (see ``report()``)."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _STAGES[name].append(dt)


def report(reset: bool = False) -> dict[str, dict[str, float]]:
    """{stage: {calls, total_s, mean_s}} for all stages so far."""
    with _LOCK:
        out = {name: {"calls": len(times), "total_s": sum(times),
                      "mean_s": sum(times) / len(times)}
               for name, times in _STAGES.items()}
        if reset:
            _STAGES.clear()
    return out


def print_report(reset: bool = False) -> None:
    for name, row in sorted(report(reset).items(),
                            key=lambda kv: -kv[1]["total_s"]):
        print(f"{name:32s} {row['calls']:5d} calls  "
              f"{row['total_s']:8.3f}s total  {row['mean_s']*1e3:8.1f}ms "
              f"mean")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler``: CPU activity, and CUDA
    activity (kernels, copies) when a card is present; on exit, export
    one Chrome trace (``trace-<pid>-<ns>.json``, open it in Perfetto or
    chrome://tracing) into ``log_dir``. The counterpart of the JAX
    package's ``jax.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
