"""Stage timers: wall-clock time per named pipeline stage, with a
process-wide report (near-zero cost when disabled); and ``device_trace``,
a profiler trace of a block of work.

Stages that end in a device pull (``predict/pull_h*``) include the device
work they wait for; the others are host time.

While a ``torch.profiler`` session records, each stage is also a range
of the profiler's (a host event on the thread that ran it, on the clock
of the device events), so a trace shows which host stage was open at
every device event and every idle gap; and the stage's interval is kept
in a bounded log (``spans()``) on that clock (the wall clock, in ns), for
tools that read a trace in memory, with the thread that ran it
(``thread_spans()``). The range is a plain host event
(``_RecordFunctionFast``), not a ``record_function`` user annotation,
whose device-side copy the profiler adds to the device's events. Spans of
one chunk of the prediction pump carry the chunk's first manifest index:
the range's input, shown as "Concrete Inputs" when the session records
shapes.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# name -> [calls, total seconds]
_STAGES: dict[str, list] = {}
_LOCK = threading.Lock()
_ENABLED = True
# (name, start ns, end ns, chunk, native thread id) of the spans run while
# a profiler records
SPAN_LOG = 1 << 16
_SPANS: deque = deque(maxlen=SPAN_LOG)
# the chunk of the prediction pump a thread works on (``chunk_scope``)
_LOCAL = threading.local()


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def stage_timer(name: str, chunk: int | None = None):
    """Accumulate wall time under ``name`` (see ``report()``); while a
    profiler records, also a profiler range named ``name`` (with ``chunk``,
    the first manifest index of the pump's chunk, or else the thread's
    ``chunk_scope``, as its input) and an entry of ``spans()``."""
    if not _ENABLED:
        yield
        return
    if not _profiler._is_profiler_enabled:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _add(name, time.perf_counter() - t0)
        return
    if chunk is None:
        chunk = getattr(_LOCAL, "chunk", None)
    # no input at all where there is no chunk (None is refused)
    args = (name,) if chunk is None else (name, (chunk,))
    with _RecordFunctionFast(*args):
        t0 = time.perf_counter()
        w0 = time.time_ns()
        try:
            yield
        finally:
            w1 = time.time_ns()
            dt = time.perf_counter() - t0
            _SPANS.append((name, w0, w1, chunk, threading.get_native_id()))
            _add(name, dt)


@contextlib.contextmanager
def chunk_scope(chunk: int):
    """The stage timers this thread runs inside the block carry ``chunk``
    (a chunk's first manifest index) unless they name their own."""
    before = getattr(_LOCAL, "chunk", None)
    _LOCAL.chunk = chunk
    try:
        yield
    finally:
        _LOCAL.chunk = before


def _add(name: str, seconds: float) -> None:
    with _LOCK:
        row = _STAGES.get(name)
        if row is None:
            _STAGES[name] = [1, seconds]
        else:
            row[0] += 1
            row[1] += seconds


def report(reset: bool = False) -> dict[str, dict[str, float]]:
    """{stage: {calls, total_s, mean_s}} for all stages so far; ``reset``
    also empties ``spans()``."""
    with _LOCK:
        out = {name: {"calls": calls, "total_s": total,
                      "mean_s": total / calls}
               for name, (calls, total) in _STAGES.items()}
        if reset:
            _STAGES.clear()
            _SPANS.clear()
    return out


def spans() -> list[tuple[str, int, int, int | None]]:
    """(name, start ns, end ns, chunk) of the latest ``SPAN_LOG`` stages
    run while a profiler recorded, on the wall clock the profiler's events
    use (``time.time_ns``)."""
    return [row[:4] for row in list(_SPANS)]


def thread_spans() -> list[tuple[str, int, int, int | None, int]]:
    """``spans()`` with the native id of the thread that ran each."""
    return list(_SPANS)


def print_report(reset: bool = False) -> None:
    for name, row in sorted(report(reset).items(),
                            key=lambda kv: -kv[1]["total_s"]):
        print(f"{name:32s} {row['calls']:5d} calls  "
              f"{row['total_s']:8.3f}s total  {row['mean_s']*1e3:8.1f}ms "
              f"mean")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler``: CPU activity on every
    thread, with the stage timers' ranges, and CUDA activity (kernels,
    copies) when a card is present; on exit, export one Chrome trace
    (``trace-<pid>-<ns>.json``, open it in Perfetto or chrome://tracing)
    into ``log_dir``. The counterpart of the JAX package's
    ``jax.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True,
                 **_all_threads()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _all_threads() -> dict:
    """The profiler's option to record every thread (the prediction pump's
    workers, the artifact pool), where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}
