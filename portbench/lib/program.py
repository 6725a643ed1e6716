"""The program's own spans in a traced run: the port's stage timers
(``utils/profiling.stage_timer``, names under ``predict/``, ``report/``
and ``train/``), which a profiler session also records as ranges.

``ranges(trace)`` reads them from the program's log of the spans it ran
while the profiler recorded (``profiling.spans()``: start and end on the
wall clock in ns, the clock of the profiler's events), those that overlap
the traced window. A program without that log gives none, and every
reading here is then empty.

- ``device_s``: the device time of the events launched inside the ranges
  of a prefix, each device event tied to its launch on the host through
  the profiler's correlation id and placed in a range by the launch's
  time, as ``Trace.span_device_s`` does for the harness's ranges.
- ``gap_labels``: the trace's ten longest idle gaps (``Trace.idle_gaps``),
  each named by the harness ranges open at its middle, in the order
  ``idle_gaps`` gives them, then by the program's ranges open there on any
  thread, joined by ``+`` and cut at 160 characters.
- ``idle_split``: the window's idle time by the set of program ranges
  open at each gap's middle, a launch height ``_h<n>`` written ``_h*``.
"""
from __future__ import annotations

import bisect
import re

PREFIXES = ("predict/", "report/", "train/")
_HEIGHT = re.compile(r"_h\d+")


def ranges(trace) -> list[tuple[int, int, str, int | None]]:
    """(start ns, end ns, name, chunk) of the program's spans inside the
    traced window, by start."""
    if trace is None or trace.window_ns is None:
        return []
    try:
        from neuralbarkcalculator_tpu_torch.utils import profiling
    except ImportError:
        return []
    log = getattr(profiling, "spans", None)
    if log is None:
        return []
    a0, a1 = trace.window_ns
    return sorted((s, e, name, chunk) for name, s, e, chunk in log()
                  if name.startswith(PREFIXES) and e > a0 and s < a1)


def device_s(trace, spans: list, prefix: str) -> tuple[float, int]:
    """(device seconds, events) of the device events whose launch lies in
    a program span named ``prefix...``."""
    mine = sorted((s, e) for s, e, name, _ in spans
                  if name.startswith(prefix))
    if trace is None or not mine:
        return 0.0, 0
    starts = [s for s, _ in mine]
    total, count = 0, 0
    for s, e, _name, corr, linked in trace.device:
        launch = trace.launches.get(corr) or trace.launches.get(linked)
        if launch is None:
            continue
        k = bisect.bisect_right(starts, launch[0]) - 1
        if k >= 0 and launch[0] <= mine[k][1]:
            total += e - s
            count += 1
    return total / 1e9, count


def gaps(trace) -> list[tuple[int, int]]:
    """The window's idle gaps, longest first, as ``Trace.idle_gaps``
    orders them."""
    a0, a1 = trace.window_ns
    edges = [a0] + [x for s, e in trace._union() for x in (s, e)] + [a1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return gaps


def _open_at(spans: list, times: list[int]) -> list[list[str]]:
    """For each time, the names of the spans open at it (a sweep over the
    spans by start)."""
    out: list[list[str]] = [[] for _ in times]
    active: list[tuple[int, str]] = []
    i = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            active.append((spans[i][1], spans[i][2]))
            i += 1
        active = [(e, name) for e, name in active if e > t]
        out[k] = sorted({name for _, name in active})
    return out


def gap_labels(trace, spans: list, n: int = 10) -> list[list]:
    if trace is None or trace.window_ns is None:
        return []
    longest = gaps(trace)[:n]
    mids = [(s + e) // 2 for s, e in longest]
    out = []
    for (s, e), mid, mine in zip(longest, mids, _open_at(spans, mids)):
        harness = sorted({name for r0, r1, name, _ in trace.ranges
                          if r0 <= mid < r1})
        label = "+".join(harness + mine)
        out.append([label[:160] or "no span", (e - s) / 1e9])
    return out


def idle_split(trace, spans: list) -> dict[str, float]:
    """{program spans open at the gap's middle: idle seconds} over every
    gap of the window, most first."""
    if trace is None or trace.window_ns is None:
        return {}
    every = gaps(trace)
    by: dict[str, float] = {}
    for (s, e), names in zip(every, _open_at(
            spans, [(s + e) // 2 for s, e in every])):
        key = "+".join(sorted({_HEIGHT.sub("_h*", n) for n in names})) \
            or "no program span"
        by[key] = by.get(key, 0.0) + (e - s) / 1e9
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def step_device_ms(readings: dict, prefix: str) -> float | None:
    """Device ms a training step of the events launched inside the
    program's ``prefix`` spans; None where the trace holds none."""
    trace, steps = readings.get("trace"), readings.get("steps")
    if trace is None or not steps:
        return None
    seconds, events = device_s(trace, ranges(trace), prefix)
    return seconds / steps * 1e3 if events else None
