"""The traced window of a ``--trace 1`` run: one ``torch.profiler`` session
over the window, read in memory (no trace file).

- ``busy_s``: the union of the device-side events (kernels, copies,
  memsets) over the window's span, each overlap counted once. The
  bring-up script ``chip_smoke.py`` (``profile_pass``) summed the same
  events; the union does not count concurrent streams twice.
- ``window_s``: the length of the ``harness/window`` range, on the
  profiler's clock.
- ``breakdown``: the ten device operations that took the most time, by
  name, and the ten longest idle gaps, each named by the harness spans
  (lib/spans.py) open on any thread at the gap's middle.
- ``span_device_s(prefix, kernel)``: the device time of a kernel's events
  launched inside the harness's ranges whose name starts with ``prefix``,
  each device event tied to its launch on the host through the profiler's
  correlation id.
"""
from __future__ import annotations

import bisect
import contextlib

WINDOW = "harness/window"


def _profile():
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig
        cfg = _ExperimentalConfig(profile_all_threads=True)
        return profile(activities=acts, experimental_config=cfg)
    except (ImportError, TypeError):
        return profile(activities=acts)


class Trace:
    """``with Trace(on) as tr: ... with tr.window(): <the window>``."""

    def __init__(self, on: bool):
        self.on = on
        self.window_ns = None
        self._prof = None

    def __enter__(self):
        if self.on:
            self._prof = _profile()
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import record_function
        with record_function(WINDOW):
            yield

    def _read(self) -> None:
        from torch.autograd import DeviceType
        evs = self._prof.profiler.kineto_results.events()
        dev, launches, ranges = [], {}, []
        for e in evs:
            start, dur = e.start_ns(), e.duration_ns()
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            if e.device_type() == DeviceType.CUDA:
                if "annotation" in str(kind).lower() or \
                        e.name().startswith("harness/"):
                    continue  # the profiler's copy of a host range
                dev.append((start, start + dur, e.name(), e.correlation_id(),
                            e.linked_correlation_id()))
            elif e.is_user_annotation():
                if e.name() == WINDOW:
                    self.window_ns = (start, start + dur)
                elif e.name().startswith("harness/"):
                    ranges.append((start, start + dur, e.name(),
                                   e.start_thread_id()))
            elif e.name().startswith("cuda") and e.correlation_id():
                launches[e.correlation_id()] = (start, e.start_thread_id())

        self.device = dev
        self.launches = launches
        self.ranges = ranges
        self._prof = None

    def describe(self) -> str:
        """One line on what the trace holds, for the run's log."""
        if self.window_ns is None:
            return "trace: no window range"
        a0, a1 = self.window_ns
        inside = [d for d in self.device if a0 <= d[0] < a1]
        first = min((d[0] for d in inside), default=a0)
        last = max((d[1] for d in inside), default=a0)
        matched = sum(1 for d in self.device
                      if d[3] in self.launches or d[4] in self.launches)
        return (f"trace: window {(a1 - a0) / 1e9:.6f} s, {len(inside)} of "
                f"{len(self.device)} device events inside it (first "
                f"{(first - a0) / 1e9:.6f} s, last end {(last - a0) / 1e9:.6f}"
                f" s after its start), {len(self.launches)} launches, "
                f"{matched} device events tied to a launch, "
                f"{len(self.ranges)} harness ranges")

    # ------------------------------------------------------------ readings

    def _clipped(self) -> list[tuple[int, int]]:
        if self.window_ns is None:
            return []
        a0, a1 = self.window_ns
        out = [(max(s, a0), min(e, a1)) for s, e, *_ in self.device]
        return sorted((s, e) for s, e in out if e > s)

    def _union(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for s, e in self._clipped():
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def window_s(self) -> float | None:
        if self.window_ns is None:
            return None
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union()) / 1e9

    def device_ops(self, n: int = 10) -> list[list]:
        if self.window_ns is None:
            return []
        a0, a1 = self.window_ns
        by: dict[str, int] = {}
        for s, e, name, *_ in self.device:
            if a0 <= s < a1:
                by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        if self.window_ns is None:
            return []
        a0, a1 = self.window_ns
        busy = self._union()
        edges = [a0] + [x for s, e in busy for x in (s, e)] + [a1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) // 2
            open_ = sorted({name for r0, r1, name, _ in self.ranges
                            if r0 <= mid < r1})
            out.append(["+".join(open_) or "no harness span", (e - s) / 1e9])
        return out

    def span_device_s(self, prefix: str, kernel: str
                      ) -> tuple[float, int]:
        """(device seconds, events) of the device events named
        ``*kernel*`` whose launch lies inside a harness range named
        ``prefix...``: each device event is tied to its launch on the host
        through the profiler's correlation id. The profiler's thread ids
        of the launches and of the ranges are not the same on the card, so
        a launch is placed in a range by time, and launches that other
        threads made in the same interval are told apart by the kernel's
        name."""
        mine = sorted((a, b) for a, b, name, _ in self.ranges
                      if name.startswith(prefix))
        if not mine:
            return 0.0, 0
        starts = [a for a, _ in mine]
        total, count = 0, 0
        for s, e, name, corr, linked in self.device:
            if kernel not in name:
                continue
            launch = self.launches.get(corr) or self.launches.get(linked)
            if launch is None:
                continue
            k = bisect.bisect_right(starts, launch[0]) - 1
            if k >= 0 and launch[0] <= mine[k][1]:
                total += e - s
                count += 1
        return total / 1e9, count
