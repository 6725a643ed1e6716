"""Device time by the program's spans, for launches that lib/trace.py does
not keep, on the thread that launched them.

lib/program.py ties a device event to the program span open at its launch
through the profiler's correlation id, and lib/trace.py keeps the
launches of the CUDA runtime (the ``cuda*`` calls) with the profiler's id
of the launching thread. Kernels that cuDNN, cuBLAS or NCCL launch through
the driver (``cuLaunchKernel*``) have no kept launch, and fall out of
those readings. CUPTI numbers the API calls of every thread in one
sequence, so such a kernel's launch lies between the kept launches just
before and just after it in that sequence.

Threads: where two threads launch at once (the prediction pump's
workers), a span of one thread must not take the other's kernels. The
program logs the native id of the thread that ran each span
(``profiling.thread_spans``); each native thread is matched to the
profiler's thread id of the kept launches in its spans of the prefix
read: the one that launches alone in most of them, else in most of them
at all (such a span launches work, so it holds its own thread's kept
launches, and the other thread's only where that thread launches at the
same time: the other thread never launches alone there). A span that
launches nothing kept (a collective's) leaves its thread unmatched.
``span_device_s`` then
counts a device event whose launch is kept where its launch lies in a
span of its own thread, and one whose launch is not where the interval
between its launching thread's kept launches around it meets a span of
that thread: that thread is the one of both neighbours in the sequence
where they agree, else the one of the two whose own launches bound it
more tightly in time. The spans of an unmatched thread are matched to
every thread; a program without the log (``thread_spans``) gives none.
"""
from __future__ import annotations

import bisect
import re
from collections import Counter, defaultdict

ANY = None  # the spans of a thread that could not be matched


def _union(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _logged(trace) -> list[tuple[int, int, str, int | None]]:
    """(start, end, name, native thread or None) of the program's spans
    inside the traced window."""
    try:
        from neuralbarkcalculator_tpu_torch.utils import profiling
    except ImportError:
        return []
    log = getattr(profiling, "thread_spans", None)
    if log is None or trace.window_ns is None:
        return []
    a0, a1 = trace.window_ns
    return [(s, e, name, tid) for name, s, e, _chunk, tid in log()
            if e > a0 and s < a1]


def _by_thread(logged, prefix: str, times: list[int], tids: list
               ) -> dict[object, tuple[list[int], list[tuple[int, int]]]]:
    """{profiler thread id, or ANY: (starts, the union of its spans named
    ``prefix...``)}; ``times`` and ``tids`` are the kept launches by time.
    The spans named ``prefix...`` vote for their thread's match."""
    alone: dict[object, Counter] = defaultdict(Counter)
    seen: dict[object, Counter] = defaultdict(Counter)
    for s, e, name, native in logged:
        if native is None or not name.startswith(prefix):
            continue
        i, j = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
        inside = set(tids[i:j])
        seen[native].update(inside)
        if len(inside) == 1:
            alone[native].update(inside)
    match = {n: max(c, key=lambda r: (alone[n][r], c[r]))
             for n, c in seen.items() if c}
    out: dict[object, list] = defaultdict(list)
    for s, e, name, native in logged:
        if name.startswith(prefix):
            out[match.get(native, ANY)].append((s, e))
    merged = {k: _union(v) for k, v in out.items()}
    return {k: ([s for s, _ in v], v) for k, v in merged.items()}


def _meets(spans: tuple[list[int], list[tuple[int, int]]], lo: int,
           hi: int) -> bool:
    starts, union = spans
    j = bisect.bisect_right(starts, hi) - 1
    return j >= 0 and union[j][1] >= lo


def span_device_s(trace, prefix: str, kernel: re.Pattern | None = None
                  ) -> tuple[float, int]:
    """(device seconds, events) of the device events (whose name
    ``kernel`` matches, if given) launched inside the program's spans named
    ``prefix...`` on the thread that ran the span (module docstring)."""
    if trace is None:
        return 0.0, 0
    logged = _logged(trace)
    if not any(name.startswith(prefix) for _, _, name, _ in logged):
        return 0.0, 0
    by_time = sorted(trace.launches.values())
    spans = _by_thread(logged, prefix, [t for t, _ in by_time],
                       [tid for _, tid in by_time])
    kept = sorted((corr, t, tid) for corr, (t, tid) in
                  trace.launches.items())
    corrs = [c for c, _, _ in kept]
    own: dict[object, list[tuple[int, int]]] = defaultdict(list)
    for c, t, tid in kept:
        own[tid].append((c, t))

    def bound(tid, corr: int) -> tuple[int, int] | None:
        """The times of ``tid``'s kept launches just before and just after
        the sequence number ``corr``."""
        seq = own[tid]
        k = bisect.bisect_left(seq, (corr, -1))
        if k == 0 or k == len(seq):
            return None
        return seq[k - 1][1], seq[k][1]

    total, count = 0, 0
    for s, e, name, corr, linked in trace.device:
        if kernel is not None and not kernel.search(name):
            continue
        hit = trace.launches.get(corr) or trace.launches.get(linked)
        if hit is not None:
            lo = hi = hit[0]
            tid = hit[1]
        else:
            k = bisect.bisect_left(corrs, corr)
            if k == 0 or k == len(corrs):
                continue
            (_, t0, a), (_, t1, b) = kept[k - 1], kept[k]
            lo, hi, tid = t0, t1, a
            if a != b:
                cands = [(w[1] - w[0], w, t) for t, w in
                         ((a, bound(a, corr)), (b, bound(b, corr)))
                         if w is not None]
                if not cands:
                    continue
                _, (lo, hi), tid = min(cands, key=lambda c: c[0])
        if any(_meets(spans[t], lo, hi) for t in (tid, ANY) if t in spans):
            total += e - s
            count += 1
    return total / 1e9, count
