"""The harness's own spans: host-clock intervals around calls into the
program's layers, kept in memory, each also a ``record_function`` range so
that a profiled run can match the device work launched inside it.

``wrap(owner, attr, name)`` replaces ``owner.attr`` by a function that runs
the original inside a span, ``patch`` by any function; ``Spans.restore()``
puts every original back.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time


class Spans:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.records: list[tuple[str, float, float]] = []
        self._patched: list[tuple[object, str, object]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.records.append((name, t0, t1))

    def patch(self, owner, attr: str, replacement) -> None:
        """``owner.attr = replacement`` until ``restore()``."""
        self._patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, replacement)

    def wrap(self, owner, attr: str, name: str) -> None:
        original = getattr(owner, attr)

        @functools.wraps(original)
        def wrapped(*args, **kwargs):
            with self.span(name):
                return original(*args, **kwargs)

        self.patch(owner, attr, wrapped)

    def restore(self) -> None:
        for owner, attr, original in reversed(self._patched):
            setattr(owner, attr, original)
        self._patched.clear()

    def clear(self) -> None:
        with self._lock:
            self.records.clear()

    def total(self, prefix: str, t0: float = float("-inf"),
              t1: float = float("inf")) -> tuple[float, int]:
        """(seconds, count) of the spans whose name starts with ``prefix``
        and that end inside [t0, t1]."""
        with self._lock:
            hits = [(b - a) for n, a, b in self.records
                    if n.startswith(prefix) and t0 <= b <= t1]
        return sum(hits), len(hits)
