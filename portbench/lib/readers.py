"""Arithmetic the per-layer metric readers (portbench/metrics/) share.
Each returns None where the run holds nothing to read."""
from __future__ import annotations


def stage_total(readings: dict, prefix: str) -> tuple[float, int]:
    """(seconds, calls) of the program's stage timers named prefix*."""
    rows = [v for k, v in (readings.get("stages") or {}).items()
            if k.startswith(prefix)]
    return sum(v["total_s"] for v in rows), sum(v["calls"] for v in rows)


def window_s(readings: dict) -> float | None:
    tr = readings.get("trace")
    if tr is not None and tr.window_s():
        return tr.window_s()
    return readings.get("seconds")


def idle_share(readings: dict) -> float | None:
    tr = readings.get("trace")
    if tr is None or not tr.window_s():
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    return (1.0 - busy / tr.window_s()) * 100.0
