"""dispatch_ms.serve: the program's ``predict/dispatch_h*`` stage timers
in the serving window (inside the batcher), per launch batch, in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    total, calls = stage_total(readings, "predict/dispatch_h")
    return total / calls * 1e3 if calls else None
