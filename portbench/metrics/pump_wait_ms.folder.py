"""pump_wait_ms.folder: the program's ``predict/wait`` stage timers (the
consuming thread's wait for the oldest chunk in flight on the pump) over
the window, per launch batch, in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    total, calls = stage_total(readings, "predict/wait")
    return total / calls * 1e3 if calls else None
