"""upload_ms.folder: the program's ``predict/upload_h*`` stage timers (the
two host-to-device copies of a launch batch, its pixels and its row
heights, inside ``predict/dispatch_h*``) over the window, per launch batch,
in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    total, calls = stage_total(readings, "predict/upload_h")
    return total / calls * 1e3 if calls else None
