"""dispatch_ms.folder: the program's ``predict/dispatch_h*`` stage timers
(the pageable upload and the model's launches) over the window, per launch
batch, in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    total, calls = stage_total(readings, "predict/dispatch_h")
    return total / calls * 1e3 if calls else None
