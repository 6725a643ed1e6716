"""launch_ms.folder: the program's ``predict/launch_h*`` stage timers (the
device step's launches, ``_device_step``, inside ``predict/dispatch_h*``)
over the window, per launch batch, in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    total, calls = stage_total(readings, "predict/launch_h")
    return total / calls * 1e3 if calls else None
