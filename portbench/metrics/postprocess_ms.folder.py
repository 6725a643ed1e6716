"""postprocess_ms.folder: the program's ``predict/postprocess_h*`` stage
timers (the native union-find clean-up and class counts) over the window,
per image, in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    total, calls = stage_total(readings, "predict/postprocess_h")
    images = readings.get("images") or 0
    return total / images * 1e3 if calls and images else None
