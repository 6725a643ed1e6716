"""decode_ms.folder: the program's ``predict/decode`` stage timers (a
chunk's PNG decode on the prediction pump's workers) over the window, per
image, in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    total, calls = stage_total(readings, "predict/decode")
    images = readings.get("images") or 0
    return total / images * 1e3 if calls and images else None
