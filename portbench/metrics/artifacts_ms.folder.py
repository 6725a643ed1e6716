"""artifacts_ms.folder: the program's ``report/figure`` and ``report/dual``
stage timers (the combined figure and the dual PNG, each written on the
artifact pool's threads) over the window, summed over the threads, per
image, in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    figure, calls = stage_total(readings, "report/figure")
    dual, _ = stage_total(readings, "report/dual")
    images = readings.get("images") or 0
    return (figure + dual) / images * 1e3 if calls and images else None
