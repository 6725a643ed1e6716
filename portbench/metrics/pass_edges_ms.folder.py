"""pass_edges_ms.folder: the program's ``predict/plan`` (listing, header
reads and the plan, before the pump) and ``predict/finalize`` (draining the
artifact pool and writing the CSV, after it) stage timers over the window,
per pass (the calls of ``predict/plan``), in ms."""
from portbench.lib.readers import stage_total


def read(readings: dict) -> float | None:
    plan, passes = stage_total(readings, "predict/plan")
    finalize, _ = stage_total(readings, "predict/finalize")
    return (plan + finalize) / passes * 1e3 if passes else None
