"""idle_share.train: 1 minus the union of the device-side profiler events
over the traced window, in % (lib/trace.py)."""
from portbench.lib.readers import idle_share


def read(readings: dict) -> float | None:
    return idle_share(readings)
