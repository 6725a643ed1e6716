"""collectives_ms.train: the device time of the events launched inside the
program's ``train/collective/`` spans (the gradients' all-reduce, and the
cross-rank BatchNorm's all-reduces forward and backward; lib/launched.py,
which also places the kernels that NCCL launches through the driver), per
step, in ms. Nothing is read where the program has no such span."""
from portbench.lib.launched import span_device_s


def read(readings: dict) -> float | None:
    tr, steps = readings.get("trace"), readings.get("steps")
    if tr is None or not steps:
        return None
    seconds, events = span_device_s(tr, "train/collective/")
    return seconds / steps * 1e3 if events else None
