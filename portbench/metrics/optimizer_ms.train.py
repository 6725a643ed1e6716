"""optimizer_ms.train: the device time of the events launched inside the
program's ``train/optimizer`` spans (the Adam step), matched through the
profiler's correlation ids (lib/program.py), per step, in ms."""
from portbench.lib.program import step_device_ms


def read(readings: dict) -> float | None:
    return step_device_ms(readings, "train/optimizer")
