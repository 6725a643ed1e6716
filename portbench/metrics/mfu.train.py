"""mfu.train: the optimizer steps of the window times the FLOPs of a step
(lib/flops.train_step_flops: forward, weight and input gradients of every
conv of the reference model), over the window, as a share of the card's
float32 peak outside the tensor cores (the cell trains in float32 with
TF32 off), in %."""
from portbench.lib.readers import window_s


def read(readings: dict) -> float | None:
    seconds = window_s(readings)
    if not readings.get("steps") or not seconds:
        return None
    rate = readings["steps"] * readings["step_flops"] / seconds
    return rate / readings["peaks"]["fp32_flops_per_s"] * 100.0
