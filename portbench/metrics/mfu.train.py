"""mfu.train: the optimizer steps of the window times the FLOPs of a step
of the global batch (lib/flops.train_step_flops: forward and the gradient
of each operand of every product of the reference model), over the window,
as a share of the float32 peak outside the tensor cores (the cell trains
in float32 with TF32 off) of the cell's ``chips`` cards, in %."""
from portbench.lib.readers import window_s


def read(readings: dict) -> float | None:
    seconds = window_s(readings)
    if not readings.get("steps") or not seconds:
        return None
    rate = readings["steps"] * readings["step_flops"] / seconds
    peak = readings["peaks"]["fp32_flops_per_s"] * readings.get("chips", 1)
    return rate / peak * 100.0
