"""upsample_argmax_roofline: the least time of the window's
``ops.upsample_argmax.upsample_argmax`` calls (lib/flops.
upsample_argmax_bytes at the card's HBM bandwidth) over the device time of
the ``upsample_argmax_kernel`` events launched inside the harness's span
around each call (matched through the profiler's correlation ids,
lib/trace.py), in %. Nothing is read where the
trace holds no such event."""
from portbench.lib.flops import upsample_argmax_bytes


def read(readings: dict) -> float | None:
    tr, calls = readings.get("trace"), readings.get("upsample_argmax_calls")
    if tr is None or not calls:
        return None
    device_s, events = tr.span_device_s("harness/upsample_argmax",
                                        "upsample_argmax_kernel")
    if not events or device_s <= 0:
        return None
    nbytes = sum(upsample_argmax_bytes(*c) for c in calls)
    bound_s = nbytes / readings["peaks"]["hbm_bytes_per_s"]
    return bound_s / device_s * 100.0
