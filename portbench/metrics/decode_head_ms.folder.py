"""decode_head_ms.folder: the device time of the events launched inside
the program's ``predict/decode_head`` spans (SegFormer's all-MLP decoder;
lib/launched.py, which also places the kernels that cuDNN and cuBLAS
launch through the driver), per image launched, in ms. Nothing is read
where the program has no such span."""
from portbench.lib.launched import span_device_s


def read(readings: dict) -> float | None:
    tr, calls = readings.get("trace"), readings.get("upsample_argmax_calls")
    if tr is None or not calls:
        return None
    seconds, events = span_device_s(tr, "predict/decode_head")
    images = sum(c[0] for c in calls)
    return seconds / images * 1e3 if events and images else None
