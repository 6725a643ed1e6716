"""mfu.folder: the images completed in the window times the reference
model's FLOPs an image (lib/flops.model_flops at each image's own size),
over the window, as a share of the card's bf16 dense peak, in %."""
from portbench.lib.readers import window_s


def read(readings: dict) -> float | None:
    seconds = window_s(readings)
    if not readings.get("images") or not seconds:
        return None
    rate = readings["images"] * readings["image_flops"] / seconds
    return rate / readings["peaks"]["bf16_flops_per_s"] * 100.0
