"""batch_mean.serve: the images per micro-batch over the window, from the
change of the server's ``/v1/stats`` counters: batch_size_sum over
batches."""


def read(readings: dict) -> float | None:
    a, b = readings.get("stats_before"), readings.get("stats_after")
    if not a or not b:
        return None
    batches = b["batches"] - a["batches"]
    return (b["batch_size_sum"] - a["batch_size_sum"]) / batches \
        if batches else None
