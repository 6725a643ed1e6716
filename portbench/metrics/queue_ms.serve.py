"""queue_ms.serve: the median of the answers' ``queue_ms`` (the time each
request waited in the batcher's queue, as the server reports it) over the
requests of the window, in ms."""
import statistics


def read(readings: dict) -> float | None:
    q = [a["queue_ms"] for a in readings.get("answers") or []
         if "queue_ms" in a]
    return statistics.median(q) if q else None
