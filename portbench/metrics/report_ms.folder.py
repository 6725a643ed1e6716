"""report_ms.folder: the harness's spans around ``PredictReporter.add``
(the CSV row and the hand-off) and around the two artifact writers it
hands each image to (the combined figure, the dual PNG), summed over the
window's threads, per image, in ms."""


def read(readings: dict) -> float | None:
    spans = readings.get("spans")
    images = readings.get("images") or 0
    if spans is None or not images:
        return None
    total, count = spans.total("harness/report/")
    return total / images * 1e3 if count else None
