"""Median over the window's splits of the harness's span around
``tta.tent.adapt`` (drained at both ends), in milliseconds."""


def read(rec):
    spans = sorted(rec["spans"].get("adapt", []))
    if not spans:
        return None
    return 1e3 * spans[len(spans) // 2]
