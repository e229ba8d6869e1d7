"""Median over the window's splits of the harness's span around
``run_validation`` (the device batches and the host's AUROC), in
milliseconds."""


def read(rec):
    spans = sorted(rec["spans"].get("score", []))
    if not spans:
        return None
    return 1e3 * spans[len(spans) // 2]
