"""The port's program spans (``stil_tta_torch/utils/trace.py``), which
it records while the traced window's profiler runs: the median duration
of one span's records, in milliseconds. An untraced run, and a port that
records no spans, read nothing."""

import statistics


def median_ms(rec, name):
    if rec.get("trace") is None:
        return None
    try:
        from stil_tta_torch.utils import trace
    except ImportError:
        return None
    ms = [(end - start) / 1e6 for span, start, end, _ in trace.spans()
          if span == name and end is not None]
    return statistics.median(ms) if ms else None
