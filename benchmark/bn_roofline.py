"""A BN reduction kernel's share of its HBM bound in a traced window:
the bytes its calls had to read (each call's (M, C) bf16 input, and for
``bn_bwd_reduce`` dy too, from the frozen shape list in ``counts.py``)
over 3.35e12 B/s, against the kernel's device time by name."""

import counts
from tracesum import kernel_seconds

BN_LAYERS = 53


def roofline_pct(rec, tag: str, inputs: int):
    trace = rec.get("trace")
    if not trace:
        return None
    calls, seconds = kernel_seconds(trace, tag)
    if not calls or seconds <= 0 or calls % BN_LAYERS:
        return None
    batch = rec["counts"]["bn_passes_batch"]
    img = rec["config"]["cfg"]["img_size"]
    passes = calls // BN_LAYERS
    nbytes = passes * inputs * counts.bn_stats_bytes(batch, img)
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES_PER_S / seconds
