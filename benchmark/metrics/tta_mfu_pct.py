"""The window's adaptation and scoring as a share of the H100's dense
bf16 peak: the frozen model FLOPs (``counts.py``: the statistics pass,
the Tent steps, the scoring forwards) over window seconds x 989e12."""

import counts


def read(rec):
    flops = rec["counts"].get("flops")
    if not flops or not rec.get("window_s") or not rec["counts"].get("splits"):
        return None
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
