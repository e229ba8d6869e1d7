"""The window's training steps and validation forwards as a share of
the H100's dense bf16 peak: the frozen model FLOPs (``counts.py``: the
student's forward and backward, the EMA teacher's forward, the eval
forwards) over window seconds x 989e12."""

import counts


def read(rec):
    flops = rec["counts"].get("flops")
    if not flops or not rec.get("window_s") or not rec["counts"].get("steps"):
        return None
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
