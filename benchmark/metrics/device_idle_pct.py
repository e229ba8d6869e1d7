"""Share of the traced window in which no operation ran on the card:
100 x (1 - union of the device operations' intervals / window), from the
profiler's trace."""


def read(rec):
    trace = rec.get("trace")
    if not trace or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / rec["window_s"])
