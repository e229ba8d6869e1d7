"""Median host time of one eval step call in ``run_validation``'s
enqueue loop in the traced window (the port's ``eval.batch`` span), in
milliseconds."""

from program_spans import median_ms


def read(rec):
    return median_ms(rec, "eval.batch")
