"""Median host time of ``run_validation``'s metric reduction after its
read-back (the port's ``eval.metrics`` span: concatenation, accuracy,
AUROC of three heads, loss means; nothing queued on the card), one a
validation or a scored split, in milliseconds."""

from program_spans import median_ms


def read(rec):
    return median_ms(rec, "eval.metrics")
