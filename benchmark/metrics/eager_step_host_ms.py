"""Median host time of one eager step in the traced window, in
milliseconds: the port's ``train.step`` span in a training cell (the
eager tail, the dispatch warm-up), ``tta.step`` in a TTA cell (one Tent
step), by the mix's driver."""

from program_spans import median_ms

SPAN = {"train": "train.step", "tta": "tta.step"}


def read(rec):
    name = SPAN.get(rec.get("mix", {}).get("driver"))
    return None if name is None else median_ms(rec, name)
