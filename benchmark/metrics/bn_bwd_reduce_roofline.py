"""``bn_bwd_reduce``'s share of its HBM bound over the traced window
(see ``bn_roofline.py``): x and dy, two (M, C) inputs a call."""

from bn_roofline import roofline_pct


def read(rec):
    return roofline_pct(rec, "bn_bwd_reduce_kernel", 2)
