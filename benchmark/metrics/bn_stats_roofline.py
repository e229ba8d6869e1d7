"""``bn_stats``'s share of its HBM bound over the traced window (see
``bn_roofline.py``): one (M, C) input a call."""

from bn_roofline import roofline_pct


def read(rec):
    return roofline_pct(rec, "bn_stats_kernel", 1)
