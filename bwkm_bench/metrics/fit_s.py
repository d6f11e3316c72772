"""Seconds per in-core fit: the window over the fits completed in it."""

from bwkm_bench.metrics._read import per_unit_s


def read(rec):
    return per_unit_s(rec, "fit")
