"""Seconds per distributed fit on the slowest rank: its window over its fits."""

from bwkm_bench.metrics._read import per_unit_s


def read(rec):
    return per_unit_s(rec, "dist_fit")
