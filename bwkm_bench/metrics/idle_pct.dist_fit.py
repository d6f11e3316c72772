"""The share (%) of the profiled units with no kernel, copy or set on the device."""

from bwkm_bench.metrics._read import idle_pct


def read(rec):
    return idle_pct(rec, "dist_fit")
