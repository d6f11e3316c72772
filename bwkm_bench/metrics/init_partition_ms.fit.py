"""Median over fits of the synchronised host span around the initial partition (Algorithms 2-4), ms."""

from bwkm_bench.metrics._read import span_median


#: the span this metric reads, installed around the port's call in a traced run
SPANS = [("repro_torch.core.init_partition", "build_initial_partition", "init_partition", "host")]


def read(rec):
    return span_median(rec, "fit", "init_partition")
