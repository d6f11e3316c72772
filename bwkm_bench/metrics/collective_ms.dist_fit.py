"""Median over fits of the synchronised host spans around the collectives of distributed/sharding.py, summed a fit, on the slowest rank, ms."""

from bwkm_bench.metrics._read import span_median


#: the span this metric reads, installed around the port's call in a traced run
SPANS = [("repro_torch.distributed.sharding", "_all_reduce", "collective", "host")]


def read(rec):
    return span_median(rec, "dist_fit", "collective")
