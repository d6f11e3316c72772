"""Median over fits of the synchronised host spans around the weighted Lloyd calls over the representatives, summed a fit, ms."""

from bwkm_bench.metrics._read import span_median


#: the span this metric reads, installed around the port's call in a traced run
SPANS = [("repro_torch.core.lloyd", "weighted_lloyd", "lloyd", "host")]


def read(rec):
    return span_median(rec, "fit", "lloyd")
