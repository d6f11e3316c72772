"""Median over fits of the CUDA-event time of the block_stats calls, summed a fit, ms."""

from bwkm_bench.metrics._read import span_median


#: the span this metric reads, installed around the port's call in a traced run
SPANS = [("repro_torch.core.partition", "block_stats", "block_stats", "events")]


def read(rec):
    return span_median(rec, "fit", "block_stats")
