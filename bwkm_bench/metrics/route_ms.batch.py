"""Median over batches of the CUDA-event time of route_into_boxes, ms."""

from bwkm_bench.metrics._read import span_median


#: the span this metric reads, installed around the port's call in a traced run
SPANS = [("repro_torch.core.partition", "route_into_boxes", "route", "events")]


def read(rec):
    return span_median(rec, "service", "route")
