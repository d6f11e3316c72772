"""The 90th percentile (ms) over every batch of the window of one service update, submit to return with a synchronise."""

import statistics


def read(rec):
    if rec["kind"] != "service" or not rec["unit_s"]:
        return None
    ms = [t * 1e3 for t in rec["unit_s"]]
    return statistics.quantiles(ms, n=10, method="inclusive")[8] if len(ms) > 1 else ms[0]
