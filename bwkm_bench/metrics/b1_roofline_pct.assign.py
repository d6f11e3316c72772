"""B1's share (%) of its roofline over the profiled passes: the larger of operations over the peak rate and bytes over the peak bandwidth (bwkm_bench.counts.b1, valid centres only), over B1's device time from the profiler."""

from bwkm_bench import counts


#: the span this metric reads, installed around the port's call in a traced run
SPANS = [("repro_torch.kernels.distance_assign", "assign_top2_cuda", "B1", "events")]


def read(rec):
    prof = rec.get("profile")
    if rec["kind"] != "predict" or not prof:
        return None
    t = prof["span_device_s"].get("B1")
    calls = [c for c in rec["calls"].get("B1", []) if c[0] < rec["profile_units"]]
    if not t or not calls:
        return None
    bound = 0.0
    for _, shapes, sizes in calls:
        (n, d), (k, _) = shapes[0], shapes[1]
        bound += counts.bound_s(*counts.b1(n, k, d, sizes[0], sizes[1]))
    return 100.0 * bound / t
