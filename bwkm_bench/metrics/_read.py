"""What the metric readers share: the units of a kind, the steady units of
a traced run, the device's idle share."""

from __future__ import annotations

import statistics


def steady(rec: dict, values: list) -> list:
    """``values`` (one a unit) without the units run under the profiler or
    the sync counter, where any others are left."""
    rest = values[rec["profile_units"] + 1:]
    return rest or values


def span_median(rec: dict, kind: str, span: str):
    """The median over a traced run's steady units of a span's total (ms)."""
    values = rec["spans"].get(span) if rec["kind"] == kind else None
    return statistics.median(steady(rec, values)) if values else None


def idle_pct(rec: dict, kind: str):
    """The share (%) of the profiled segment with nothing on the device,
    leaving out the time an open loop waited for units to arrive."""
    prof = rec.get("profile")
    if rec["kind"] != kind or not prof:
        return None
    serving = prof["window_s"] - prof.get("wait_s", 0.0)
    return 100.0 * (1.0 - prof["busy_s"] / serving) if serving > 0 else None


def per_unit_s(rec: dict, kind: str):
    """Window seconds over the units completed in it."""
    if rec["kind"] != kind or not rec["units"]:
        return None
    return rec["window_s"] / rec["units"]
