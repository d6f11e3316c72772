"""The benchmark's own instruments: spans around the calls into the port's
layers, synchronizing-call counts and the reduction of a ``torch.profiler``
trace to device busy time, idle gaps and per-kernel totals.

Spans are installed from outside the port, by replacing a module
attribute for the duration of a traced run (the port looks its callees up
by attribute, so the wrapper is what runs), and are restored after it:

* ``host`` — a host clock around the call, synchronised before and after;
* ``events`` — a pair of CUDA events around the call, read after the run.

Each span also opens a ``record_function("span:<name>")`` so the profiler
can tell which layer the host was in during an idle gap. The sync count is
``chip_smoke.py::_sync_calls``'s method: ``torch.cuda.set_sync_debug_mode``
warns at each synchronizing call, and the warnings are counted.
"""

from __future__ import annotations

import contextlib
import functools
import time
import warnings
from typing import Any, Callable

import torch

__all__ = ["Spans", "count_syncs", "patched", "summarize"]


@contextlib.contextmanager
def patched(owner: Any, attr: str, wrap: Callable[[Callable], Callable]):
    """Replace ``owner.attr`` by ``wrap(original)`` inside the block."""
    orig = getattr(owner, attr)
    # keep the original's attributes (a launch counter the port keeps on it)
    setattr(owner, attr, functools.wraps(orig)(wrap(orig)))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


class Spans:
    """Per-unit totals of the named spans: ``totals[name]`` is a list with
    one entry (ms) per unit that :meth:`unit` closed."""

    def __init__(self, device: torch.device, specs):
        self.device = device
        self.specs = specs  # [(owner, attr, name, "host" | "events")]
        self.totals: dict[str, list[float]] = {s[2]: [] for s in specs}
        #: per call: (unit index, shapes of its tensor arguments, their itemsizes)
        self.calls: dict[str, list] = {s[2]: [] for s in specs}
        self._host: dict[str, float] = {}
        self._events: dict[str, list] = {}
        self._stack = contextlib.ExitStack()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap(self, name: str, how: str):
        from torch.profiler import record_function

        def wrap(fn):
            def inner(*a, **kw):
                tensors = [t for t in a if isinstance(t, torch.Tensor)]
                self.calls[name].append((len(self.totals[name]), [tuple(t.shape) for t in tensors],
                                         [t.element_size() for t in tensors]))
                with record_function(f"span:{name}"):
                    if how == "host":
                        self._sync()
                        t0 = time.perf_counter()
                        out = fn(*a, **kw)
                        self._sync()
                        self._host[name] = self._host.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
                        return out
                    if self.device.type != "cuda":
                        return fn(*a, **kw)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = fn(*a, **kw)
                    e1.record()
                    self._events.setdefault(name, []).append((e0, e1))
                    return out
            return inner
        return wrap

    def __enter__(self):
        for owner, attr, name, how in self.specs:
            self._stack.enter_context(patched(owner, attr, self._wrap(name, how)))
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def unit(self) -> None:
        """Close one unit: add up what its spans took."""
        self._sync()
        for _, _, name, how in self.specs:
            if how == "host":
                ms = self._host.pop(name, 0.0)
            else:
                ms = sum(e0.elapsed_time(e1) for e0, e1 in self._events.pop(name, []))
            self.totals[name].append(ms)


def count_syncs(fn: Callable[[], Any]) -> tuple[Any, int]:
    """``(fn(), synchronizing CUDA calls it made)``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _union(intervals):
    """Merged ``[(start, end)]`` of sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, segment: str, *, top: int = 10) -> dict:
    """Reduce a profiler run whose traced work lies inside the
    ``record_function(segment)`` range: the segment's length, the device's
    busy time (the union of every kernel, copy and set on the device), the
    longest idle gaps named by what the host was doing, kernel totals by
    name, and the device time of the kernels launched inside each span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    seg = [e for e in host if e.name() == segment]
    if not seg:
        raise RuntimeError(f"profiler trace has no {segment!r} range")
    t0 = min(e.start_ns() for e in seg)
    t1 = max(e.end_ns() for e in seg)
    # the device's own work: kernels, copies and sets, not the ranges that
    # record_function mirrors onto the device's timeline
    dev = [e for e in events if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
           and not e.name().startswith(("span:", "bench:"))]
    busy = _union([(max(e.start_ns(), t0), min(e.end_ns(), t1)) for e in dev
                   if e.end_ns() > t0 and e.start_ns() < t1])
    busy_ns = sum(e - s for s, e in busy)

    kernels: dict[str, list] = {}
    for e in dev:
        k = kernels.setdefault(e.name(), [0.0, 0])
        k[0] += e.duration_ns() / 1e9
        k[1] += 1

    # the device time launched inside each span, by correlation id
    spans = [e for e in host if e.name().startswith("span:")]
    launch = {e.correlation_id(): e for e in host
              if e.name().startswith("cuda") and e.correlation_id() > 0}
    span_dev: dict[str, float] = {}
    for e in dev:
        la = launch.get(e.correlation_id())
        if la is None:
            continue
        inner = [s for s in spans if s.start_ns() <= la.start_ns() <= s.end_ns()
                 and s.start_thread_id() == la.start_thread_id()]
        if inner:
            name = min(inner, key=lambda s: s.duration_ns()).name()[5:]
            span_dev[name] = span_dev.get(name, 0.0) + e.duration_ns() / 1e9

    # the open loop's waits for a unit's arrival, when nothing is due
    waits = _union([(max(e.start_ns(), t0), min(e.end_ns(), t1)) for e in host
                    if e.name() == "bench:arrival_wait" and e.end_ns() > t0 and e.start_ns() < t1])

    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    idle_gaps = []
    for length, start in gaps:
        mid = start + length // 2
        around = [e for e in host if e.start_ns() <= mid <= e.end_ns() and e.name() != segment]
        spans_here = [e for e in around if e.name().startswith("span:")]
        ops = [e for e in around if not e.name().startswith("span:")]
        what = []
        if spans_here:
            what.append(min(spans_here, key=lambda e: e.duration_ns()).name())
        if ops:
            what.append(min(ops, key=lambda e: e.duration_ns()).name())
        idle_gaps.append([" > ".join(what) or "host outside any op", length / 1e9])

    ops = sorted(([name[:120], v[0]] for name, v in kernels.items()), key=lambda r: -r[1])
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "wait_s": sum(e - s for s, e in waits) / 1e9,
        "kernels": {name: v for name, v in kernels.items()},
        "span_device_s": span_dev,
        "device_ops": ops[:top],
        "idle_gaps": idle_gaps,
    }
