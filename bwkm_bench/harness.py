"""One run of one cell: set-up, the measured window, the check, one line.

The set-up (every run pays it) builds the kernels if they are missing
(``build/kernels/`` in the checkout; that build is reported as
``compile_s`` and left out of ``setup_s``), points the port's autotune
cache at a fixed file in the checkout, makes the inputs from the seed and
warms up the shapes of the cell. The window then drives units (fits,
passes, batches) in a closed loop until ``--seconds`` have passed; the unit
in flight when they pass ends the window. A traffic with ``rate_per_s`` is
an open loop instead: unit ``i`` is due ``i / rate`` after the window
opens, is timed from then, and every unit due inside the window is served.
After the window the peak memory is read, the reference judges what the
window produced, and the process is searched for JAX. With ``--trace 1``
the spans that the cell's per-layer metrics declare are on for the whole
window, the first ``profile_units`` units run under ``torch.profiler`` and
the next one under ``torch.cuda.set_sync_debug_mode``; the line then
carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import sys
import time
import traceback

from bwkm_bench import spec

__all__ = ["FORBIDDEN", "forbidden_modules", "main", "run_local", "result_line"]

#: top-level module names no run may load (the JAX package is ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

CACHE = spec.ROOT / "build" / "bwkm_bench"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def prepare_environment() -> None:
    """Caches at fixed paths inside the checkout; the port on ``sys.path``."""
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(CACHE / "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    src = str(spec.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(cell, loop, device, seconds: float, trace: bool) -> dict:
    """Drive ``loop`` for ``seconds``; the record the metric readers read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from bwkm_bench import trace as tr

    rec: dict = {"unit_s": [], "failed": 0, "syncs": None, "profile": None,
                 "profile_units": 0, "spans": {}, "calls": {}}
    profile_units = int(cell.traffic.get("profile_units", 0))
    rate = cell.traffic.get("rate_per_s")
    due_units = math.ceil(seconds * float(rate)) if rate else None
    spans = tr.Spans(device, spec.spans(cell.metrics(True))) if trace else contextlib.nullcontext()
    cuda = device.type == "cuda"
    prof = seg = None
    with loop.capture(), spans:
        if trace and profile_units:  # started before the window opens: its start is not a wait
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
            seg = record_function("bench:segment")
            seg.__enter__()
        t_w0 = time.perf_counter()
        i = 0
        while True:
            prepared = loop.prepare(i)
            t = time.perf_counter()
            if rate:  # an open loop: wait for the unit's arrival, time it from then
                due = t_w0 + i / float(rate)
                if due > t:
                    with record_function("bench:arrival_wait") if seg else contextlib.nullcontext():
                        time.sleep(due - t)
                t = due
            try:
                if trace and cuda and i == profile_units:
                    rec["syncs"] = tr.count_syncs(lambda: loop.unit(i, prepared))[1]
                else:
                    loop.unit(i, prepared)
                _sync(device)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                rec["failed"] += 1
                break
            finally:
                if seg is not None and (i == profile_units - 1 or rec["failed"]):
                    seg.__exit__(None, None, None)
                    prof.stop()
                    seg = None
                    rec["profile_units"] = i + 1
            rec["unit_s"].append(time.perf_counter() - t)
            if trace:
                spans.unit()
            loop.after(i)
            i += 1
            elapsed = time.perf_counter() - t_w0
            if due_units is not None:  # every unit due inside the window is served
                go_on = i < due_units
            elif hasattr(loop, "go_on"):  # ranks close the window on rank 0's clock
                go_on = loop.go_on(elapsed, seconds)
            else:
                go_on = elapsed < seconds
            if not go_on:
                break
        _sync(device)
        rec["window_s"] = time.perf_counter() - t_w0
        if seg is not None:  # the window ended inside the profiled units
            seg.__exit__(None, None, None)
            prof.stop()
            rec["profile_units"] = i
    rec["attempted"] = len(rec["unit_s"]) + rec["failed"]
    rec["units"] = len(rec["unit_s"])
    if trace:
        rec["spans"], rec["calls"] = spans.totals, spans.calls
    if prof is not None:
        rec["profile"] = tr.summarize(prof, "bench:segment")
    return rec


def run_local(cell, *, seed: int, seconds: float, trace: bool, device, t0: float,
              with_control: bool = False):
    """Set up, run the window and judge, in this process. Returns
    ``(record, numbers, memory_peak_bytes)``; ``with_control`` adds the
    control's numbers on the same inputs as ``record["control"]``."""
    import torch

    rec: dict = {"kind": cell.traffic["kind"], "compile_s": 0.0}
    if device.type == "cuda":
        from repro_torch.kernels import _build

        tb = time.perf_counter()
        built = _build.build_all()
        rec["compile_s"] = time.perf_counter() - tb if built else 0.0
    loop = spec.loop_class(cell.traffic["kind"])(cell, seed, device)
    loop.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    loop.warm()
    _sync(device)
    # what set-up left on the heap is not scanned again by the window's collections
    gc.collect()
    gc.freeze()
    rec["setup_s"] = time.perf_counter() - t0 - rec["compile_s"]
    rec.update(window(cell, loop, device, seconds, trace))
    rec["rows_per_unit"] = loop.rows_per_unit
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    loop.release()
    t_check = time.perf_counter()
    numbers = loop.judge() if rec["units"] else {}
    rec["check_s"] = time.perf_counter() - t_check
    if with_control and rec["units"]:
        rec["control"] = loop.control()
    # after the judge and the control, so that what they load is seen too
    rec["forbidden"] = forbidden_modules()
    return rec, numbers, peak


def result_line(cell, rec: dict, numbers: dict, *, trace: bool, device_info: dict) -> dict:
    """The run's last line: metrics read from ``rec``, ``correct`` from the
    numbers against their limits (``checks`` comes last)."""
    metrics = {}
    for m in cell.metrics(trace):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {}
    for name, value in sorted(numbers.items()):
        if name not in cell.limits:
            raise KeyError(f"{cell.name}: no limit for {name!r} in limits/{cell.name}.json")
        checks[name] = {"value": value, "limit": cell.limits[name]}
    correct = (rec["failed"] == 0 and rec["units"] > 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    line = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
            "metrics": metrics, "device": device_info,
            "compile_s": rec["compile_s"], "check_s": rec.get("check_s")}
    prof = rec.get("profile")
    if trace and prof is not None:
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["checks"] = checks
    return line


def main(args, t0: float) -> int:
    prepare_environment()
    import torch

    torch.set_num_threads(1)

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bwkm_bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.traffic["kind"] == "dist_fit":
        from bwkm_bench.loops import dist_fit

        rec, numbers, peak = dist_fit.run(cell, seed=args.seed, seconds=args.seconds,
                                          trace=bool(args.trace), t0=t0)
    else:
        device = torch.device("cuda", 0)
        rec, numbers, peak = run_local(cell, seed=args.seed, seconds=args.seconds,
                                       trace=bool(args.trace), device=device, t0=t0)
    found = sorted(set(rec["forbidden"]) | set(forbidden_modules()))
    if found:
        print(f"bwkm_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "memory_peak_bytes": int(peak)}
    line = result_line(cell, rec, numbers, trace=bool(args.trace), device_info=info)
    ms = sorted(t * 1e3 for t in rec["unit_s"])
    if ms:
        print(f"units {len(ms)} in {rec['window_s']:.3f} s; ms min {ms[0]:.2f} median "
              f"{ms[len(ms) // 2]:.2f} max {ms[-1]:.2f}; in order: "
              + " ".join(f"{t * 1e3:.1f}" for t in rec["unit_s"][:400]), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0
