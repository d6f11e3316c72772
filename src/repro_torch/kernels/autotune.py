"""Measured launch-plan autotune with a persisted cache.

Counterpart of ``repro.kernels.autotune`` (its ADR 0008). The analytic plans
of :mod:`repro_torch.roofline.analysis` are the fallback: they need no card
and are what the kernels launch with by default. On the card this module
times a handful of alternative plans at a seam's shape on first use,
persists the winner, and serves it from the cache after that.

Contract:

* Every candidate gives outputs **bit-equal** to the analytic plan's:
  ``assign``, ``d1``, ``d2``, ``sums``, ``counts``, ``err``, ``mind2`` and
  φ. So pruned ≡ dense, streamed ≡ one pass, resume ≡ uninterrupted and a
  fit bit-equal at every world size hold whatever the cache, the card or
  the timing noise. The candidates vary only knobs that leave the order of
  every reduction alone: the scan's candidates per resident chunk (``bk`` /
  ``bl``) and its CTA cap (``ctas``), B1/B2's rows a thread (``bn``), and
  the fold's ring stages and partial cap. Left out on purpose: the fold's
  CTA count (its partials are summed in CTA order), B3's rows per tile (a
  tile whose rows are all inactive skips the scan, so they set ``d1`` and
  ``d2`` of inactive rows) and B5's (each row tile writes one cost partial,
  so they set φ's order).
* Cache key: ``seam|n{bucket}|d|K|dtype|cuda``, where the bucket rounds n up
  to the next power of two; candidates are timed at the bucket's shape. An
  entry records ``torch.cuda.get_device_name()``, and an entry made on
  another device counts as a miss. It stores the winning knobs; a hit
  resolves them into a plan at the caller's n (an in-process dict lookup
  and some arithmetic: no file I/O, no device sync).
* The analytic plan is always the first candidate, so the tuned plan is
  never slower than it on the timed cell; both timings are stored.
* A candidate that the kernel refuses
  (:class:`~repro_torch.kernels.distance_assign.PlanError`) is skipped and
  counted. If the analytic plan itself fails, the call raises.
* With no card, the analytic plan is persisted as ``source="analytic"``.
  Inside a CUDA-graph capture nothing can be timed: the analytic plan is
  returned and not persisted, so a later call can still tune the cell.

Knobs: ``REPRO_AUTOTUNE=0`` disables timing and persistence (pure
analytic); ``REPRO_AUTOTUNE_CACHE`` overrides the cache path (default
``~/.cache/repro_torch/autotune.json``, apart from the reference's). Nothing
else reads the environment.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
from typing import Any, Callable

import torch

from repro_torch.roofline import analysis

__all__ = [
    "blocking",
    "cache_path",
    "candidate_blockings",
    "clear_memo",
    "enabled",
    "n_bucket",
]

_SCHEMA_VERSION = 1

#: seams this module knows how to time, and the plan family each uses
SEAMS = ("assign_update", "assign_update_pruned", "min_sqdist_update")

#: SMs of the H100, the CTA caps' unit where no card says otherwise
_H100_SMS = 132

_memo: dict[str, dict[str, Any]] = {}
_loaded_path: str | None = None
#: plans resolved from the memo's entries, by (key, n): a hit's arithmetic once
_resolved: dict[tuple[str, int], dict[str, Any]] = {}
_device_names: dict[int, str] = {}


def enabled() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0"


def cache_path() -> pathlib.Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro_torch" / "autotune.json"


def clear_memo() -> None:
    """Drop the in-process memo (the file is untouched): the next call
    reloads the cache file as a new process would."""
    global _loaded_path
    _memo.clear()
    _resolved.clear()
    _loaded_path = None


def n_bucket(n: int) -> int:
    """Next power of two >= n (min 1024): the row-count bucket of the key."""
    b = 1024
    while b < n:
        b *= 2
    return b


def _dtype_tag(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def cache_key(seam: str, n: int, d: int, k: int, dtype, backend: str = "cuda") -> str:
    return f"{seam}|n{n_bucket(n)}|d{d}|K{k}|{_dtype_tag(dtype)}|{backend}"


def _device_name() -> str | None:
    """The current card's name (``None`` without one), looked up once per
    device."""
    if not torch.cuda.is_available():
        return None
    i = torch.cuda.current_device()
    name = _device_names.get(i)
    if name is None:
        name = _device_names[i] = torch.cuda.get_device_name(i)
    return name


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _load() -> None:
    """Populate the memo from the cache file once per (process, path)."""
    global _loaded_path
    path = str(cache_path())
    if _loaded_path == path:
        return
    _loaded_path = path
    try:
        raw = json.loads(pathlib.Path(path).read_text())
        if raw.get("version") == _SCHEMA_VERSION:
            _memo.update(raw.get("entries", {}))
    except (OSError, ValueError):
        pass  # missing or corrupt cache: start fresh


def _persist() -> None:
    _resolved.clear()  # an entry was added or replaced
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(
            json.dumps({"version": _SCHEMA_VERSION, "entries": _memo}, indent=1) + "\n"
        )
        tmp.replace(path)
    except OSError:
        pass  # read-only filesystems lose persistence, not correctness


def _plan(seam: str, n: int, d: int, k: int, dtype_bytes: int, knobs: dict) -> dict:
    """The seam's plan at ``n`` rows with ``knobs`` over the analytic one."""
    if seam == "min_sqdist_update":
        plan = analysis.min_sqdist_blocking(d, k, n=n, dtype_bytes=dtype_bytes, **knobs)
    else:
        plan = analysis.assign_update_blocking(
            d, k, n=n, dtype_bytes=dtype_bytes, pruned=seam == "assign_update_pruned", **knobs
        )
    return plan | {"knobs": dict(knobs)}


def _plan_ints(plan: dict) -> tuple:
    fold = plan.get("fold", {})
    return (plan["rows_per_thread"], plan.get("bk", plan.get("bl")), plan["ctas"],
            fold.get("kt"), fold.get("cw"), fold.get("stages"))


def _knob_grid(seam: str, d: int, k: int, ana: dict, sms: int) -> list[dict]:
    """The bit-neutral knobs to try, one family at a time around the
    analytic plan."""
    tile = "bl" if seam == "min_sqdist_update" else "bk"
    grid: list[dict] = []
    if seam == "assign_update" and not ana["wide"]:
        grid += [{"bn": analysis.SCAN_THREADS * r} for r in analysis.ROWS_PER_THREAD]
    if not ana["wide"]:
        kc = ana[tile]
        grid += [{tile: v} for v in (kc // 2 // 4 * 4, kc // 4 // 4 * 4) if 4 <= v < kc]
    grid += [{"ctas": m * sms} for m in (1, 2, 4)]
    if seam != "min_sqdist_update" and ana["fused_ok"]:
        grid += [{"fold_stages": s}
                 for s in range(analysis.FOLD_MIN_STAGES, analysis.FOLD_MAX_STAGES + 1)]
        kd1 = k * (d + 1)
        grid += [{"fold_part_floats": v} for v in (kd1 // 2, kd1 // 4) if v >= 1]
    return grid


def candidate_blockings(
    seam: str, d: int, k: int, *, n: int | None = None, dtype_bytes: int = 4,
    backend: str = "cuda", sms: int = _H100_SMS,
) -> list[dict]:
    """The candidate plans at ``n`` rows (``None``: at least 131,072): the
    analytic plan first, then only bit-neutral knobs (see the module
    docstring), each within the shared-memory budget, no two alike. ``sms``
    is the card's SM count, the unit of the CTA caps."""
    if seam not in SEAMS:
        raise ValueError(f"unknown seam {seam!r}; expected one of {SEAMS}")
    analysis.kernel_budget_bytes(backend)  # raises for another backend
    n = analysis.SCAN_WIDE_N if n is None else n
    ana = _plan(seam, n, d, k, dtype_bytes, {})
    out, seen = [ana], {_plan_ints(ana)}
    for knobs in _knob_grid(seam, d, k, ana, sms):
        try:
            cand = _plan(seam, n, d, k, dtype_bytes, knobs)
        except ValueError:  # the kernel would refuse it
            continue
        key = _plan_ints(cand)
        if key not in seen:
            seen.add(key)
            out.append(cand)
    return out


def _default_measure(
    seam: str, n: int, d: int, k: int, dtype: torch.dtype
) -> Callable[[dict], float]:
    """The timing closure: the seam's kernel on synthetic data of the BUCKET
    shape (a ``torch.Generator`` seeded 0 on the card) at a candidate plan,
    in seconds of device time a call. One warm-up call (it also checks the
    plan), then the calls are captured in a CUDA graph, enough of them for
    about a millisecond, and the best of 3 replays is taken by CUDA events:
    at the representatives' shapes a call takes a few microseconds, less
    than the host needs to launch it, so timing single calls would time the
    host. The data is freed with the closure."""
    from repro_torch.kernels import distance_assign as da
    from repro_torch.kernels import fused_assign_update as fau
    from repro_torch.kernels import min_sqdist_update as msu

    nb = n_bucket(n)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(nb, d, generator=g, device="cuda") * 2).to(dtype)
    c = (torch.randn(k, d, generator=g, device="cuda") * 2).to(dtype)
    w = torch.ones(nb, device="cuda")
    # the uncounted launches: timing runs are not launches of the caller's path
    if seam == "min_sqdist_update":
        valid = torch.ones(k, device="cuda")
        mind2 = torch.full((nb,), 1e30, device="cuda")

        def run(plan):
            return msu.launch_fold(x, w, c, valid, mind2, plan)
    elif not fau.fused_supported(d, k):  # ops runs B1, then the untuned B4
        def run(plan):
            return da.launch_top2(x, c, plan)
    elif seam == "assign_update_pruned":
        cached = torch.zeros(nb, dtype=torch.int32, device="cuda")
        active = torch.ones(nb, dtype=torch.bool, device="cuda")

        def run(plan):
            return fau.launch_pass(x, w, c, cached, active, plan)
    else:
        def run(plan):
            return fau.launch_pass(x, w, c, None, None, plan)

    def measure(plan: dict) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(plan)  # the warm-up, and the plan's check before any capture
        end.record()
        end.synchronize()
        reps = max(1, min(50, math.ceil(1.0 / max(start.elapsed_time(end), 1e-3))))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(reps):
                run(plan)
        best = float("inf")
        for _ in range(3):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / reps)
        del graph
        return best

    return measure


def _resolve(seam, n, d, k, dtype_bytes, entry: dict, source: str) -> dict:
    meta = {key: v for key, v in entry.items() if key != "knobs"}
    return _plan(seam, n, d, k, dtype_bytes, entry["knobs"]) | meta | {"source": source}


def blocking(
    seam: str,
    *,
    n: int,
    d: int,
    k: int,
    dtype: torch.dtype = torch.float32,
    backend: str = "cuda",
    measure: Callable[[dict], float] | None = None,
) -> dict[str, Any]:
    """The plan to launch ``seam`` with at this shape: cached > measured >
    analytic, per the module contract, resolved at ``n`` rows. ``k`` is the
    candidate count L for ``min_sqdist_update``. ``measure(plan) ->
    seconds`` overrides the timing closure (tests inject fakes); the
    default one is built only where a card is present."""
    if seam not in SEAMS:
        raise ValueError(f"unknown seam {seam!r}; expected one of {SEAMS}")
    analysis.kernel_budget_bytes(backend)  # raises for another backend
    dtype_bytes = dtype.itemsize
    if not enabled():
        return _plan(seam, n, d, k, dtype_bytes, {}) | {"source": "analytic"}
    _load()
    key = cache_key(seam, n, d, k, dtype, backend)
    device = _device_name()
    hit = _memo.get(key)
    if hit is not None and hit.get("device") == device:
        plan = _resolved.get((key, n))
        if plan is None:
            plan = _resolved[(key, n)] = _resolve(seam, n, d, k, dtype_bytes, hit, "cache")
        return dict(plan)

    if measure is None:
        if _capturing():  # nothing can be timed now: tune later
            return _plan(seam, n, d, k, dtype_bytes, {}) | {"source": "analytic"}
        if device is None:
            _memo[key] = {"knobs": {}, "source": "analytic", "device": None}
            _persist()
            return _resolve(seam, n, d, k, dtype_bytes, _memo[key], "analytic")
        measure = _default_measure(seam, n, d, k, dtype)
        sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    else:
        sms = _H100_SMS

    from repro_torch.kernels.distance_assign import PlanError

    cands = candidate_blockings(seam, d, k, n=n_bucket(n), dtype_bytes=dtype_bytes,
                                backend=backend, sms=sms)
    analytic_s = measure(cands[0])  # raises if the analytic plan fails
    timed, refused = [(analytic_s, cands[0]["knobs"])], 0
    for cand in cands[1:]:
        try:
            timed.append((measure(cand), cand["knobs"]))
        except PlanError:
            refused += 1
    del measure  # frees the default closure's data
    best_s, best = min(timed, key=lambda t: t[0])
    _memo[key] = {
        "knobs": best,
        "source": "measured",
        "device": device,
        "seconds": best_s,
        "analytic_seconds": analytic_s,
        "speedup_vs_analytic": analytic_s / best_s if best_s > 0 else 1.0,
        "candidates_timed": len(timed),
        "candidates_refused": refused,
        "timings": [[knobs, s] for s, knobs in timed],
    }
    _persist()
    return _resolve(seam, n, d, k, dtype_bytes, _memo[key], "measured")
