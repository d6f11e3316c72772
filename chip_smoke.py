#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BWKM on one NVIDIA GPU and check it.

Run from the root of the repository:

    python3 chip_smoke.py            # the check; needs one CUDA device
    python3 chip_smoke.py --profile DIR  # and a torch.profiler breakdown of
                                         # the fit, its full table in DIR

Phases, one line each (and a few detail lines), any failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc each,
   in parallel) and print the build seconds;
2. hold each kernel (B1 assign_top2, B2 fused assign+update, B3 its pruned
   form) against its plain PyTorch version on the card, in f32 and bf16, at
   the main path's shapes and at the edges (ragged n, K = 1, K > one tile,
   zero weights, B3 with no and with every row active);
3. pruned ≡ dense bit for bit, two B2 runs bit-equal, two ``block_stats``
   runs over the full dataset bit-equal;
4. ``repro_torch.BWKM(k=27).fit`` on the SUSY-profile 5,000,000 × 19 array,
   then ``predict`` and ``score`` over all of it and ``transform`` over one
   chunk, with the kernels' launch counts (each must be > 0) and ``score``
   held against a float64 computation;
5. per-kernel times from CUDA events over CUDA-graph replays, beside the
   plain version, one PyTorch yardstick and the card's bound.

Then the card's name and power limit, one JSON line of kernel records, and
the result line ``{"ok": true, "device": {...}}`` last. Without a CUDA
device, or without the rest of the repository beside it, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOP_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}
SUSY_K = 27
CAPACITY_REPS = 14_528  # BWKMConfig.resolve(5_000_000, 19) capacity at K = 27
CHUNK = 65_536


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- phase 2
def _data(torch, n, d, k, dtype, seed, wmode="uniform"):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n, d, generator=g, device="cuda") * 3).to(dtype)
    c = (torch.randn(k, d, generator=g, device="cuda") * 3).to(dtype)
    u = torch.rand(n, generator=g, device="cuda")
    if wmode == "zeros-some":
        w = torch.where(u < 0.5, 0.0, 1.5)
    else:
        w = u * 3.0
    return x, w, c


def _maxerr(torch, a, b):
    a, b = a.double(), b.double()
    fin = torch.isfinite(b)
    check(bool((torch.isfinite(a) == fin).all()), "finite pattern differs")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def _close(torch, a, b, tol, what, scale=None):
    """|a − b| <= atol + rtol·max(|b|, scale); ``scale`` is Σ|terms| for a
    sum, whose rounding depends on the order it was taken in. Returns the
    largest absolute and relative (to ``max(|b|, scale)``) differences."""
    err = _maxerr(torch, a, b)
    fin = torch.isfinite(b)
    a, b = a.double()[fin], b.double()[fin]
    mag = b.abs() if scale is None else torch.maximum(b.abs(), scale.double()[fin])
    diff = (a - b).abs()
    check(bool((diff <= tol["atol"] + tol["rtol"] * mag).all()), f"{what}: max abs err {err}")
    rel = float((diff / mag.clamp(min=1e-30)).max()) if diff.numel() else 0.0
    return err, rel


def _abs_sums(torch, ref, x, w, a, k):
    """Σ|w·x| and Σ|w| per cluster: the scale of the sums' rounding."""
    return ref.cluster_sums(x.float().abs(), w.abs(), a, k)


def _labels_ok(torch, ref, x, c, a, tol, what, rows=None):
    dd = ref.pairwise_sqdist(x, c).double()
    idx = torch.arange(x.shape[0], device=x.device)
    if rows is not None:
        dd, idx, a = dd[rows], idx[: int(rows.sum())], a[rows]
    check(bool(torch.isclose(dd[idx, a.long()], dd.min(1).values, **tol).all()),
          f"{what}: labels not at the minimum distance")


def phase_kernels(torch, ref, da, fau):
    # max |kernel − plain| of the per-row distances d1, d2, and the largest
    # relative difference of the statistics (sums, counts, err)
    errs = {(b, dt): 0.0 for b in ("B1", "B2", "B3") for dt in ("float32", "bfloat16")}
    rel = {(b, dt): 0.0 for b in ("B2", "B3") for dt in ("float32", "bfloat16")}
    cases = [  # (n, d, K, wmode)
        (CAPACITY_REPS, 19, SUSY_K, "uniform"),  # the partition's representatives
        (CHUNK, 19, SUSY_K, "uniform"),  # one predict/score chunk
        (1000, 19, SUSY_K, "uniform"),  # n not a multiple of the 128-row CTA
        (777, 19, 1, "uniform"),  # K = 1: d2 = +inf
        (3000, 19, 300, "uniform"),  # K beyond one 32-centroid tile
        (CAPACITY_REPS, 19, SUSY_K, "zeros-some"),  # half the weights zero
    ]
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for i, (n, d, k, wmode) in enumerate(cases):
            x, w, c = _data(torch, n, d, k, dtype, seed=100 + i, wmode=wmode)
            tag = f"{dtype} n={n} K={k} {wmode}"
            # B1
            a, d1, d2 = da.assign_top2_cuda(x, c)
            ra, rd1, rd2 = ref.assign_top2(x, c)
            _labels_ok(torch, ref, x, c, a, tol, f"B1 {tag}")
            errs["B1", dname] = max(errs["B1", dname],
                                    _close(torch, d1, rd1, tol, f"B1 d1 {tag}")[0],
                                    _close(torch, d2, rd2, tol, f"B1 d2 {tag}")[0])
            if k == 1:
                check(bool(torch.isinf(d2).all()), "B1 K=1: d2 must be +inf")
            # B2
            out = fau.fused_assign_update_cuda(x, w, c)
            r = ref.assign_update(x, w, c)
            _labels_ok(torch, ref, x, c, out[0], tol, f"B2 {tag}")
            scale = (None, None, None) + _abs_sums(torch, ref, x, w, r.assign, k)
            e = [_close(torch, out[j], r[j], tol, f"B2 {f} {tag}", scale[j])
                 for j, f in ((1, "d1"), (2, "d2"), (3, "sums"), (4, "counts"))]
            e.append(_close(torch, out[5], r.err, dict(rtol=max(tol["rtol"], 1e-5), atol=0.0),
                            f"B2 err {tag}"))
            errs["B2", dname] = max(errs["B2", dname], e[0][0], e[1][0])
            rel["B2", dname] = max(rel["B2", dname], *(r_ for _, r_ in e[2:]))
            # B3: half active, none active, all active
            g = torch.Generator(device="cuda").manual_seed(7 + i)
            cached = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
            half = torch.rand(n, generator=g, device="cuda") < 0.5
            for mode, act in (("half", half), ("none", torch.zeros_like(half)),
                              ("all", torch.ones_like(half))):
                p = fau.fused_assign_update_pruned_cuda(x, w, c, cached, act)
                rp = ref.assign_update_pruned(x, w, c, cached, act)
                check(bool((p[0][~act] == cached[~act]).all()), f"B3 {mode} {tag}: cached ids")
                if bool(act.any()):
                    _labels_ok(torch, ref, x, c, p[0], tol, f"B3 {mode} {tag}", rows=act)
                    errs["B3", dname] = max(
                        errs["B3", dname],
                        *(_close(torch, p[j][act], rp[j][act], tol, f"B3 {mode} {tag}")[0]
                          for j in (1, 2)))
                scale = (None, None, None) + _abs_sums(torch, ref, x, w, rp.assign, k)
                e = [_close(torch, p[j], rp[j], tol, f"B3 {mode} {tag} stats", scale[j])
                     for j in (3, 4)]
                e.append(_close(torch, p[5], rp.err, dict(rtol=max(tol["rtol"], 1e-5),
                                                          atol=1e-6), f"B3 {mode} {tag} err"))
                rel["B3", dname] = max(rel["B3", dname], *(r_ for _, r_ in e))
                n_checks += 1
            n_checks += 2
    torch.cuda.synchronize()
    return errs, rel, n_checks


# ---------------------------------------------------------------- phase 3
def phase_determinism(torch, fau, partition, x_full):
    x, w, c = _data(torch, CAPACITY_REPS, 19, SUSY_K, torch.float32, seed=3)
    dense = fau.fused_assign_update_cuda(x, w, c)
    again = fau.fused_assign_update_cuda(x, w, c)
    check(all(torch.equal(a, b) for a, b in zip(dense, again)), "two B2 runs differ")
    g = torch.Generator(device="cuda").manual_seed(5)
    for frac in (0.0, 0.1, 1.0):
        act = torch.rand(x.shape[0], generator=g, device="cuda") < frac
        p = fau.fused_assign_update_pruned_cuda(x, w, c, dense[0], act)
        check(torch.equal(p[0], dense[0]), f"pruned ids differ (active {frac})")
        check(torch.equal(p[3], dense[3]) and torch.equal(p[4], dense[4]),
              f"pruned statistics not bit-equal to dense (active {frac})")
    n = x_full.shape[0]
    bids = {
        "one block": torch.zeros(n, dtype=torch.int32, device="cuda"),
        "14528 blocks": torch.randint(0, CAPACITY_REPS, (n,), generator=g, device="cuda",
                                      dtype=torch.int32),
    }
    for name, bid in bids.items():
        s1 = partition.block_stats(x_full, bid, CAPACITY_REPS)
        s2 = partition.block_stats(x_full, bid, CAPACITY_REPS)
        check(all(torch.equal(a, b) for a, b in zip(s1, s2)), f"block_stats ({name}) differs")
        check(float(s1.count.sum()) == n, "block_stats counts do not add up to n")
    torch.cuda.synchronize()


# ---------------------------------------------------------------- phase 4
def _score_f64(torch, x, c):
    c64 = c.double()
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], CHUNK):
        xc = x[i : i + CHUNK].double()
        dd = ((xc[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
        total += dd.min(1).values.sum()
    return float(total)


def _labels_vs_f64(torch, x, c, labels):
    c64 = c.double()
    mism, worst = 0, 0.0
    for i in range(0, x.shape[0], CHUNK):
        xc = x[i : i + CHUNK].double()
        dd = ((xc[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
        mn = dd.min(1).values
        got = dd.gather(1, labels[i : i + CHUNK].long()[:, None])[:, 0]
        gap = (got - mn) / (1.0 + (xc * xc).sum(1))  # f32 rounding scales with ‖x‖²
        mism += int((gap > 0).sum())
        worst = max(worst, float(gap.max()))
    return mism, worst


def phase_fit(torch, repro_torch, da, fau, x):
    counters = (da.assign_top2_cuda, fau.fused_assign_update_cuda,
                fau.fused_assign_update_pruned_cuda)
    for f in counters:
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = repro_torch.BWKM(k=SUSY_K).fit(x)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = model.predict(x)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    score = model.score(x)
    t_score = time.perf_counter() - t0
    dist = model.transform(x[:CHUNK])
    torch.cuda.synchronize()
    launches = {"B1": counters[0].launches, "B2": counters[1].launches,
                "B3": counters[2].launches}
    peak = torch.cuda.max_memory_allocated()
    res = model.result_
    c = model.centroids_
    print(f"[fit] stop_reason={res.stop_reason} iterations={res.iterations} "
          f"distances={res.distances:.0f} blocks={res.metadata['n_blocks'][-1]} "
          f"score={score!r} fit_s={t_fit:.3f} predict_s={t_pred:.3f} score_s={t_score:.3f} "
          f"peak_mem_GiB={peak / 2**30:.3f} launches={launches}")
    print(f"[fit] n_blocks per iteration {res.metadata['n_blocks']}")
    check(tuple(c.shape) == (SUSY_K, x.shape[1]) and bool(torch.isfinite(c).all()),
          "centroids not finite [27, 19]")
    check(labels.shape == (x.shape[0],) and labels.dtype == torch.int32
          and int(labels.min()) >= 0 and int(labels.max()) < SUSY_K, "labels out of range")
    check(dist.shape == (CHUNK, SUSY_K) and bool(torch.isfinite(dist).all()), "transform shape")
    ref_score = _score_f64(torch, x, c)
    check(abs(score - ref_score) <= 1e-4 * abs(ref_score),
          f"score {score} vs float64 {ref_score}")
    mism, worst = _labels_vs_f64(torch, x, c, labels)
    print(f"[fit] score vs float64 rel diff {abs(score - ref_score) / ref_score:.3e}; "
          f"labels off the float64 argmin: {mism} rows, worst relative gap {worst:.3e}")
    check(worst <= 1e-5, "a label is farther than f32 rounding (1e-5·‖x‖²) from the float64 argmin")
    for name, cnt in launches.items():
        check(cnt > 0, f"kernel {name} was not launched on the main path")
    return launches


# ---------------------------------------------------------------- phase 5
def _time_graph(torch, fn, reps=20):
    """Milliseconds per call of ``fn`` replayed from a CUDA graph (so the
    host's launch cost is not measured), after warm-up."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def _bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_times(torch, ref, da, fau):
    d, k = 19, SUSY_K
    out = {}
    # B1 at the predict/score chunk, the shape that carries most of its launches
    x, w, c = _data(torch, CHUNK, d, k, torch.float32, seed=11)
    n = CHUNK
    lib = lambda: torch.topk(torch.cdist(x, c) ** 2, 2, dim=1, largest=False)  # noqa: E731
    fl = n * k * (2 * d + 3)
    out["B1"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32",
        ms=_time_graph(torch, lambda: da.assign_top2_cuda(x, c)),
        plain_ms=_time_graph(torch, lambda: ref.assign_top2(x, c)),
        library_ms=_time_graph(torch, lib),
        bound=_bound(4 * n * d + 4 * k * d + 12 * n, fl),
    )
    # B2/B3 at the partition's representatives
    n = CAPACITY_REPS
    x, w, c = _data(torch, n, d, k, torch.float32, seed=12)

    def lib2():
        dist, idx = torch.topk(torch.cdist(x, c) ** 2, 2, dim=1, largest=False)
        a = idx[:, 0]
        sums = torch.zeros(k, d, device="cuda").index_add_(0, a, x * w[:, None])
        counts = torch.zeros(k, device="cuda").index_add_(0, a, w)
        return sums, counts, (w * dist[:, 0]).sum()

    io2 = 4 * n * d + 4 * n + 4 * k * d + 12 * n + 4 * k * d + 4 * k + 4
    out["B2"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32",
        ms=_time_graph(torch, lambda: fau.fused_assign_update_cuda(x, w, c)),
        plain_ms=_time_graph(torch, lambda: ref.assign_update(x, w, c)),
        library_ms=_time_graph(torch, lib2),
        bound=_bound(io2, n * k * (2 * d + 3) + 2 * n * d),
    )
    g = torch.Generator(device="cuda").manual_seed(13)
    cached = fau.fused_assign_update_cuda(x, w, c)[0]
    act = torch.rand(n, generator=g, device="cuda") < 0.1
    n_act = int(act.sum())
    out["B3"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32, {n_act} rows active",
        ms=_time_graph(torch, lambda: fau.fused_assign_update_pruned_cuda(x, w, c, cached, act)),
        plain_ms=_time_graph(torch, lambda: ref.assign_update_pruned(x, w, c, cached, act)),
        library_ms=None,
        bound=_bound(io2 + 5 * n, n_act * k * (2 * d + 3) + 2 * n * d),
    )
    for name, r in out.items():
        lib_s = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[time] {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib_s} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return out


# ---------------------------------------------------------------- profile
def phase_profile(torch, repro_torch, x, out_dir: pathlib.Path):
    """One profiled SUSY fit with spans around the driver's steps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import init_partition, lloyd, partition

    spans = {
        (partition, "block_stats"): "span:block_stats",
        (partition, "route_split"): "span:route_split",
        (init_partition, "cutting_probabilities_alg4"): "span:algorithm4",
        (init_partition, "starting_partition"): "span:algorithm3",
        (lloyd, "weighted_lloyd"): "span:lloyd_over_reps",
    }
    saved = {}

    def wrap(fn, label):
        def inner(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return inner

    for (mod, name), label in spans.items():
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, wrap(saved[(mod, name)], label))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("span:fit"):
                repro_torch.BWKM(k=SUSY_K).fit(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    from torch.autograd import DeviceType

    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA and not e.key.startswith("span:")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] fit wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms, "
          f"device idle {100 * (1 - busy / (wall * 1e3)):.1f}% of the wall")
    host = {e.key: e for e in avg if e.key.startswith("span:") and e.cpu_time_total > 0}
    dev = {e.key: e for e in avg if e.key.startswith("span:") and e.device_type == DeviceType.CUDA}
    for key, e in sorted(host.items(), key=lambda kv: -kv[1].cpu_time_total):
        d = dev.get(key)
        d_ms = "n/a" if d is None else f"{d.device_time_total / 1e3:.1f} ms"
        print(f"[profile] {key[5:]}: calls {e.count}, host {e.cpu_time_total / 1e3:.1f} ms, "
              f"device range {d_ms}")
    for e in avg:
        if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize", "aten::nonzero"):
            print(f"[profile] host sync {e.key}: calls {e.count}, "
                  f"host {e.cpu_time_total / 1e3:.1f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile] kernel {e.key[:60]}: calls {e.count}, "
              f"{e.self_device_time_total / 1e3:.2f} ms")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "susy_fit_profile.txt").write_text(
        avg.table(sort_by="self_device_time_total", row_limit=60)
    )


# ---------------------------------------------------------------- main
def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.core import partition
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import distance_assign as da
    from repro_torch.kernels import fused_assign_update as fau

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    # phase 1
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s, compiled {sorted(reports)}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    # phase 2
    errs, rel, n_checks = phase_kernels(torch, ref, da, fau)
    print(f"[kernels] B1-B3 match their plain versions in {n_checks} cases "
          "(f32 tol 1e-5, bf16 tol 1e-3); max abs err of d1/d2: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in errs.items())
          + "; max rel err of sums/counts/err: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in rel.items()))
    # phase 4's data, used by phase 3's block_stats check as well
    t0 = time.perf_counter()
    x = torch.from_numpy(paper_dataset("SUSY", seed=0)).cuda()
    print(f"[data] SUSY profile {tuple(x.shape)} on the card in {time.perf_counter() - t0:.1f} s")
    # phase 3
    phase_determinism(torch, fau, partition, x)
    print("[determinism] pruned == dense bit for bit; two B2 runs and two full-n "
          "block_stats runs bit-equal")
    # phase 4
    launches = phase_fit(torch, repro_torch, da, fau, x)
    # phase 5
    times = phase_times(torch, ref, da, fau)
    if "--profile" in argv:
        phase_profile(torch, repro_torch, x, pathlib.Path(argv[argv.index("--profile") + 1]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    sources = {
        "B1": ("assign_top2", "src/repro_torch/kernels/csrc/distance_assign.cu",
               "src/repro/kernels/distance_assign.py:82"),
        "B2": ("fused_assign_update", "src/repro_torch/kernels/csrc/fused_assign_update.cu",
               "src/repro/kernels/fused_assign_update.py:136"),
        "B3": ("fused_assign_update_pruned", "src/repro_torch/kernels/csrc/fused_assign_update.cu",
               "src/repro/kernels/fused_assign_update.py:307"),
    }
    records = []
    for key, (name, source, replaces) in sources.items():
        t = times[key]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": errs[key, "float32"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
