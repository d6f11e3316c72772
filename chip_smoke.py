#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of BWKM on one NVIDIA GPU and check it.

Run from the root of the repository:

    python3 chip_smoke.py            # the check; needs one CUDA device
    python3 chip_smoke.py --profile DIR  # and torch.profiler breakdowns of the
                                         # fit and of k-means||, tables in DIR
    python3 chip_smoke.py --parent DIR   # and phase 5 times the kernels built from
                                         # DIR/src/repro_torch/kernels/csrc (an
                                         # earlier commit, same C interface) in
                                         # turns with these: parent, this, this,
                                         # parent; then the fit's and k-means||'s
                                         # walls with DIR's package and this one,
                                         # a process each, in the same turns

Phases, one line each (and a few detail lines), any failure exits non-zero:

1. build the four CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
   (one nvcc each, in parallel; with ``--parent``, the parent's four as well)
   and print the build seconds and each kernel's registers and spills;
2. hold each kernel (B1 assign_top2, B2 fused assign+update, B3 its pruned
   form, B4 cluster_sums, B5 the k-means|| min-d² fold) against its plain
   PyTorch version on the card, in f32 and bf16, at the main paths' shapes
   and at the edges (ragged n, K = 1, K > one tile, zero weights, B3 with no
   and with every row active, the k-means|| weighting passes' 561 and 2,001
   candidates with about half parked far away, empty clusters, invalid
   candidates, first and later folds), and at rows of 14,433 and 41,000
   features (the scan's wide-row form; B4's fold over two column chunks;
   B2/B3 at K = 1);
3. pruned ≡ dense bit for bit at 0 / 10 / 100 % active (fused at the
   representatives and over all 5,000,000 rows at the K = 27 weighting
   pass's 561 candidates and at K = 800, the widest the fused seam takes;
   two-pass where K·(d+1) > 16,384), two B2 runs bit-equal at each of those
   shapes, two B1, B4 and B5 runs and two ``block_stats`` runs over the full
   dataset bit-equal, and B5 over 400 slots of which about half are valid
   bit-equal to B5 over the valid ones alone;
4. ``repro_torch.BWKM(k=27).fit`` on the SUSY-profile 5,000,000 × 19 array,
   then ``predict`` and ``score`` over all of it and ``transform`` over one
   chunk, with the kernels' launch counts (each must be > 0) and ``score``
   held against a float64 computation; then k-means|| seeding on the same
   array — ``kmeans_parallel`` at K = 27 (weighting pass through B2) and
   K = 100 (2,001 candidates: B1 + B4), each with its B5 launches, its
   weighting counts, its weighting sums against float64, its weighting
   labels and d1 against the plain distances over every row, and each of
   its B5 folds against the plain fold over every row — and
   ``BWKM(k=27, init="kmeans||").fit`` with its score against float64 and
   its six B5 folds over the representatives (min-d² against the plain
   fold; the kernel's and the plain fold's costs against the float64 fold,
   and the kernel's against the weighted sum of its own min-d²); each score
   is printed beside the plain version's on the same centroids (and the
   first, with ``--parent``, beside the parent's kernel's);
5. per-kernel times from CUDA events over CUDA-graph replays, beside the
   plain version, one PyTorch yardstick and the card's bound: each kernel
   at the shape of most of its launches, then B1, B2 and B5 at the
   k-means|| runs' own inputs, with the two-pass route (B1 + B4) beside B2
   at 561 candidates and B2's scratch bytes there, then B5's other eight
   launches of phase 4 (the two seed folds at L = 1 over every row and the
   six folds over the 14,528 representatives), each with its bound and its
   library time, B4's fold and its reduction launched alone, every kernel
   at the wide rows of phase 2 beside its plain version, and the SM clock
   and power draw that ``nvidia-smi`` reads while B1 at 2,001 candidates
   and B5 at 112 run back to back. With ``--parent``, every row (and the
   two-pass route) also times the parent's kernel on the same inputs, in
   turns; B4 at K = 2,001 and B2 at 561 candidates over all 5,000,000 rows
   must be bit-equal to the parent's kernels (sums, counts, err); and the
   walls of the SUSY fit and of k-means|| at K = 27 and K = 100 are taken
   with the parent's package and with this one, each in a process of its
   own (parent, this, this, parent; three timed runs each).

Then the card's name and power limit, one JSON line of kernel records, and
the result line ``{"ok": true, "device": {...}}`` last. Without a CUDA
device, or without the rest of the repository beside it, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOP_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}
BIG = 3.0e38  # the masked-distance sentinel of the kernels
SUSY_K = 27
CAPACITY_REPS = 14_528  # BWKMConfig.resolve(5_000_000, 19) capacity at K = 27
CHUNK = 65_536


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- phase 2
def _data(torch, n, d, k, dtype, seed, wmode="uniform", far=None):
    """Random rows, weights and centroids; with ``far``, about half the
    centroids (never the first) sit at that value, as k-means|| parks the
    weighting pass's unfilled candidate slots."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n, d, generator=g, device="cuda") * 3).to(dtype)
    c = (torch.randn(k, d, generator=g, device="cuda") * 3).to(dtype)
    u = torch.rand(n, generator=g, device="cuda")
    if wmode == "zeros-some":
        w = torch.where(u < 0.5, 0.0, 1.5)
    else:
        w = u * 3.0
    if far is not None:
        park = torch.rand(k, generator=g, device="cuda") < 0.5
        park[0] = False
        c[park] = far
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


def phase_kernels(torch, ref, da, fau, far):
    # max |kernel − plain| of the per-row distances d1, d2, and the largest
    # relative difference of the statistics (sums, counts, err)
    errs = {(b, dt): 0.0 for b in ("B1", "B2", "B3") for dt in ("float32", "bfloat16")}
    rel = {(b, dt): 0.0 for b in ("B2", "B3") for dt in ("float32", "bfloat16")}
    cases = [  # (n, d, K, wmode, about half the centroids parked at ``far``)
        (CAPACITY_REPS, 19, SUSY_K, "uniform", False),  # the partition's representatives
        (CHUNK, 19, SUSY_K, "uniform", False),  # one predict/score chunk
        (1000, 19, SUSY_K, "uniform", False),  # n not a multiple of the 128-row CTA
        (777, 19, 1, "uniform", False),  # K = 1: d2 = +inf
        (3000, 19, 300, "uniform", False),  # K beyond one 32-centroid tile
        (CAPACITY_REPS, 19, SUSY_K, "zeros-some", False),  # half the weights zero
        # the k-means|| weighting passes' candidate sets: K = 27's 561 (B2,
        # over a chunk of rows and over the representatives) and K = 100's
        # 2,001 (beyond the fused limit: B1 only here, B4 below)
        (CHUNK, 19, 561, "uniform", True),
        (CAPACITY_REPS, 19, 561, "uniform", True),
        (CHUNK, 19, 2001, "uniform", True),
    ]
    n_checks = ties = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for i, (n, d, k, wmode, parked) in enumerate(cases):
            x, w, c = _data(torch, n, d, k, dtype, seed=100 + i, wmode=wmode,
                            far=far if parked else None)
            tag = f"{dtype} n={n} K={k} {wmode}" + (" half parked" if parked else "")
            # B1
            a, d1, d2 = da.assign_top2_cuda(x, c)
            ra, rd1, rd2 = ref.assign_top2(x, c)
            _labels_ok(torch, ref, x, c, a, tol, f"B1 {tag}")
            errs["B1", dname] = max(errs["B1", dname],
                                    _close(torch, d1, rd1, tol, f"B1 d1 {tag}")[0],
                                    _close(torch, d2, rd2, tol, f"B1 d2 {tag}")[0])
            if k == 1:
                check(bool(torch.isinf(d2).all()), "B1 K=1: d2 must be +inf")
            n_checks += 1
            if not fau.fused_supported(d, k):
                continue
            # B2; its statistics against the plain sums under its own labels,
            # once those are checked at the minimum, so a legal near-tie (a
            # row the plain version puts in the other of two equally close
            # clusters) cannot move a row between the two sides
            out = fau.fused_assign_update_cuda(x, w, c)
            r = ref.assign_update(x, w, c)
            _labels_ok(torch, ref, x, c, out[0], tol, f"B2 {tag}")
            ties = max(ties, int((out[0] != r.assign).sum()))
            sums, counts = ref.cluster_sums(x, w, out[0], k)
            r = r._replace(sums=sums, counts=counts)
            scale = (None, None, None) + _abs_sums(torch, ref, x, w, out[0], k)
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
                ties = max(ties, int((p[0] != rp.assign).sum()))
                stats = ref.cluster_sums(x, w, p[0], k)
                scale = _abs_sums(torch, ref, x, w, p[0], k)
                e = [_close(torch, p[j], stats[j - 3], tol, f"B3 {mode} {tag} stats",
                            scale[j - 3]) for j in (3, 4)]
                e.append(_close(torch, p[5], rp.err, dict(rtol=max(tol["rtol"], 1e-5),
                                                          atol=1e-6), f"B3 {mode} {tag} err"))
                rel["B3", dname] = max(rel["B3", dname], *(r_ for _, r_ in e))
                n_checks += 1
            n_checks += 1
    torch.cuda.synchronize()
    return errs, rel, n_checks, ties


def _fold_case(torch, n, d, l, dtype, seed, first, from_rows):
    """B5 inputs: candidates (rows of x, or random) with about 30 % invalid
    (the first always valid), and ``mind2`` = BIG on a first fold."""
    x, w, cand = _data(torch, n, d, l, dtype, seed=seed, wmode="zeros-some")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    if from_rows:
        cand = x[torch.randint(0, n, (l,), generator=g, device="cuda")]
    cvalid = (torch.rand(l, generator=g, device="cuda") > 0.3).float()
    cvalid[0] = 1.0
    mind2 = (torch.full((n,), BIG, device="cuda") if first
             else torch.rand(n, generator=g, device="cuda") * 300)
    return x, w, cand, cvalid, mind2


def phase_kernels_b45(torch, ref, cu, msu):
    """B4 and B5 against their plain versions (n <= 65,536: the plain
    cluster_sums is a dense [n, K] one-hot). Returns the largest absolute
    errors of B5's min-d² and B4's sums and the largest relative errors of
    B5's cost and B4's sums/counts (to Σ|terms|)."""
    errs = {(b, dt): 0.0 for b in ("B4", "B5") for dt in ("float32", "bfloat16")}
    rel = dict(errs)
    folds = [  # (n, d, L, first fold, candidates from the rows of x)
        (CHUNK, 19, 112, True, True),  # a round's batch, first fold
        (CHUNK - 51, 19, 400, False, True),  # K = 100's batch, a later fold, ragged n
        (1000, 19, 1, True, True),  # the seed fold
        (5000, 19, 112, False, False),
        (3000, 40, 70, True, False),  # d over one 32-feature chunk, L not a tile multiple
    ]
    sums_cases = [  # (n, d, K, wmode)
        (CHUNK, 19, 2001, "uniform"),  # the K = 100 weighting pass's width
        (CHUNK - 51, 19, 27, "zeros-some"),
        (777, 19, 1, "uniform"),
        (1000, 19, 2001, "zeros-some"),  # most clusters empty
        (3000, 40, 70, "uniform"),
        (20_000, 19, 4000, "uniform"),  # K·(d+1) over one shared partial
    ]
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for i, (n, d, l, first, from_rows) in enumerate(folds):
            x, w, cand, cvalid, mind2 = _fold_case(torch, n, d, l, dtype, 200 + i, first, from_rows)
            tag = f"B5 {dtype} n={n} L={l} first={first} rows={from_rows}"
            new, cost = msu.min_sqdist_update_cuda(x, w, cand, cvalid, mind2)
            r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
            # f32 rounding of ‖x‖² − 2x·c + ‖c‖² scales with ‖x‖² + ‖c‖²
            scale = (x.float() ** 2).sum(1) + (cand.float() ** 2).sum(1).max()
            errs["B5", dname] = max(errs["B5", dname],
                                    _close(torch, new, r.mind2, tol, tag, scale)[0])
            rel["B5", dname] = max(rel["B5", dname], _close(
                torch, cost, r.cost, dict(rtol=max(tol["rtol"], 1e-5), atol=0.0), f"{tag} cost")[1])
            check(bool((new <= mind2).all()), f"{tag}: the fold raised a min-d²")
            n_checks += 1
        for i, (n, d, k, wmode) in enumerate(sums_cases):
            x, w, _ = _data(torch, n, d, 1, dtype, seed=300 + i, wmode=wmode)
            g = torch.Generator(device="cuda").manual_seed(300 + i)
            a = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
            tag = f"B4 {dtype} n={n} K={k} {wmode}"
            sums, counts = cu.cluster_sums_cuda(x, w, a, k)
            rs, rc = ref.cluster_sums(x, w, a, k)
            ss, sc = _abs_sums(torch, ref, x, w, a, k)
            e = _close(torch, sums, rs, tol, f"{tag} sums", ss)
            errs["B4", dname] = max(errs["B4", dname], e[0])
            rel["B4", dname] = max(rel["B4", dname], e[1],
                                   _close(torch, counts, rc, tol, f"{tag} counts", sc)[1])
            check(bool((counts[torch.bincount(a.long(), minlength=k) == 0] == 0).all()),
                  f"{tag}: an empty cluster has a count")
            n_checks += 1
    torch.cuda.synchronize()
    return errs, rel, n_checks


WIDE_D = (14_433, 41_000)  # past the scan's four resident candidates, past B4's d + 1 = 40,960


def _wide_case(torch, d, seed, n=300, k=5):
    """Rows of ``d`` features: x, w (half zero), K candidates, random ids."""
    x, w, c = _data(torch, n, d, k, torch.float32, seed=seed, wmode="zeros-some")
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
    return x, w, c, ids


def phase_kernels_wide(torch, ref, da, fau, cu, msu):
    """B1, B4 and B5 at d = 14,433 and 41,000 (the scan's wide-row form, and
    B4's fold over two column chunks at 41,000), B2 and B3 at 14,433 with
    K = 1 (their fused partial K·(d + 1) <= 16,384 stays), each against its
    plain version within the f32 tolerance (sums relative to Σ|terms|).
    Returns the largest absolute error per kernel."""
    tol = TOL["float32"]
    errs = dict.fromkeys(("B1", "B2", "B3", "B4", "B5"), 0.0)
    for i, d in enumerate(WIDE_D):
        x, w, c, ids = _wide_case(torch, d, seed=400 + i)
        tag = f"d={d}"
        a, d1, d2 = da.assign_top2_cuda(x, c)
        _labels_ok(torch, ref, x, c, a, tol, f"B1 {tag}")
        _, rd1, rd2 = ref.assign_top2(x, c)
        errs["B1"] = max(errs["B1"], _close(torch, d1, rd1, tol, f"B1 d1 {tag}")[0],
                         _close(torch, d2, rd2, tol, f"B1 d2 {tag}")[0])
        sums, counts = cu.cluster_sums_cuda(x, w, ids, c.shape[0])
        rs, rc = ref.cluster_sums(x, w, ids, c.shape[0])
        ss, sc = _abs_sums(torch, ref, x, w, ids, c.shape[0])
        errs["B4"] = max(errs["B4"], _close(torch, sums, rs, tol, f"B4 sums {tag}", ss)[0],
                         _close(torch, counts, rc, tol, f"B4 counts {tag}", sc)[0])
        cvalid = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0], device="cuda")
        mind2 = torch.full((x.shape[0],), BIG, device="cuda")
        new, cost = msu.min_sqdist_update_cuda(x, w, c, cvalid, mind2)
        r = ref.min_sqdist_update(x, w, c, cvalid, mind2)
        errs["B5"] = max(errs["B5"], _close(torch, new, r.mind2, tol, f"B5 {tag}")[0])
        _close(torch, cost, r.cost, dict(rtol=1e-5, atol=0.0), f"B5 cost {tag}")
        if not fau.fused_supported(d, 1):  # K·(d + 1) past the fused partial even at K = 1
            continue
        c1 = c[:1].contiguous()
        out = fau.fused_assign_update_cuda(x, w, c1)
        r = ref.assign_update(x, w, c1)
        check(bool((out[0] == 0).all()) and bool(torch.isinf(out[2]).all()), f"B2 {tag} K=1")
        scale = (None,) * 3 + _abs_sums(torch, ref, x, w, out[0], 1)
        errs["B2"] = max(errs["B2"], _close(torch, out[1], r.d1, tol, f"B2 d1 {tag}")[0],
                         *(_close(torch, out[j], r[j], tol, f"B2 {tag}", scale[j])[0]
                           for j in (3, 4)))
        _close(torch, out[5], r.err, dict(rtol=1e-5, atol=0.0), f"B2 err {tag}")
        act = torch.rand(x.shape[0], generator=torch.Generator(device="cuda").manual_seed(9),
                         device="cuda") < 0.5
        p = fau.fused_assign_update_pruned_cuda(x, w, c1, out[0], act)
        check(torch.equal(p[3], out[3]) and torch.equal(p[4], out[4]),
              f"B3 {tag}: pruned statistics not bit-equal to dense")
        errs["B3"] = max(errs["B3"], _close(torch, p[1][act], r.d1[act], tol, f"B3 d1 {tag}")[0])
        _close(torch, p[5], (w * r.d1)[act].sum(), dict(rtol=1e-5, atol=0.0), f"B3 err {tag}")
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------- phase 3
def _fused_bit_checks(torch, fau, x, w, c, g, what):
    """Two B2 runs bit-equal, and B3 at 0 / 10 / 100 % active, given the
    dense ids as its cached ids, bit-equal to the dense statistics."""
    dense = fau.fused_assign_update_cuda(x, w, c)
    again = fau.fused_assign_update_cuda(x, w, c)
    check(all(torch.equal(a, b) for a, b in zip(dense, again)), f"two B2 runs differ ({what})")
    del again
    for frac in (0.0, 0.1, 1.0):
        act = torch.rand(x.shape[0], generator=g, device="cuda") < frac
        p = fau.fused_assign_update_pruned_cuda(x, w, c, dense[0], act)
        check(torch.equal(p[0], dense[0]), f"pruned ids differ ({what}, active {frac})")
        check(torch.equal(p[3], dense[3]) and torch.equal(p[4], dense[4]),
              f"pruned statistics not bit-equal to dense ({what}, active {frac})")
        del p


def phase_determinism(torch, ops, da, fau, cu, msu, partition, x_full, far):
    x, w, c = _data(torch, CAPACITY_REPS, 19, SUSY_K, torch.float32, seed=3)
    g = torch.Generator(device="cuda").manual_seed(5)
    _fused_bit_checks(torch, fau, x, w, c, g, "representatives, K = 27")
    # the fused pass over every row: the K = 27 weighting pass's 561
    # candidates (rows of x, about half parked as k-means|| parks its unfilled
    # slots), and the widest K the fused seam takes at d = 19 (K·(d+1) =
    # 16,000, a 64 KB shared partial), unit weights as the weighting pass has
    n = x_full.shape[0]
    ones = torch.ones(n, device="cuda")
    for k, parked in ((561, True), (800, False)):
        check(fau.fused_supported(19, k), f"K = {k} is beyond the fused limit")
        c = x_full[torch.randint(0, n, (k,), generator=g, device="cuda")].clone()
        if parked:
            park = torch.rand(k, generator=g, device="cuda") < 0.5
            park[0] = False
            c[park] = far
        _fused_bit_checks(torch, fau, x_full, ones, c, g, f"all {n} rows, K = {k}")
    # the two-pass regime: K·(d+1) = 18,000 > 16,384, so B1 + B4 on both seams
    c2 = _data(torch, 900, 19, 1, torch.float32, seed=4)[0]  # 900 centroids
    dense = ops.assign_update(x, w, c2)
    for frac in (0.0, 0.1, 1.0):
        act = torch.rand(x.shape[0], generator=g, device="cuda") < frac
        p = ops.assign_update_pruned(x, w, c2, dense.assign, act)
        check(torch.equal(p.assign, dense.assign), f"two-pass pruned ids differ (active {frac})")
        check(torch.equal(p.sums, dense.sums) and torch.equal(p.counts, dense.counts),
              f"two-pass pruned statistics not bit-equal to dense (active {frac})")
    # B4 and B5 at the k-means|| path's full width
    n = x_full.shape[0]
    ones = torch.ones(n, device="cuda")
    a = torch.randint(0, 2001, (n,), generator=g, device="cuda", dtype=torch.int32)
    s1, s2 = cu.cluster_sums_cuda(x_full, ones, a, 2001), cu.cluster_sums_cuda(x_full, ones, a, 2001)
    check(all(torch.equal(u, v) for u, v in zip(s1, s2)), "two B4 runs differ")
    check(float(s1[1].double().sum()) == n, "B4 counts do not add up to n")
    cand = x_full[torch.randint(0, n, (112,), generator=g, device="cuda")]
    cv = torch.ones(112, device="cuda")
    m0 = torch.full((n,), BIG, device="cuda")
    f1, f2 = msu.min_sqdist_update_cuda(x_full, ones, cand, cv, m0), \
        msu.min_sqdist_update_cuda(x_full, ones, cand, cv, m0)
    check(all(torch.equal(u, v) for u, v in zip(f1, f2)), "two B5 runs differ")
    c1 = x_full[torch.randint(0, n, (561,), generator=g, device="cuda")]
    b1 = da.assign_top2_cuda(x_full, c1)
    check(all(torch.equal(u, v) for u, v in zip(b1, da.assign_top2_cuda(x_full, c1))),
          "two B1 runs differ")
    del b1
    # B5 loads only its valid candidates: 400 slots, about half valid, give
    # the bits of the fold over the valid ones alone
    cand = x_full[torch.randint(0, n, (400,), generator=g, device="cuda")]
    cv = (torch.rand(400, generator=g, device="cuda") < 0.5).float()
    cv[0] = 1.0
    sub = cand[cv > 0].contiguous()
    full = msu.min_sqdist_update_cuda(x_full, ones, cand, cv, f1[0])
    only = msu.min_sqdist_update_cuda(x_full, ones, sub, torch.ones(sub.shape[0], device="cuda"),
                                      f1[0])
    check(all(torch.equal(u, v) for u, v in zip(full, only)),
          "B5 over valid and invalid slots differs from B5 over the valid ones")
    del full, only, f1, f2
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


def _score_plain(torch, ref, x, c):
    """``score`` from the plain version's d1 (the f32 decomposition by a
    matrix product), summed in float64 like ``BWKM.score``."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], CHUNK):
        total += ref.assign_top2(x[i : i + CHUNK], c)[1].sum(dtype=torch.float64)
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


def phase_fit(torch, repro_torch, ref, da, fau, x, parent):
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
    plain_score = _score_plain(torch, ref, x, c)
    parent_s = ""
    if parent is not None:
        with parent.active():
            parent_score = model.score(x)
        parent_s = f", the parent's kernel's {(parent_score - ref_score) / ref_score:+.3e}"
    print(f"[fit] score vs float64 {(score - ref_score) / ref_score:+.3e} (the plain version's "
          f"{(plain_score - ref_score) / ref_score:+.3e}{parent_s} on the same centroids); "
          f"labels off the float64 argmin: {mism} rows, worst relative gap {worst:.3e}")
    check(worst <= 1e-5, "a label is farther than f32 rounding (1e-5·‖x‖²) from the float64 argmin")
    for name, cnt in launches.items():
        check(cnt > 0, f"kernel {name} was not launched on the main path")
    return launches


def _weighting_sums_vs_f64(torch, x, au):
    """The weighting pass's sums against float64 sums under the same
    assignment, relative to Σ|w·x| per element (w = 1 here)."""
    a = au.assign.long()
    k = au.sums.shape[0]
    s64 = torch.zeros(k, x.shape[1], dtype=torch.float64, device=x.device)
    abs64 = torch.zeros_like(s64)
    for i in range(0, x.shape[0], 1_000_000):
        xc = x[i : i + 1_000_000].double()
        s64.index_add_(0, a[i : i + 1_000_000], xc)
        abs64.index_add_(0, a[i : i + 1_000_000], xc.abs())
    worst = float(((au.sums.double() - s64).abs() / abs64.clamp(min=1e-30)).max())
    check(worst <= 1e-5, f"weighting sums off float64 by {worst:.3e} of Σ|w·x|")
    return worst


def _weighting_assign_vs_plain(torch, ref, x, c, au, far):
    """The weighting pass's labels and d1 against the plain distances, in row
    chunks (the [n, K] matrix does not fit at once): each label's plain
    distance is the row's plain minimum, and d1 is that distance, both within
    1e-5 of 1 + ‖x‖² + ‖c‖² (the f32 rounding scale of the decomposition).
    No row may go to a parked candidate. Returns the two largest gaps."""
    parked = (c == far).all(1)
    check(bool((au.counts[parked] == 0).all()), "a parked candidate drew weight")
    cn = (c.double() ** 2).sum(1)
    gap = d1_err = 0.0
    for i in range(0, x.shape[0], CHUNK):
        xc = x[i : i + CHUNK]
        dd = ref.pairwise_sqdist(xc, c)
        a = au.assign[i : i + CHUNK].long()
        check(int(a.min()) >= 0 and int(a.max()) < c.shape[0], "weighting label out of range")
        got = dd.gather(1, a[:, None])[:, 0].double()
        scale = 1.0 + (xc.double() ** 2).sum(1) + cn[a]
        gap = max(gap, float(((got - dd.min(1).values.double()) / scale).max()))
        d1_err = max(d1_err, float(((au.d1[i : i + CHUNK].double() - got).abs() / scale).max()))
    check(gap <= 1e-5, f"a weighting label is {gap:.3e} of ‖x‖² + ‖c‖² off the plain minimum")
    check(d1_err <= 1e-5, f"weighting d1 is {d1_err:.3e} of ‖x‖² + ‖c‖² off the plain distance")
    return gap, d1_err


def _folds_vs_plain(torch, ref, folds):
    """Each B5 fold of a run against the plain fold on the same inputs, over
    every row: min-d² within 1e-5 of ‖x‖² + max‖c‖² (f32 rounding of the
    decomposition), the cost φ within 1e-5 relative. Returns the largest
    absolute min-d² difference and the largest relative cost difference."""
    worst_m = worst_c = 0.0
    for args, out in folds:
        x, w, cand, cvalid, mind2 = args
        r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
        scale = (x.float() ** 2).sum(1) + (cand.float() ** 2).sum(1).max()
        tag = f"B5 fold n={x.shape[0]} L={cand.shape[0]}"
        worst_m = max(worst_m, _close(torch, out.mind2, r.mind2, TOL["float32"], tag, scale)[0])
        worst_c = max(worst_c, _close(torch, out.cost, r.cost, dict(rtol=1e-5, atol=0.0),
                                      f"{tag} cost")[1])
        del r
    return worst_m, worst_c


def _fold_f64(torch, x, w, cand, cvalid, mind2, rows=2048):
    """The fold in float64 from float64 distances (differences, not the
    ‖x‖² − 2·x·c + ‖c‖² decomposition): ``(min-d², cost)``."""
    c64 = cand.double()[cvalid != 0]
    new = mind2.double().clone()
    for i in range(0, x.shape[0], rows):
        if c64.shape[0]:
            dd = ((x[i : i + rows].double()[:, None, :] - c64[None]) ** 2).sum(-1)
            new[i : i + rows] = torch.minimum(new[i : i + rows], dd.min(1).values)
    return new, float((w.double() * new).sum())


def _weighted_folds_vs_f64(torch, ref, folds):
    """The folds over weighted representatives (the seeded fit's). A
    representative that is a candidate is at distance 0 only up to the f32
    rounding of the decomposition, and its block's weight multiplies that,
    so both the kernel's and the plain fold's costs are held against the
    float64 fold, within what the per-row tolerance of ``_close`` allows:
    1e-5 · Σ w·(1 + max(min-d², ‖x‖² + max‖c‖²)). Besides: min-d² against the plain fold
    (as ``_folds_vs_plain``), and the kernel's cost within 1e-5 relative of
    the float64 sum of its own min-d² (its reduction). Returns the largest
    min-d² difference and, per fold, the kernel's and the plain fold's cost
    relative to the float64 cost and the limit in the same units."""
    worst_m, rows = 0.0, []
    for args, out in folds:
        x, w, cand, cvalid, mind2 = args
        r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
        scale = (x.float() ** 2).sum(1) + (cand.float() ** 2).sum(1).max()
        tag = f"B5 fold n={x.shape[0]} L={cand.shape[0]}"
        worst_m = max(worst_m, _close(torch, out.mind2, r.mind2, TOL["float32"], tag, scale)[0])
        _close(torch, out.cost, (w.double() * out.mind2.double()).sum(),
               dict(rtol=1e-5, atol=0.0), f"{tag} cost against its own min-d²")
        new64, c64 = _fold_f64(torch, x, w, cand, cvalid, mind2)
        limit = 1e-5 * float((w.double() * (1.0 + torch.maximum(new64, scale.double()))).sum())
        for who, cost in (("kernel", float(out.cost)), ("plain", float(r.cost))):
            check(abs(cost - c64) <= limit,
                  f"{tag}: the {who} cost {cost!r} is {abs(cost - c64):.4g} from the float64 "
                  f"cost {c64!r}, past 1e-5·Σ w·(1 + max(min-d², ‖x‖² + max‖c‖²)) = {limit:.4g}")
        rows.append(((float(out.cost) - c64) / c64, (float(r.cost) - c64) / c64, limit / c64))
        del r
    return worst_m, rows


def phase_kmeans_ll(torch, repro_torch, rnd, kmeans_ll, ops, ref, counters, x):
    """k-means|| on the full array at K = 27 and K = 100, then a BWKM fit
    seeded by it. Each run's weighting pass and B5 folds are recorded and,
    after the run, held against their plain versions over every row. Returns
    each kernel's launches summed over the three runs (counts set to 0 just
    before each run and read just after), each K's weighting-pass inputs,
    last fold and seed fold, and the inputs of the seeded fit's folds: the
    shapes phase 5 times."""
    n = x.shape[0]
    total = dict.fromkeys(counters, 0)
    seen = {}
    plain = {"assign_update": ops.assign_update, "min_sqdist_update": ops.min_sqdist_update}

    def spy(name):
        def inner(*a, **kw):
            out = plain[name](*a, **kw)
            seen[name].append((a, out))
            return out
        return inner

    for k in (27, 100):
        seen.update(assign_update=[], min_sqdist_update=[])
        for f in counters.values():
            f.launches = 0
        for name in plain:
            setattr(ops, name, spy(name))
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = kmeans_ll.kmeans_parallel(rnd.key(0), x, None, k, return_info=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for name, fn in plain.items():
                setattr(ops, name, fn)
        peak = torch.cuda.max_memory_allocated()
        launches = {b: f.launches for b, f in counters.items()}
        for b in total:
            total[b] += launches[b]
        (wx, _, wc), au = seen["assign_update"][-1]
        folds = seen["min_sqdist_update"]
        n_cap = au.counts.shape[0]
        check(tuple(out.centroids.shape) == (k, x.shape[1])
              and bool(torch.isfinite(out.centroids).all()), f"K={k}: seeds not finite [{k}, 19]")
        check(launches["B5"] == 6, f"K={k}: B5 launched {launches['B5']} times, not 6")
        check(float(au.counts.double().sum()) == n,
              f"K={k}: weighting counts add up to {float(au.counts.double().sum())}, not {n}")
        worst = _weighting_sums_vs_f64(torch, x, au)
        if k == 100:
            check(n_cap == 2001 and launches["B1"] > 0 and launches["B4"] > 0,
                  "K=100: the 2,001-candidate weighting pass did not take B1 + B4")
        else:
            check(n_cap == 561 and launches["B2"] > 0, "K=27: the weighting pass did not take B2")
        gap, d1_err = _weighting_assign_vs_plain(torch, ref, wx, wc, au, kmeans_ll._FAR)
        fold_m, fold_c = _folds_vs_plain(torch, ref, folds)
        print(f"[kmeans||] K={k}: wall_s={wall:.3f} candidates={float(out.n_candidates):.0f} "
              f"of {n_cap} distances={float(out.distances):.0f} passes={out.passes} "
              f"peak_mem_GiB={peak / 2**30:.3f} launches={launches} "
              f"weighting sums vs float64 {worst:.3e} of Σ|w·x|")
        print(f"[kmeans||] K={k}: weighting labels vs plain: largest gap {gap:.3e}, d1 "
              f"{d1_err:.3e} of 1 + ‖x‖² + ‖c‖²; {len(folds)} folds at L = "
              f"{[int(a[2].shape[0]) for a, _ in folds]} vs plain over all {n} rows: "
              f"min-d² max abs err {fold_m:.3g}, cost max rel err {fold_c:.3g}")
        seen[k] = (wc, folds[-1][0], folds[0][0])
        del folds, au
    seen["min_sqdist_update"] = []
    for f in counters.values():
        f.launches = 0
    ops.min_sqdist_update = spy("min_sqdist_update")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = repro_torch.BWKM(k=SUSY_K, init="kmeans||").fit(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.min_sqdist_update = plain["min_sqdist_update"]
    rep_folds = seen["min_sqdist_update"]
    check(len(rep_folds) == 6, f"BWKM(init='kmeans||'): {len(rep_folds)} folds recorded, not 6")
    launches = {b: f.launches for b, f in counters.items()}
    for b in total:
        total[b] += launches[b]
    check(launches["B5"] == 6, f"BWKM(init='kmeans||'): B5 launched {launches['B5']} times")
    res, c = model.result_, model.centroids_
    score = model.score(x)
    ref_score = _score_f64(torch, x, c)
    check(bool(torch.isfinite(c).all()), "BWKM(init='kmeans||'): centroids not finite")
    check(abs(score - ref_score) <= 1e-4 * abs(ref_score),
          f"BWKM(init='kmeans||'): score {score} vs float64 {ref_score}")
    plain_score = _score_plain(torch, ref, x, c)
    fold_m, fold_rows = _weighted_folds_vs_f64(torch, ref, rep_folds)
    print(f"[kmeans||] BWKM(k={SUSY_K}, init='kmeans||').fit: wall_s={wall:.3f} "
          f"stop_reason={res.stop_reason} iterations={res.iterations} "
          f"distances={res.distances:.0f} blocks={res.metadata['n_blocks'][-1]} score={score!r} "
          f"(vs float64 {(score - ref_score) / ref_score:+.3e}, the plain version's "
          f"{(plain_score - ref_score) / ref_score:+.3e} on the same centroids) "
          f"launches={launches}; its {len(rep_folds)} folds at L = "
          f"{[int(a[2].shape[0]) for a, _ in rep_folds]}: min-d² vs plain max abs err "
          f"{fold_m:.3g}")
    print("[kmeans||] its folds' costs vs the float64 fold (relative; limit "
          "1e-5·Σ w·(1 + max(min-d², ‖x‖² + max‖c‖²)) in the same units): kernel "
          + ", ".join(f"{a:+.3e}" for a, _, _ in fold_rows) + "; plain "
          + ", ".join(f"{b:+.3e}" for _, b, _ in fold_rows) + "; limit "
          + ", ".join(f"{lim:.3e}" for _, _, lim in fold_rows))
    return total, {k: seen[k] for k in (27, 100)}, [a for a, _ in rep_folds]


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


def _clock_under_load(torch, what, fn, seconds=2.0):
    """Print the SM clock and power draw that ``nvidia-smi`` reads every
    50 ms while ``fn`` runs back to back for about ``seconds``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = sorted((float(a), float(b)) for a, b in
                  (line.split(",") for line in out.splitlines() if line.count(",") == 1))
    check(len(rows) >= 5, f"nvidia-smi gave {len(rows)} samples under load")
    mhz = [r[0] for r in rows]
    watts = sorted(r[1] for r in rows)
    print(f"[clock] {what} back to back for {seconds:.0f} s: SM clock median {mhz[len(mhz) // 2]:.0f} "
          f"MHz (min {mhz[0]:.0f}, max {mhz[-1]:.0f}), power draw median "
          f"{watts[len(watts) // 2]:.1f} W over {len(rows)} samples")


def _bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class _Parent:
    """An earlier commit's kernel libraries, built from its sources with the
    same flags. The C interface is the same, so while :meth:`active` the
    port's wrappers launch the parent's kernels."""

    def __init__(self, build, procs):
        self.build, self.procs, self.libs = build, procs, None

    @classmethod
    def start(cls, build, tree):
        csrc = pathlib.Path(tree).resolve() / "src" / "repro_torch" / "kernels" / "csrc"
        check(csrc.is_dir(), f"--parent: {csrc} not found")
        out = ROOT / "build" / "parent-kernels"
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, src in build.SOURCES.items():
            lib = out / f"lib{name}.so"
            procs[name] = (lib, subprocess.Popen(
                [build._nvcc(), *build._NVCC_FLAGS, "-o", str(lib), str(csrc / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        return cls(build, procs)

    def finish(self):
        import ctypes

        self.libs = {}
        for name, (lib, proc) in self.procs.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"the parent's {name} did not build:\n{log}")
            self.libs[name] = ctypes.CDLL(str(lib))

    @contextlib.contextmanager
    def active(self):
        saved = dict(self.build._loaded)
        self.build._loaded.update(self.libs)
        try:
            yield
        finally:
            self.build._loaded.clear()
            self.build._loaded.update(saved)


def _timed(torch, fn, reps, parent):
    """``fn``'s milliseconds from ``_time_graph``; given the parent's
    libraries, in turns with them (parent, this, this, parent) on the same
    inputs."""
    if parent is None:
        return {"ms": _time_graph(torch, fn, reps)}
    with parent.active():
        p1 = _time_graph(torch, fn, reps)
    c1, c2 = _time_graph(torch, fn, reps), _time_graph(torch, fn, reps)
    with parent.active():
        p2 = _time_graph(torch, fn, reps)
    return {"ms": c1, "ms_again": c2, "parent_ms": (p1, p2)}


def _b5_row(torch, ref, msu, args, what, parent, reps=10, plain_reps=10):
    """A B5 record on one fold's own inputs ``(x, w, cand, cvalid, mind2)``.
    Its bound counts the valid candidates' operations."""
    fx, fw, fc, fv, fm = args
    n, d = fx.shape
    l, n_valid = fc.shape[0], int(fv.sum())

    def lib():
        dd = torch.cdist(fx, fc) ** 2
        new = torch.minimum(fm, dd.masked_fill(fv[None, :] == 0, BIG).amin(1))
        return new, (fw * new).sum()

    return dict(
        shape=f"{what}x[{n},{d}] f32, L={l}, {n_valid} valid",
        **_timed(torch, lambda: msu.min_sqdist_update_cuda(fx, fw, fc, fv, fm), reps, parent),
        plain_ms=_time_graph(torch, lambda: ref.min_sqdist_update(fx, fw, fc, fv, fm),
                             reps=plain_reps),
        library_ms=_time_graph(torch, lib, reps=plain_reps),
        bound=_bound(4 * n * d + 12 * n + 4 * l * (d + 1) + 4, n * n_valid * (2 * d + 3)),
    )


def _ms_s(r):
    """``_timed``'s record as text: this commit's times, then the parent's."""
    if "parent_ms" not in r:
        return f"{r['ms']:.4f} ms"
    return (f"{r['ms']:.4f} / {r['ms_again']:.4f} ms, parent {r['parent_ms'][0]:.4f} / "
            f"{r['parent_ms'][1]:.4f} ms")


def _parent_bits(torch, cu, fau, parent, x_full, c561, a2001):
    """This commit's statistics fold against the parent's, bit for bit, over
    every row: B4 at K = 2,001 (the K = 100 weighting pass's width) and B2 at
    the K = 27 weighting pass's 561 candidates (its sums, counts and err, and
    its ids and distances), with unit weights as the weighting passes have
    and with random weights in [0, 3), half of them zero."""
    n = x_full.shape[0]
    g = torch.Generator(device="cuda").manual_seed(17)
    u = torch.rand(n, generator=g, device="cuda")
    weights = {"unit": torch.ones(n, device="cuda"), "random": torch.where(u < 0.5, 0.0, 6 * u)}
    for name, w in weights.items():
        mine = cu.cluster_sums_cuda(x_full, w, a2001, 2001)
        with parent.active():
            theirs = cu.cluster_sums_cuda(x_full, w, a2001, 2001)
        check(all(torch.equal(u_, v_) for u_, v_ in zip(mine, theirs)),
              f"B4 at K = 2001 ({name} weights) differs from the parent's kernel")
        mine = fau.fused_assign_update_cuda(x_full, w, c561)
        with parent.active():
            theirs = fau.fused_assign_update_cuda(x_full, w, c561)
        check(all(torch.equal(u_, v_) for u_, v_ in zip(mine, theirs)),
              f"B2 at K = {c561.shape[0]} ({name} weights) differs from the parent's kernel")
        del mine, theirs
    print(f"[parent] B4 at K = 2001 and B2 at K = {c561.shape[0]} over all {n} rows, with unit "
          "and with random weights: sums, counts, err (and B2's ids, d1, d2) bit-equal to the "
          "parent's kernels")


def _wide_times(torch, ref, da, fau, cu, msu):
    """Each kernel at the wide rows of phase 2 beside its plain version."""
    for i, d in enumerate(WIDE_D):
        x, w, c, ids = _wide_case(torch, d, seed=400 + i)
        k = c.shape[0]
        cv = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0], device="cuda")
        m0 = torch.full((x.shape[0],), BIG, device="cuda")
        rows = [("B1", lambda: da.assign_top2_cuda(x, c), lambda: ref.assign_top2(x, c)),
                ("B4", lambda: cu.cluster_sums_cuda(x, w, ids, k),
                 lambda: ref.cluster_sums(x, w, ids, k)),
                ("B5", lambda: msu.min_sqdist_update_cuda(x, w, c, cv, m0),
                 lambda: ref.min_sqdist_update(x, w, c, cv, m0))]
        if fau.fused_supported(d, 1):
            c1 = c[:1].contiguous()
            act = torch.arange(x.shape[0], device="cuda") % 2 == 0
            rows += [("B2 (K=1)", lambda: fau.fused_assign_update_cuda(x, w, c1),
                      lambda: ref.assign_update(x, w, c1)),
                     ("B3 (K=1, half active)",
                      lambda: fau.fused_assign_update_pruned_cuda(x, w, c1, ids * 0, act),
                      lambda: ref.assign_update_pruned(x, w, c1, ids * 0, act))]
        print(f"[time] wide rows x[{x.shape[0]},{d}] f32, K = {k}: " + "; ".join(
            f"{name} kernel {_time_graph(torch, kern, reps=3):.4f} ms, plain "
            f"{_time_graph(torch, plain, reps=3):.4f} ms" for name, kern, plain in rows))


def phase_times(torch, ref, da, fau, cu, msu, x_full, path, rep_folds, parent):
    """Each kernel at the shape that carries most of its launches (the
    records of the JSON line), then B1, B2 and B5 at the k-means|| path's
    own inputs from phase 4 (``path``: K -> weighting candidates, last
    fold, seed fold) and B5 at the folds over the representatives of the
    seeded fit (``rep_folds``). Where a plain version or a library call does
    not fit at full n (an [n, K] matrix), it is timed on the first 65,536
    rows beside the kernel on the same rows. Given ``parent``, every row but
    B4's times the parent's kernel too, in turns."""
    d, k = 19, SUSY_K
    out = {}
    # B1 at the predict/score chunk, the shape that carries most of its launches
    x, w, c = _data(torch, CHUNK, d, k, torch.float32, seed=11)
    n = CHUNK
    lib = lambda: torch.topk(torch.cdist(x, c) ** 2, 2, dim=1, largest=False)  # noqa: E731
    fl = n * k * (2 * d + 3)
    out["B1"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32",
        **_timed(torch, lambda: da.assign_top2_cuda(x, c), 20, parent),
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
        **_timed(torch, lambda: fau.fused_assign_update_cuda(x, w, c), 20, parent),
        plain_ms=_time_graph(torch, lambda: ref.assign_update(x, w, c)),
        library_ms=_time_graph(torch, lib2),
        bound=_bound(io2, n * k * (2 * d + 3) + 2 * n * d),
    )
    g = torch.Generator(device="cuda").manual_seed(13)
    cached = fau.fused_assign_update_cuda(x, w, c)[0]
    act = torch.rand(n, generator=g, device="cuda") < 0.1
    n_act = int(act.sum())

    def lib3():
        dist, idx = torch.topk(torch.cdist(x, c) ** 2, 2, dim=1, largest=False)
        a = torch.where(act, idx[:, 0], cached.long())
        sums = torch.zeros(k, d, device="cuda").index_add_(0, a, x * w[:, None])
        counts = torch.zeros(k, device="cuda").index_add_(0, a, w)
        return sums, counts, torch.where(act, w * dist[:, 0], 0.0).sum()

    out["B3"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32, {n_act} rows active",
        **_timed(torch, lambda: fau.fused_assign_update_pruned_cuda(x, w, c, cached, act), 20,
                 parent),
        plain_ms=_time_graph(torch, lambda: ref.assign_update_pruned(x, w, c, cached, act)),
        library_ms=_time_graph(torch, lib3),
        bound=_bound(io2 + 5 * n, n_act * k * (2 * d + 3) + 2 * n * d),
    )
    # B4 at the K = 100 weighting pass: every row, 2,001 candidates; its plain
    # version (a dense [n, K] one-hot) is timed on the first 65,536 rows
    n, k = x_full.shape[0], 2001
    ones = torch.ones(n, device="cuda")
    a = torch.randint(0, k, (n,), generator=g, device="cuda", dtype=torch.int32)
    a_long = a.long()

    def lib4():
        sums = torch.zeros(k, d, device="cuda").index_add_(0, a_long, x_full)
        return sums, torch.zeros(k, device="cuda").index_add_(0, a_long, ones)

    out["B4"] = dict(
        shape=f"x[{n},{d}] f32, K={k} (plain on the first {CHUNK} rows)",
        **_timed(torch, lambda: cu.cluster_sums_cuda(x_full, ones, a, k), 10, parent),
        plain_ms=_time_graph(torch, lambda: ref.cluster_sums(
            x_full[:CHUNK], ones[:CHUNK], a[:CHUNK], k), reps=10),
        library_ms=_time_graph(torch, lib4, reps=10),
        bound=_bound(4 * n * d + 8 * n + 4 * k * (d + 1), 2 * n * (d + 1)),
    )
    fold_ms = _time_graph(torch, lambda: cu.cluster_sums_cuda(x_full, ones, a, k, _phases=1),
                          reps=10)
    reduce_ms = _time_graph(torch, lambda: cu.cluster_sums_cuda(x_full, ones, a, k, _phases=2),
                            reps=10)
    print(f"[time] B4 x[{n},{d}] K={k}: the fold {fold_ms:.4f} ms, the reduction of its "
          f"{cu.fold_ctas(n)} partials {reduce_ms:.4f} ms (each launched alone); on the same "
          f"{CHUNK} rows as its plain version: kernel "
          f"{_time_graph(torch, lambda: cu.cluster_sums_cuda(x_full[:CHUNK], ones[:CHUNK], a[:CHUNK], k)):.4f} ms")
    # B5 at a k-means|| round over every row: 112 candidates, all valid
    l = 112
    cand = x_full[torch.randint(0, n, (l,), generator=g, device="cuda")]
    cv = torch.ones(l, device="cuda")
    mind2 = msu.min_sqdist_update_cuda(x_full, ones, x_full[:1], cv[:1],
                                       torch.full((n,), BIG, device="cuda"))[0]
    out["B5"] = _b5_row(torch, ref, msu, (x_full, ones, cand, cv, mind2), "", parent)
    _clock_under_load(torch, "B5 at L = 112",
                      lambda: msu.min_sqdist_update_cuda(x_full, ones, cand, cv, mind2))
    xc, oc = x_full[:CHUNK], ones[:CHUNK]
    # B1 over the K = 100 weighting pass's 2,001 candidates (half parked)
    c = path[100][0]
    k = c.shape[0]
    out["B1@2001"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32 (plain, library and 'kernel on the chunk' on "
              f"the first {CHUNK} rows)",
        **_timed(torch, lambda: da.assign_top2_cuda(x_full, c), 2, parent),
        chunk_ms=_time_graph(torch, lambda: da.assign_top2_cuda(xc, c), reps=5),
        plain_ms=_time_graph(torch, lambda: ref.assign_top2(xc, c), reps=5),
        library_ms=_time_graph(
            torch, lambda: torch.topk(torch.cdist(xc, c) ** 2, 2, dim=1, largest=False), reps=5),
        bound=_bound(4 * n * d + 4 * k * d + 12 * n, n * k * (2 * d + 3)),
    )
    _clock_under_load(torch, "B1@2001", lambda: da.assign_top2_cuda(x_full, c))
    # B2 over the K = 27 weighting pass's 561 candidates, unit weights

    def lib_b2(xx, ww, cc):
        kk = cc.shape[0]
        dist, idx = torch.topk(torch.cdist(xx, cc) ** 2, 2, dim=1, largest=False)
        a = idx[:, 0]
        sums = torch.zeros(kk, d, device="cuda").index_add_(0, a, xx * ww[:, None])
        counts = torch.zeros(kk, device="cuda").index_add_(0, a, ww)
        return sums, counts, (ww * dist[:, 0]).sum()

    c = path[27][0]
    k = c.shape[0]
    out["B2@561"] = dict(
        shape=f"x[{n},{d}] c[{k},{d}] f32 (plain, library and 'kernel on the chunk' on "
              f"the first {CHUNK} rows)",
        **_timed(torch, lambda: fau.fused_assign_update_cuda(x_full, ones, c), 2, parent),
        chunk_ms=_time_graph(torch, lambda: fau.fused_assign_update_cuda(xc, oc, c), reps=5),
        plain_ms=_time_graph(torch, lambda: ref.assign_update(xc, oc, c), reps=5),
        library_ms=_time_graph(torch, lambda: lib_b2(xc, oc, c), reps=5),
        bound=_bound(4 * n * d + 4 * n + 4 * k * d + 12 * n + 4 * k * (d + 1) + 4,
                     n * k * (2 * d + 3) + 2 * n * d),
    )
    # the two-pass route at the same shape, B1 then B4 (what ops.assign_update
    # runs beyond the fused limit), and the fused pass's scratch there
    two = _timed(torch, lambda: cu.cluster_sums_cuda(
        x_full, ones, da.assign_top2_cuda(x_full, c)[0], k), 2, parent)
    a561 = da.assign_top2_cuda(x_full, c)[0]
    b1_ms = _time_graph(torch, lambda: da.assign_top2_cuda(x_full, c), reps=2)
    b4 = _timed(torch, lambda: cu.cluster_sums_cuda(x_full, ones, a561, k), 5, parent)
    print(f"[time] two-pass route B1 + B4 at x[{n},{d}] c[{k},{d}] f32: {_ms_s(two)} "
          f"(B1 alone {b1_ms:.4f} ms, B4 alone under its ids {_ms_s(b4)}; B2 there "
          f"{out['B2@561']['ms']:.4f} ms)")
    if parent is not None:
        _parent_bits(torch, cu, fau, parent, x_full, c, a)
    scratch = 4 * fau.fused_scratch_floats(n, d, k)
    print(f"[scratch] B2 at x[{n},{d}] c[{k},{d}]: {scratch} bytes ({scratch / 1e6:.3f} MB) "
          f"of fold partials, min(128, ceil(n/256))·(K·(d+1)+1) floats")
    # B5 at the K = 100 run's last fold: 400 slots, some invalid, finite min-d²
    out["B5@400"] = _b5_row(torch, ref, msu, path[100][1], "K = 100's last fold: ", parent,
                            plain_reps=2)
    # B5's other eight launches on the path: the two seed folds (L = 1, every
    # row) and the six folds of the seeded fit over the representatives
    for kk in (27, 100):
        out[f"B5 seed K={kk}"] = _b5_row(torch, ref, msu, path[kk][2], f"K = {kk}'s seed fold: ",
                                         parent, plain_reps=2)
    for i, args in enumerate(rep_folds):
        out[f"B5 reps {i}"] = _b5_row(torch, ref, msu, args,
                                      f"BWKM(init='kmeans||') fold {i} over the representatives: ",
                                      parent, reps=20, plain_reps=20)
    _wide_times(torch, ref, da, fau, cu, msu)
    for name, r in out.items():
        lib_s = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        chunk_s = f" (on the chunk {r['chunk_ms']:.4f} ms)" if "chunk_ms" in r else ""
        again_s = f" / {r['ms_again']:.4f}" if "ms_again" in r else ""
        parent_s = (f", parent {r['parent_ms'][0]:.4f} / {r['parent_ms'][1]:.4f} ms"
                    if "parent_ms" in r else "")
        print(f"[time] {name} {r['shape']}: kernel {r['ms']:.4f}{again_s} ms{chunk_s}{parent_s}, "
              f"plain {r['plain_ms']:.4f} ms, library {lib_s} ms, bound {r['bound'][0]:.5f} ms "
              f"({r['bound'][1]})")
    return out


# ---------------------------------------------------------------- walls
def _walls_child(src: str, reps: int) -> int:
    """``--walls SRC REPS``, run by :func:`phase_walls` in a process of its
    own: the SUSY fit and k-means|| at K = 27 and K = 100 with the package
    under SRC (its kernels built first), one untimed round, then ``reps``
    timed ones; their walls as one JSON line."""
    import torch

    sys.path.insert(0, src)
    import repro_torch
    from repro_torch import random as rnd
    from repro_torch.core import kmeans_ll
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build

    _build.build_all()
    x = torch.from_numpy(paper_dataset("SUSY", seed=0)).cuda()
    runs = {
        "fit": lambda: repro_torch.BWKM(k=SUSY_K).fit(x),
        "kmeans|| K=27": lambda: kmeans_ll.kmeans_parallel(rnd.key(0), x, None, 27),
        "kmeans|| K=100": lambda: kmeans_ll.kmeans_parallel(rnd.key(0), x, None, 100),
    }
    walls = {name: [] for name in runs}
    for i in range(reps + 1):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                walls[name].append(time.perf_counter() - t0)
    print(json.dumps(walls))
    return 0


def phase_walls(parent_tree, reps=3):
    """The walls of the SUSY fit and of k-means|| at K = 27 and K = 100
    with the parent's package (its Python and its kernels) and with this
    one, each in a process of its own, in turns: parent, this, this,
    parent, ``reps`` timed runs in each."""
    parent_src = pathlib.Path(parent_tree).resolve() / "src"
    for who, src in (("parent", parent_src), ("this", ROOT / "src"), ("this", ROOT / "src"),
                     ("parent", parent_src)):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--walls", str(src), str(reps)],
            capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"the walls of {who} failed:\n{proc.stderr[-3000:]}")
        walls = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[walls] {who}: " + "; ".join(
            f"{name} " + " / ".join(f"{v:.4f}" for v in vs) + " s" for name, vs in walls.items()))


# ---------------------------------------------------------------- profile
def _profile_run(torch, label, fn, spans, out_file: pathlib.Path):
    """Run ``fn`` once under ``torch.profiler`` with ``record_function``
    spans around the ``(owner, attribute)`` callables of ``spans``; print
    the wall, the device's busy and idle shares, the spans, the host syncs
    and the largest kernels, and write the full table to ``out_file``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def wrap(fn_, name):
        def inner(*a, **kw):
            with record_function(name):
                return fn_(*a, **kw)
        return inner

    saved = {}
    for (owner, attr), name in spans.items():
        saved[(owner, attr)] = getattr(owner, attr)
        setattr(owner, attr, wrap(saved[(owner, attr)], name))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(f"span:{label}"):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for (owner, attr), fn_ in saved.items():
            setattr(owner, attr, fn_)
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA and not e.key.startswith("span:")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    tag = f"[profile {label}]"
    print(f"{tag} wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms, "
          f"device idle {100 * (1 - busy / (wall * 1e3)):.1f}% of the wall")
    host = {e.key: e for e in avg if e.key.startswith("span:") and e.cpu_time_total > 0}
    dev = {e.key: e for e in avg if e.key.startswith("span:") and e.device_type == DeviceType.CUDA}
    for key, e in sorted(host.items(), key=lambda kv: -kv[1].cpu_time_total):
        d = dev.get(key)
        d_ms = "n/a" if d is None else f"{d.device_time_total / 1e3:.1f} ms"
        print(f"{tag} {key[5:]}: calls {e.count}, host {e.cpu_time_total / 1e3:.1f} ms, "
              f"device range {d_ms}")
    for e in avg:
        if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize", "aten::nonzero"):
            print(f"{tag} host sync {e.key}: calls {e.count}, host {e.cpu_time_total / 1e3:.1f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"{tag} kernel {e.key[:60]}: calls {e.count}, {e.self_device_time_total / 1e3:.2f} ms")
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(avg.table(sort_by="self_device_time_total", row_limit=60))


def phase_profile(torch, repro_torch, rnd, x, out_dir: pathlib.Path):
    """One profiled SUSY fit with spans around the driver's steps, and one
    profiled k-means|| run at K = 27 and at K = 100 with spans around the
    folds, the round's packing, the weighting pass and the reduction."""
    from repro_torch.core import init_partition, kmeans_ll, kmeanspp, lloyd, partition
    from repro_torch.engine import incore
    from repro_torch.kernels import ops

    _profile_run(torch, "fit", lambda: repro_torch.BWKM(k=SUSY_K).fit(x), {
        (partition, "block_stats"): "span:block_stats",
        (partition, "route_split"): "span:route_split",
        (init_partition, "cutting_probabilities_alg4"): "span:algorithm4",
        (init_partition, "starting_partition"): "span:algorithm3",
        (lloyd, "weighted_lloyd"): "span:lloyd_over_reps",
    }, out_dir / "susy_fit_profile.txt")
    for k in (27, 100):
        _profile_run(torch, f"kmeans|| K={k}",
                     lambda: kmeans_ll.kmeans_parallel(rnd.key(0), x, None, k), {
                         (ops, "min_sqdist_update"): "span:fold (B5)",
                         (incore.InCoreLLSession, "select"): "span:draw and pack",
                         (ops, "assign_update"): "span:weighting pass",
                         (kmeanspp, "weighted_kmeanspp"): "span:kmeans++ reduction",
                     }, out_dir / f"kmeans_ll_k{k}_profile.txt")


# ---------------------------------------------------------------- main
def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if "--walls" in argv:
        i = argv.index("--walls")
        return _walls_child(argv[i + 1], int(argv[i + 2]))
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch import random as rnd
    from repro_torch.core import kmeans_ll, partition
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import cluster_update as cu
    from repro_torch.kernels import distance_assign as da
    from repro_torch.kernels import fused_assign_update as fau
    from repro_torch.kernels import min_sqdist_update as msu

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    # phase 1
    t0 = time.perf_counter()
    parent = (_Parent.start(_build, argv[argv.index("--parent") + 1])
              if "--parent" in argv else None)
    reports = _build.build_all()
    if parent is not None:
        parent.finish()
    print(f"[build] {time.perf_counter() - t0:.1f} s, compiled {sorted(reports)}"
          + (" and the parent's four" if parent is not None else ""))
    for name, log in reports.items():
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {kernel}: {line.strip()}")
    # phase 2
    errs, rel, n_checks, ties = phase_kernels(torch, ref, da, fau, kmeans_ll._FAR)
    print(f"[kernels] B1-B3 match their plain versions in {n_checks} cases "
          "(f32 tol 1e-5, bf16 tol 1e-3); max abs err of d1/d2: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in errs.items())
          + "; max rel err of sums/counts/err: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in rel.items())
          + f"; at most {ties} rows in one case labelled otherwise than by the plain version "
          "(near-ties, each at the minimum within tolerance)")
    errs45, rel45, n_checks = phase_kernels_b45(torch, ref, cu, msu)
    errs.update(errs45)
    print(f"[kernels] B4-B5 match their plain versions in {n_checks} cases "
          "(f32 tol 1e-5, bf16 tol 1e-3; B5's min-d² relative to ‖x‖² + ‖c‖², sums to Σ|terms|); "
          "max abs err of B5 min-d² and B4 sums: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in errs45.items())
          + "; max rel err of B5 cost and B4 sums/counts: "
          + ", ".join(f"{b} {dt} {v:.3g}" for (b, dt), v in rel45.items()))
    wide = phase_kernels_wide(torch, ref, da, fau, cu, msu)
    print(f"[kernels] wide rows (d = {WIDE_D[0]:,} and {WIDE_D[1]:,}, 300 rows, K = 5; B2/B3 "
          f"at K = 1, d = {WIDE_D[0]:,}) match their plain versions (f32 tol 1e-5, sums to "
          "Σ|terms|); max abs err: " + ", ".join(f"{b} {v:.3g}" for b, v in wide.items()))
    # phase 4's data, used by phase 3's full-width checks as well
    t0 = time.perf_counter()
    x = torch.from_numpy(paper_dataset("SUSY", seed=0)).cuda()
    print(f"[data] SUSY profile {tuple(x.shape)} on the card in {time.perf_counter() - t0:.1f} s")
    # phase 3
    phase_determinism(torch, ops, da, fau, cu, msu, partition, x, kmeans_ll._FAR)
    print("[determinism] pruned == dense bit for bit at 0/10/100 % active (fused at the "
          "representatives and over all rows at K = 561 and K = 800, two-pass at K·(d+1) = "
          "18,000); two B2 runs at each of those shapes, two full-n B1, B4 and B5 runs and two "
          "full-n block_stats runs bit-equal; full-n B5 over 400 slots == B5 over its valid ones")
    # phase 4
    launches = phase_fit(torch, repro_torch, ref, da, fau, x, parent)
    counters = {"B1": da.assign_top2_cuda, "B2": fau.fused_assign_update_cuda,
                "B3": fau.fused_assign_update_pruned_cuda, "B4": cu.cluster_sums_cuda,
                "B5": msu.min_sqdist_update_cuda}
    ll_launches, ll_path, rep_folds = phase_kmeans_ll(torch, repro_torch, rnd, kmeans_ll, ops,
                                                      ref, counters, x)
    launches.update(B4=ll_launches["B4"], B5=ll_launches["B5"])
    # phase 5
    times = phase_times(torch, ref, da, fau, cu, msu, x, ll_path, rep_folds, parent)
    if parent is not None:
        phase_walls(argv[argv.index("--parent") + 1])
    if "--profile" in argv:
        phase_profile(torch, repro_torch, rnd, x, pathlib.Path(argv[argv.index("--profile") + 1]))
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
        "B4": ("cluster_sums", "src/repro_torch/kernels/csrc/cluster_sums.cu",
               "src/repro/kernels/cluster_update.py:51"),
        "B5": ("min_sqdist_update", "src/repro_torch/kernels/csrc/min_sqdist_update.cu",
               "src/repro/kernels/min_sqdist_update.py:92"),
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
