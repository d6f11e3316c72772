"""Launch plans, cost models and bounds of the port's kernels on an H100.

Counterpart of ``repro.roofline.analysis``. Three parts:

* **The CUDA plans.** :func:`assign_update_blocking` (B1's scan; B2/B3's
  scan and statistics fold), :func:`min_sqdist_blocking` (B5) and
  :func:`cluster_sums_blocking` (B4) return what the kernels launch with:
  the same arithmetic as ``csrc/top2.cuh::scan_shape`` and
  ``csrc/cluster_fold.cuh::fold_shape``, so Python can see, test and vary
  every blocking decision. A plan's integers go to the kernels' ``_ex``
  entry points, which check a plan and refuse one that does not fit
  (``cudaErrorInvalidValue``); they never adjust it. The card holds these
  plans against ``bwkm_scan_plan`` / ``bwkm_fold_plan`` over a grid of
  shapes (``tests/test_torch_cuda.py``).
* **The cost models** of the reference, with its arithmetic
  (:func:`assign_update_hbm_bytes`, :func:`min_sqdist_hbm_bytes`,
  :func:`kmeans_ll_cost`, :func:`assign_update_pruned_cost`,
  :class:`RooflineTerms`, :func:`terms_from_costs`,
  :func:`extrapolate_linear`, :func:`model_flops`), on H100 constants.
* **The seam bounds** (:func:`assign_top2_bound` … :func:`min_sqdist_bound`):
  the least time the card could take for one call of a kernel seam, the
  larger of the bytes it must move (each input read once, each output
  written once) over the HBM rate and its operations over the f32 rate
  (the kernels compute in f32 on the CUDA cores). ``chip_smoke.py`` and
  ``PERF.md`` take their bounds from here.

The reference's ``parse_collective_bytes`` reads XLA's HLO text, which the
port never has; :func:`collective_bytes` returns the same shape from the
counts that the port's own collectives keep (``distributed/sharding.py``).

Hardware constants: the H100 SXM data sheet (dense rates, 700 W).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
TF32_FLOPS = 495e12  # TF32 dense, tensor cores
F32_FLOPS = 67e12  # f32 outside the tensor cores: what the kernels compute in
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way, to the other cards of the host
SMEM_OPTIN_BYTES = 232_448  # dynamic shared memory a block may opt into
REGISTERS_PER_SM = 65_536

#: the on-chip tile budget a single kernel launch may plan for
KERNEL_BUDGET_BYTES = {"cuda": SMEM_OPTIN_BYTES}

#: the scan of ``csrc/top2.cuh`` (B1–B3, B5)
SCAN_THREADS = 128
SCAN_SMEM = SMEM_OPTIN_BYTES - 1024  # dynamic shared bytes of a scan CTA, at most
SCAN_XBUF_MAX = 131_072 + 32  # the largest staged x tile
SCAN_WIDE_N = 131_072  # rows from which a thread owns four rows
WIDE_SMEM = 16 * 1024  # the wide-row form's dynamic shared bytes
ROWS_PER_THREAD = (1, 4)  # the instantiated register blockings

#: the statistics fold of ``csrc/cluster_fold.cuh`` (B2/B3's statistics, B4)
FOLD_TILE = 256
FOLD_MAX_CTAS = 128
FOLD_PART_FLOATS = 40_960
FOLD_SMEM = SMEM_OPTIN_BYTES
FOLD_MAX_STAGES = 4
FOLD_MIN_STAGES = 2  # the ring keeps one tile in flight while one is walked
FOLD_STATIC_SMEM = (8 * FOLD_TILE + 4 * FOLD_TILE + 8 * 32 * (FOLD_TILE // 32) + 8 * 32
                    + 8 * FOLD_MAX_STAGES)  # the fold kernel's static shared arrays

#: the largest K·(d + 1) the fused kernels B2/B3 take (a 64 KB shared partial)
FUSED_MAX_KD1 = 16_384


def kernel_budget_bytes(backend: str = "cuda") -> int:
    """The shared memory one launch may plan for."""
    _check_backend(backend)
    return KERNEL_BUDGET_BYTES[backend]


def _check_backend(backend: str) -> None:
    if backend != "cuda":
        raise ValueError(f"the port plans for backend 'cuda' only, got {backend!r}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceil_to(x: int, q: int) -> int:
    return _cdiv(x, q) * q


# ------------------------------------------------------------------ the scan
def scan_dx(d: int) -> int:
    """Features per register chunk of the scan: 19 up to d = 19, else 32."""
    return 19 if d <= 19 else 32


def default_rows_per_thread(n: int, d: int) -> int:
    """The scan's own rows a thread over ``n`` rows of ``d`` features: 4
    from 131,072 rows on at d ≤ 19, else 1."""
    return 4 if scan_dx(d) < 32 and n >= SCAN_WIDE_N else 1


def _scan_xbytes(rows: int, d: int, xsize: int) -> int:
    xb = (rows * d * xsize + 32 + 15) // 16 * 16
    return xb if xb <= SCAN_XBUF_MAX else 0


def scan_plan(
    n: int, d: int, k: int, *, dtype_bytes: int = 4, rows_per_thread: int = 0,
    kc: int = 0, ctas: int = 0,
) -> dict[str, Any]:
    """The plan of one scan launch over ``n`` rows of ``d`` features of
    ``dtype_bytes`` bytes against ``k`` candidate slots, as
    ``top2.cuh::scan_plan`` checks and fills it. Zero knobs are the kernel's
    own choice: ``rows_per_thread`` 4 from 131,072 rows on at d ≤ 19, else
    1; ``kc`` (candidates per resident chunk, a multiple of 4) as many as
    fit beside the x tile; ``ctas`` as many as are resident at once (known
    only on the card). Rows too wide for four resident candidates take the
    wide-row form (``wide``). Raises ``ValueError`` for a plan the kernel
    would refuse."""
    if k < 1 or d < 1 or n < 0:
        raise ValueError(f"the scan takes n >= 0, d >= 1 and K >= 1, got {n}, {d}, {k}")
    if rows_per_thread < 0 or kc < 0 or ctas < 0:
        raise ValueError("plan knobs are >= 0 (0: the kernel's own choice)")
    dx = scan_dx(d)
    dxp = _ceil_to(d, dx)
    per = 4 * (dxp + 1)  # shared bytes of one candidate: its features and norm
    slots = _ceil_to(k, 4)
    r0 = default_rows_per_thread(n, d)
    x0 = _scan_xbytes(SCAN_THREADS * r0, d, dtype_bytes)
    base = {"scan_dx": dx, "dp": dxp, "kc_slots": slots, "ctas": int(ctas)}
    if min((SCAN_SMEM - x0) // per // 4 * 4, slots) < 4:  # the wide-row form
        if rows_per_thread not in (0, 1) or kc not in (0, 4):
            raise ValueError("the wide-row form takes one row a thread and four candidates")
        return base | {"wide": True, "rows_per_thread": 1, "bn": SCAN_THREADS, "bk": 4,
                       "xbytes": 0, "smem_bytes": WIDE_SMEM, "tiles": _cdiv(n, SCAN_THREADS)}
    r = rows_per_thread or r0
    if r not in ROWS_PER_THREAD or (r == 4 and dx == 32):
        raise ValueError(f"no scan is instantiated at {r} rows a thread and d = {d}")
    rows = SCAN_THREADS * r
    xbytes = _scan_xbytes(rows, d, dtype_bytes)
    kmax = min((SCAN_SMEM - xbytes) // per // 4 * 4, slots)
    if kc == 0:
        kc = kmax
    elif kc % 4 or kc < 4 or kc > slots or xbytes + per * kc > SCAN_SMEM:
        raise ValueError(f"kc = {kc} is not a multiple of 4 in [4, {kmax}]")
    return base | {"wide": False, "rows_per_thread": r, "bn": rows, "bk": kc,
                   "xbytes": xbytes, "smem_bytes": xbytes + per * kc, "tiles": _cdiv(n, rows)}


# ------------------------------------------------------------------ the fold
def _span(nbytes: int) -> int:
    """Shared bytes a span takes, staged at its offset from 16-byte alignment."""
    return (nbytes + 15 + 15) // 16 * 16


def fold_plan(
    n: int, d: int, k: int, *, dtype_bytes: int = 4, err: bool = True, act: bool = False,
    part_floats: int = 0, kt: int = 0, cw: int = 0, stages: int = 0,
) -> dict[str, Any]:
    """The plan of one statistics fold (``cluster_fold.cuh::fold_plan``):
    ``kt`` clusters by ``cw`` columns of shared partial per CTA (both 0: from
    the cap ``part_floats``, itself 0 for 40,960 floats), ``stages`` tiles in
    the ring (0: as many as fit, at most 4, at most the CTA's tiles + 1),
    with the error (``err``) and an active mask (``act``) staged beside the
    rows. The row grid, ``min(128, ceil(n / 256))`` CTAs, is fixed: the
    partials are summed in CTA order, so it is not a knob. Raises
    ``ValueError`` for a plan the kernel would refuse."""
    if k < 1 or d < 1 or n < 0:
        raise ValueError(f"the fold takes n >= 0, d >= 1 and K >= 1, got {n}, {d}, {k}")
    if min(part_floats, kt, cw, stages) < 0 or (kt == 0) != (cw == 0):
        raise ValueError("plan knobs are >= 0, and kt and cw are given together")
    d1 = d + 1
    if kt == 0:
        cap = min(part_floats, FOLD_PART_FLOATS) if part_floats > 0 else FOLD_PART_FLOATS
        cw = min(d1, cap)
        kt = max(1, min(k, cap // cw))
    elif not (1 <= cw <= d1 and 1 <= kt <= k and kt * cw <= FOLD_PART_FLOATS):
        raise ValueError(f"a [{kt}, {cw}] partial does not fit K = {k}, d + 1 = {d1}")
    pbytes = (4 * kt * cw + 15) // 16 * 16
    xb = _span(FOLD_TILE * d * dtype_bytes)
    fb = _span(4 * FOLD_TILE)
    rest = 2 * fb + (fb if err else 0) + (_span(FOLD_TILE) if act else 0)
    budget = FOLD_SMEM - FOLD_STATIC_SMEM - pbytes
    xstaged = 2 * (xb + rest) <= budget
    sbytes = (xb if xstaged else 0) + rest
    tiles = _cdiv(n, FOLD_TILE)
    g = min(FOLD_MAX_CTAS, tiles)
    per_cta = _cdiv(tiles, g) if g > 0 else 1
    if stages == 0:
        stages = min(FOLD_MAX_STAGES, budget // sbytes, per_cta + 1)
    elif not (FOLD_MIN_STAGES <= stages <= FOLD_MAX_STAGES and stages * sbytes <= budget):
        raise ValueError(f"{stages} stages of {sbytes} bytes do not fit the ring")
    return {"kt": kt, "cw": cw, "stages": stages, "xstaged": bool(xstaged), "sbytes": sbytes,
            "pbytes": pbytes, "smem_bytes": pbytes + stages * sbytes, "ctas": g,
            "tiles": tiles, "k_tiles": _cdiv(k, kt), "col_chunks": _cdiv(d1, cw)}


# ------------------------------------------------------- the seams' plans
def _rows_per_thread(bn: int | None) -> int:
    if bn is None:
        return 0
    if bn % SCAN_THREADS:
        raise ValueError(f"a scan tile holds a multiple of {SCAN_THREADS} rows, got bn = {bn}")
    return bn // SCAN_THREADS


def assign_update_blocking(
    d: int,
    k: int,
    *,
    n: int | None = None,
    bn: int | None = None,
    bk: int | None = None,
    dtype_bytes: int = 4,
    backend: str = "cuda",
    pruned: bool = False,
    ctas: int = 0,
    fold_stages: int = 0,
    fold_part_floats: int = 0,
) -> dict[str, Any]:
    """The plan of the assignment seams: B1's scan and B2's (``pruned``:
    B3's) scan and statistics fold, over ``n`` rows (``None``: a pass of at
    least 131,072 rows). ``bn`` is the scan's rows per tile (128 or 512),
    ``bk`` its candidates per resident chunk; ``ctas`` caps its grid;
    ``fold_stages`` and ``fold_part_floats`` set the fold's ring and partial.
    ``fused_ok`` says whether B2/B3 take the shape (K·(d + 1) ≤ 16,384);
    elsewhere ``ops`` runs B1 then B4."""
    _check_backend(backend)
    n = SCAN_WIDE_N if n is None else n
    plan = scan_plan(n, d, k, dtype_bytes=dtype_bytes, rows_per_thread=_rows_per_thread(bn),
                     kc=bk or 0, ctas=ctas)
    return plan | {
        "kp_acc": k,
        "kp_dist": plan["kc_slots"],
        "acc_bytes": 4 * k * (d + 1),
        "fused_ok": k * (d + 1) <= FUSED_MAX_KD1,
        "fold": fold_plan(n, d, k, dtype_bytes=dtype_bytes, err=True, act=pruned,
                          part_floats=fold_part_floats, stages=fold_stages),
    }


def min_sqdist_blocking(
    d: int,
    l: int,  # noqa: E741  (the reference's name for the candidate count)
    *,
    n: int | None = None,
    bn: int | None = None,
    bl: int | None = None,
    dtype_bytes: int = 4,
    backend: str = "cuda",
    ctas: int = 0,
) -> dict[str, Any]:
    """The plan of B5's scan over ``n`` rows (``None``: at least 131,072)
    against ``l`` candidate slots; ``bl`` is its candidates per resident
    chunk (only the valid candidates are staged, so at run time fewer
    chunks may be needed)."""
    _check_backend(backend)
    n = SCAN_WIDE_N if n is None else n
    plan = scan_plan(n, d, l, dtype_bytes=dtype_bytes, rows_per_thread=_rows_per_thread(bn),
                     kc=bl or 0, ctas=ctas)
    plan["bl"] = plan.pop("bk")
    return plan | {"lp": plan["kc_slots"]}


def cluster_sums_blocking(
    d: int, k: int, *, n: int | None = None, dtype_bytes: int = 4, backend: str = "cuda",
    part_floats: int = 0, stages: int = 0,
) -> dict[str, Any]:
    """The plan of B4's fold (no error, no active mask)."""
    _check_backend(backend)
    n = SCAN_WIDE_N if n is None else n
    return fold_plan(n, d, k, dtype_bytes=dtype_bytes, err=False, act=False,
                     part_floats=part_floats, stages=stages)


# --------------------------------------------------------- the cost models
def assign_update_hbm_bytes(
    n: int, d: int, k: int, *, fused: bool, bn: int = 512, dtype_bytes: int = 4
) -> dict[str, float]:
    """Analytic per-iteration HBM traffic of the assignment+update step, as
    the reference models it: fused reads x once; two-pass reads it twice;
    both re-fetch the centroids once per ``bn``-row block."""
    x_bytes = dtype_bytes * n * d
    c_refetch = dtype_bytes * -(-n // bn) * k * d
    row_out = 3 * 4 * n  # assign, d1, d2
    stats_out = 4 * (k * d + k)
    if fused:
        reads = x_bytes + 4 * n + c_refetch  # x + w + centroid tiles
        writes = row_out + stats_out + 4
    else:
        reads = 2 * x_bytes + 4 * n + 4 * n + c_refetch
        writes = row_out + stats_out
    return {
        "x_read_bytes": (1 if fused else 2) * x_bytes,
        "read_bytes": float(reads),
        "write_bytes": float(writes),
        "total_bytes": float(reads + writes),
    }


def min_sqdist_hbm_bytes(
    n: int, d: int, l: int, *, bn: int | None = None, dtype_bytes: int = 4  # noqa: E741
) -> dict[str, float]:
    """Analytic HBM traffic of one k-means|| fold pass, fused (the kernel)
    against composed (an ``[n, L]`` distance matrix written and re-read).
    ``bn`` defaults to B5's plan at ``n``."""
    bn = bn or min_sqdist_blocking(d, l, n=n, dtype_bytes=dtype_bytes)["bn"]
    x_bytes = dtype_bytes * n * d
    c_refetch = dtype_bytes * -(-n // bn) * l * d
    state_bytes = 4 * n  # the running min-d², read and written once
    fused_reads = x_bytes + 4 * n + state_bytes + c_refetch
    fused_writes = state_bytes + 4
    dist_bytes = 4.0 * n * l
    composed_reads = x_bytes + dtype_bytes * l * d + 4 * n + state_bytes + 2 * dist_bytes
    composed_writes = dist_bytes + state_bytes + 4
    return {
        "read_bytes": float(fused_reads),
        "write_bytes": float(fused_writes),
        "total_bytes": float(fused_reads + fused_writes),
        "composed_total_bytes": float(composed_reads + composed_writes),
        "intermediate_bytes_removed": float(3 * dist_bytes),
    }


def kmeans_ll_cost(
    n: int,
    d: int,
    k: int,
    *,
    oversampling: int | None = None,
    rounds: int = 5,
    dtype_bytes: int = 4,
    bn: int | None = None,
) -> dict[str, float]:
    """Expected cost of a k-means|| init against sequential K-means++, as the
    reference models it; ``bn`` (default: B5's plan) sets the fold pass's
    centroid re-fetch."""
    l = oversampling if oversampling is not None else 2 * k  # noqa: E741
    n_cand = 1.0 + rounds * l
    fold_ops = n * 1.0 + sum(n * float(l) for _ in range(rounds))
    weighting_ops = n * n_cand
    candidate_pp_ops = n_cand * max(k - 1, 1)
    per_pass = min_sqdist_hbm_bytes(n, d, max(l, 1), bn=bn, dtype_bytes=dtype_bytes)
    return {
        "sequential_passes": float(rounds + 2),
        "sequential_passes_kmeanspp": float(max(k - 1, 1)),
        "n_candidates": n_cand,
        "distance_ops": fold_ops + weighting_ops + candidate_pp_ops,
        "distance_ops_kmeanspp": float(n) * max(k - 1, 1),
        "hbm_bytes_per_fold_pass": per_pass["total_bytes"],
    }


def assign_update_pruned_cost(
    n: int,
    d: int,
    k: int,
    active_rows: int,
    *,
    bn: int | None = None,
    skipped_block_fraction: float = 0.0,
    dtype_bytes: int = 4,
) -> dict[str, float]:
    """Analytic cost of one drift-bound-pruned pass, as the reference models
    it: the distance term shrinks to the active rows, the statistics still
    cover every row, plus the bound state. ``bn`` defaults to B3's plan."""
    bn = bn or assign_update_blocking(d, k, n=n, dtype_bytes=dtype_bytes, pruned=True)["bn"]
    base = assign_update_hbm_bytes(n, d, k, fused=True, bn=bn, dtype_bytes=dtype_bytes)
    bound_state = 4.0 * n * 3  # assign, ub, lb
    x_bytes = dtype_bytes * n * d
    reads = base["read_bytes"] + bound_state + 4.0 * n  # + active mask
    reads -= skipped_block_fraction * x_bytes
    writes = base["write_bytes"] + bound_state
    return {
        "distance_ops": float(active_rows) * k,
        "distance_ops_dense": float(n) * k,
        "flops_distance": 2.0 * active_rows * k * d,
        "flops_stats": 2.0 * n * k * d,
        "flops_dense": 2.0 * n * k * d + 2.0 * n * k * d,
        "read_bytes": float(reads),
        "write_bytes": float(writes),
        "total_bytes": float(reads + writes),
        "x_read_bytes": float(x_bytes * (1.0 - skipped_block_fraction)),
    }


# -------------------------------------------------------------- the roofline
@dataclasses.dataclass
class RooflineTerms:
    """Per-step terms in seconds (per-device quantities / unit rate)."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self) | {
            "dominant": self.dominant,
            "bound_s": self.bound_s,
        }


def terms_from_costs(
    flops: float, hbm_bytes: float, coll_bytes: float, *, peak: float = PEAK_FLOPS
) -> RooflineTerms:
    """The three terms on one H100: ``peak`` is the rate the operations run
    at (the bf16 tensor-core peak by default; :data:`F32_FLOPS` for the
    kernels, which compute in f32 on the CUDA cores), HBM, and NVLink."""
    return RooflineTerms(
        flops=flops,
        hbm_bytes=hbm_bytes,
        collective_bytes=coll_bytes,
        compute_s=flops / peak,
        memory_s=hbm_bytes / HBM_BW,
        collective_s=coll_bytes / NVLINK_BW,
    )


def extrapolate_linear(
    cost_p: dict[str, float], cost_2p: dict[str, float], p: int, total: int
) -> dict[str, float]:
    """Exact ``cost(L) = a + b·L`` from probes at depths p and 2p."""
    out = {}
    for k in cost_p:
        b = (cost_2p[k] - cost_p[k]) / p
        a = cost_p[k] - b * p
        out[k] = a + b * total
    return out


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """Analytic MODEL_FLOPS of a transformer-family config, as the reference
    counts them: 6·N·D train (N_active for MoE) plus the causal-attention
    term; 2·N·D for prefill; 2·N·B per decode step. ``cfg`` and ``shape``
    are read by attribute only."""
    b, s = shape.global_batch, shape.seq_len
    tokens = b * s
    att = 0.0
    if cfg.n_heads:
        window = cfg.window or s
        eff = min(window, s)
        att_tokens = b * s * min(s, eff) / (1 if cfg.window and s > window else 2)
        att = 4 * cfg.n_layers * cfg.n_heads * cfg.hd * att_tokens
        if cfg.family == "vlm":
            att = att * (cfg.cross_attn_every - 1) / cfg.cross_attn_every
        if cfg.family == "hybrid":
            att = att * (cfg.n_layers // cfg.shared_attn_every) / cfg.n_layers
    if shape.kind == "train":
        return 6.0 * n_active * tokens + 3.0 * att
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens + att
    dec_att = 0.0
    if cfg.n_heads:
        eff = min(cfg.window or s, s)
        layers_with_attn = (
            cfg.n_layers // cfg.shared_attn_every
            if cfg.family == "hybrid"
            else cfg.n_layers
        )
        dec_att = 4 * layers_with_attn * cfg.n_heads * cfg.hd * b * eff
    return 2.0 * n_active * b + dec_att


# ----------------------------------------------------------- the seam bounds
class SeamBound(NamedTuple):
    """The least time one call of a kernel seam could take on an H100."""

    flops: float  # operations these inputs need
    bytes: float  # each input read once, each output written once
    ms: float  # the larger of the two times
    by: str  # "bytes" or "operations", whichever sets ``ms``


def seam_bound(flops: float, nbytes: float, *, peak: float = F32_FLOPS) -> SeamBound:
    """:class:`SeamBound` of ``flops`` operations at ``peak`` and ``nbytes``
    bytes over HBM; a tie counts as bytes."""
    t = terms_from_costs(flops, nbytes, 0.0, peak=peak)
    tb, tf = t.memory_s * 1e3, t.compute_s * 1e3
    ms, by = (tb, "bytes") if tb >= tf else (tf, "operations")
    return SeamBound(float(flops), float(nbytes), ms, by)


def _dist_flops(rows: int, cands: int, d: int) -> int:
    """2·d + 3 operations per (row, candidate): d FMAs, the compare and the
    top-2 (or running-min) update."""
    return rows * cands * (2 * d + 3)


def assign_top2_bound(n: int, d: int, k: int, *, dtype_bytes: int = 4) -> SeamBound:
    """B1: x and c in, assign, d1, d2 out; every (row, candidate slot)."""
    return seam_bound(_dist_flops(n, k, d),
                      dtype_bytes * n * d + dtype_bytes * k * d + 12 * n)


def _stats_bytes(n: int, d: int, k: int, dtype_bytes: int) -> int:
    # x, w and c in; assign, d1, d2, sums, counts and err out
    return (dtype_bytes * n * d + 4 * n + dtype_bytes * k * d + 12 * n
            + 4 * k * (d + 1) + 4)


def assign_update_bound(n: int, d: int, k: int, *, dtype_bytes: int = 4) -> SeamBound:
    """B2: B1's scan over every row plus the weighted statistics (2·d
    operations a row)."""
    return seam_bound(_dist_flops(n, k, d) + 2 * n * d, _stats_bytes(n, d, k, dtype_bytes))


def assign_update_pruned_bound(
    n: int, d: int, k: int, active_rows: int, *, dtype_bytes: int = 4
) -> SeamBound:
    """B3: the scan over the active rows only, the statistics over every
    row, and the cached ids and active mask read (5 bytes a row)."""
    return seam_bound(_dist_flops(active_rows, k, d) + 2 * n * d,
                      _stats_bytes(n, d, k, dtype_bytes) + 5 * n)


def cluster_sums_bound(n: int, d: int, k: int, *, dtype_bytes: int = 4) -> SeamBound:
    """B4: x, w and the ids in, sums and counts out; d + 1 adds a row."""
    return seam_bound(2 * n * (d + 1), dtype_bytes * n * d + 8 * n + 4 * k * (d + 1))


def min_sqdist_bound(
    n: int, d: int, l: int, valid: int, *, dtype_bytes: int = 4  # noqa: E741
) -> SeamBound:
    """B5: x, w, min-d² and the candidates with their validity in, min-d²
    and φ out; the valid candidates' operations only."""
    return seam_bound(_dist_flops(n, valid, d),
                      dtype_bytes * n * d + 12 * n + 4 * l * (d + 1) + 4)


# ------------------------------------------------------------ collectives
def collective_bytes(*, reset: bool = False) -> dict[str, Any]:
    """Bytes and calls of the collectives this process issued through
    ``repro_torch.distributed.sharding``, by kind, in the reference's
    ``parse_collective_bytes`` shape: ``{kind: {"bytes", "count"},
    "total_bytes"}``. A gather is one ``all_reduce`` of a ``[W, ...]``
    buffer and counts as ``all-gather``, with the buffer's bytes. ``reset``
    clears the counts after reading them."""
    from repro_torch.distributed import sharding

    out: dict[str, Any] = {kind: dict(v) for kind, v in sharding.COLLECTIVE_COUNTS.items()}
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    if reset:
        for v in sharding.COLLECTIVE_COUNTS.values():
            v["bytes"] = v["count"] = 0
    return out
