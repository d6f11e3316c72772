"""Weighted Lloyd's algorithm, dense and drift-bound pruned.

Counterpart of ``repro.core.lloyd``: :func:`weighted_lloyd`, its traced
twin :func:`weighted_lloyd_trace` and the unweighted :func:`lloyd` of the
baselines. The reference's ``while_loop`` is a Python loop here. Its state
stays on the device; the stop test is the one host sync per iteration.

* dense — each iteration is one ``ops.assign_update`` pass (kernel B2).
* pruned (default) — per-row bounds carried across iterations (an upper
  bound on the distance to the own centroid, a lower bound on the distance
  to every other) inflate and deflate with the centroid drift; rows whose
  bounds still separate keep their assignment and skip the distance scan in
  ``ops.assign_update_pruned`` (kernel B3). Its statistics are accumulated
  as the dense pass accumulates them, so the centroids are bit-identical
  whenever the assignments agree; the error comes from the identity in
  :func:`stats_error`. One dense pass at the final centroids recovers the
  exact top-2 distances the misassignment function needs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

__all__ = [
    "LloydResult",
    "drift_bound_update",
    "lloyd",
    "stats_error",
    "weighted_lloyd",
    "weighted_lloyd_trace",
]


class LloydResult(NamedTuple):
    centroids: torch.Tensor  # [K, d]
    error: torch.Tensor  # scalar f32, weighted error at the final centroids
    iters: int  # Lloyd iterations executed
    assign: torch.Tensor  # [n] i32
    d1: torch.Tensor  # [n] f32
    d2: torch.Tensor  # [n] f32
    distances: torch.Tensor  # scalar f32, distance computations done
    max_shift: torch.Tensor  # scalar f32, max_k ‖c_k − c'_k‖ of the last update


def _next_centroids(sums: torch.Tensor, counts: torch.Tensor, old_c: torch.Tensor) -> torch.Tensor:
    occupied = counts > 0
    return torch.where(
        occupied[:, None], sums / torch.clamp(counts, min=1e-30)[:, None], old_c
    )


def drift_bound_update(
    ub: torch.Tensor, lb: torch.Tensor, assign: torch.Tensor, drift: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hamerly-style bounds from a per-centroid drift ``[K]``: ``ub`` grows by
    the own centroid's drift, ``lb`` shrinks by the largest drift of any
    other centroid (the second largest when the own one is the arg-max)."""
    amax = torch.argmax(drift)  # first maximum on ties
    dmax = drift[amax]
    d2nd = torch.where(
        torch.arange(drift.shape[0], device=drift.device) == amax, float("-inf"), drift
    ).max()
    a = assign.long()
    return ub + drift[a], lb - torch.where(a == amax, d2nd, dmax)


def stats_error(
    w2sum: torch.Tensor, c: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Exact weighted error from sufficient statistics:
    ``E = Σ w‖x‖² − 2·Σ_k c_k·S_k + Σ_k ‖c_k‖²·N_k``."""
    c = c.float()
    cross = (c * sums).sum()
    cn = (c * c).sum(-1)
    return torch.clamp(w2sum - 2.0 * cross + (cn * counts).sum(), min=0.0)


def _sqrt0(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(v, min=0.0))


def weighted_lloyd(
    x: torch.Tensor,
    w: torch.Tensor,
    init_centroids: torch.Tensor,
    *,
    max_iters: int = 100,
    epsilon: float = 1e-4,
    prune: bool | None = None,
) -> LloydResult:
    """Weighted Lloyd with the Eq.-2 stop rule ``|E − E'| <= epsilon·E``.

    ``x [n,d]`` points (the representatives), ``w [n]`` nonnegative weights,
    ``init_centroids [K,d]``. ``distances`` counts K per row with ``w > 0``
    and per pass — with pruning only the rows whose bounds failed, plus the
    dense finishing pass. ``prune=None`` means pruned, the default.
    """
    prune = prune is None or bool(prune)
    w = w.float()
    fu = ops.assign_update(x, w, init_centroids)
    c, err, prev_err = init_centroids, fu.err, torch.full_like(fu.err, float("inf"))
    assign, sums, counts, dists = fu.assign, fu.sums, fu.counts, fu.n_dist
    max_shift = torch.full_like(fu.err, float("inf"))
    if prune:
        w2sum = (w * (x.float() ** 2).sum(-1)).sum()
        row1, row2 = _sqrt0(fu.d1), _sqrt0(fu.d2)  # ub, lb (inf for K == 1)
    else:
        row1, row2 = fu.d1, fu.d2

    it = 0
    while it < max_iters and bool(
        (prev_err - err).abs() > epsilon * torch.clamp(err, min=1e-30)
    ):
        c_new = _next_centroids(sums, counts, c)
        drift = torch.linalg.vector_norm(c_new - c, dim=-1)
        if prune:
            ub, lb = drift_bound_update(row1, row2, assign, drift)
            active = ub >= lb  # ub < lb proves the argmin unchanged
            fu = ops.assign_update_pruned(x, w, c_new, assign, active)
            prev_err, err = err, stats_error(w2sum, c_new, fu.sums, fu.counts)
            row1 = torch.where(active, _sqrt0(fu.d1), ub)
            row2 = torch.where(active, _sqrt0(fu.d2), lb)
        else:
            fu = ops.assign_update(x, w, c_new)
            prev_err, err = err, fu.err
            row1, row2 = fu.d1, fu.d2
        c, assign, sums, counts = c_new, fu.assign, fu.sums, fu.counts
        dists = dists + fu.n_dist
        max_shift = drift.max()
        it += 1

    if prune:
        fin = ops.assign_update(x, w, c)
        return LloydResult(c, fin.err, it, fin.assign, fin.d1, fin.d2, dists + fin.n_dist, max_shift)
    return LloydResult(c, err, it, assign, row1, row2, dists, max_shift)


def weighted_lloyd_trace(
    x: torch.Tensor,
    w: torch.Tensor,
    init_centroids: torch.Tensor,
    *,
    max_iters: int = 100,
    epsilon: float = 1e-4,
    prune: bool | None = None,
) -> tuple[LloydResult, list[dict]]:
    """:func:`weighted_lloyd` with per-iteration cost telemetry:
    ``(result, trace)``, one trace row per pass with ``iteration``,
    ``active_rows``, ``rows``, ``pruned_fraction``, ``n_dist`` and
    ``error`` (the pruned path's dense finishing pass adds
    ``finishing_pass``). It runs the same seams and bound helpers, reading
    each pass's counts back to the host; use :func:`weighted_lloyd` unless
    the trajectory is wanted."""
    prune = prune is None or bool(prune)
    w = w.float()
    n_rows = int((w > 0).sum())

    fu = ops.assign_update(x, w, init_centroids)
    c = init_centroids
    err, prev_err = fu.err, float("inf")
    assign, sums, counts = fu.assign, fu.sums, fu.counts
    dists = float(fu.n_dist)
    w2sum = (w * (x.float() ** 2).sum(-1)).sum()
    ub, lb = _sqrt0(fu.d1), _sqrt0(fu.d2)
    d1, d2 = fu.d1, fu.d2
    max_shift = float("inf")

    trace = [{
        "iteration": 0, "active_rows": n_rows, "rows": n_rows,
        "pruned_fraction": 0.0, "n_dist": float(fu.n_dist), "error": float(err),
    }]
    it = 0
    while it < max_iters and abs(float(prev_err) - float(err)) > epsilon * max(float(err), 1e-30):
        c_new = _next_centroids(sums, counts, c)
        drift = torch.linalg.vector_norm(c_new - c, dim=-1)
        max_shift = float(drift.max())
        if prune:
            ub, lb = drift_bound_update(ub, lb, assign, drift)
            active = ub >= lb
            fu = ops.assign_update_pruned(x, w, c_new, assign, active)
            sums, counts = fu.sums, fu.counts
            prev_err, err = err, stats_error(w2sum, c_new, sums, counts)
            ub = torch.where(active, _sqrt0(fu.d1), ub)
            lb = torch.where(active, _sqrt0(fu.d2), lb)
            n_active = int((active & (w > 0)).sum())
        else:
            fu = ops.assign_update(x, w, c_new)
            sums, counts = fu.sums, fu.counts
            prev_err, err = err, fu.err
            d1, d2 = fu.d1, fu.d2
            n_active = n_rows
        assign = fu.assign
        c = c_new
        dists += float(fu.n_dist)
        it += 1
        trace.append({
            "iteration": it, "active_rows": n_active, "rows": n_rows,
            "pruned_fraction": 1.0 - n_active / max(n_rows, 1),
            "n_dist": float(fu.n_dist), "error": float(err),
        })

    if prune:
        fin = ops.assign_update(x, w, c)
        dists += float(fin.n_dist)
        err, assign, d1, d2 = fin.err, fin.assign, fin.d1, fin.d2
        trace.append({
            "iteration": it, "active_rows": n_rows, "rows": n_rows,
            "pruned_fraction": 0.0, "n_dist": float(fin.n_dist),
            "error": float(err), "finishing_pass": True,
        })
    f32 = dict(dtype=torch.float32, device=x.device)
    result = LloydResult(
        c, torch.as_tensor(err, **f32), it, assign, d1, d2, torch.tensor(dists, **f32),
        torch.tensor(max_shift, **f32),
    )
    return result, trace


def lloyd(
    x: torch.Tensor,
    init_centroids: torch.Tensor,
    *,
    max_iters: int = 100,
    epsilon: float = 1e-4,
    prune: bool | None = None,
) -> LloydResult:
    """Unweighted Lloyd, the baselines' refinement stage."""
    return weighted_lloyd(
        x, torch.ones(x.shape[0], device=x.device), init_centroids,
        max_iters=max_iters, epsilon=epsilon, prune=prune,
    )
