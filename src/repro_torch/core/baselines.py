"""The baselines the paper compares BWKM against (Section 3).

Counterpart of ``repro.core.baselines``:

* FKM — Lloyd from Forgy seeds;
* KM++ — Lloyd from K-means++ seeds, and ``KM++_init``, the seeding alone;
* KMC2 — Lloyd from AFK-MC² seeds (Bachem et al. 2016);
* MB b — Sculley's mini-batch K-means (2010), b ∈ {100, 500, 1000} in the paper;
* grid-RPKM — the predecessor method (paper reference [8]): weighted Lloyd
  over the occupied cells of the 2^{i·d}-cell grid sequence.

Each returns a :class:`~repro_torch.api.result.FitResult` with
``engine="baseline:<name>"`` and the reference's distance accounting. Points
are taken as ``repro_torch.device.as_points`` takes them: a tensor stays on
its device, anything else goes to CUDA. On the card Lloyd runs kernel B2,
mini-batch K-means B1 and B4, and the grid's cells are found, counted and
summed on the device; every draw goes through :mod:`repro_torch.random`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.api.result import FitResult
from repro_torch.core import kmeanspp
from repro_torch.core.lloyd import lloyd, weighted_lloyd
from repro_torch.device import as_points
from repro_torch.kernels import ops
from repro_torch.scan import prefix_sum

__all__ = ["forgy_kmeans", "grid_rpkm", "kmc2_kmeans", "kmeanspp_kmeans", "minibatch_kmeans"]


def _result(name, centroids, distances, *, iterations=0, stop_reason="init-only", **metadata):
    return FitResult(
        centroids=centroids,
        distances=float(distances),
        iterations=int(iterations),
        stop_reason=stop_reason,
        engine=f"baseline:{name}",
        metadata=metadata,
    )


def _run_lloyd(name, x, c0, max_iters, epsilon, extra_distances):
    # prune=False: the paper charges its reference algorithms the dense n·K
    # of every Lloyd pass (Section 3); pruning would move the published
    # trade-off curves
    res = lloyd(x, c0, max_iters=max_iters, epsilon=epsilon, prune=False)
    return _result(
        name, res.centroids, float(res.distances) + extra_distances,
        iterations=res.iters,
        stop_reason="converged" if res.iters < max_iters else "max-iters",
        error=float(res.error),
    )


def forgy_kmeans(key, x, k, *, max_iters=100, epsilon=1e-4) -> FitResult:
    x = as_points(x)
    return _run_lloyd("forgy", x, kmeanspp.forgy(key, x, k), max_iters, epsilon, 0.0)


def kmeanspp_kmeans(key, x, k, *, max_iters=100, epsilon=1e-4, init_only=False) -> FitResult:
    x = as_points(x)
    c0 = kmeanspp.kmeanspp(key, x, k)
    seed_cost = float(x.shape[0] * k)  # K scans of the dataset (Section 1.2.1)
    if init_only:
        return _result("kmeans++_init", c0, seed_cost)
    return _run_lloyd("kmeans++", x, c0, max_iters, epsilon, seed_cost)


def kmc2_kmeans(key, x, k, *, chain_length=200, max_iters=100, epsilon=1e-4) -> FitResult:
    x = as_points(x)
    c0 = kmeanspp.afkmc2(key, x, k, chain_length=chain_length)
    seed_cost = float(x.shape[0] + (k - 1) * chain_length * k)  # q(·) and the chains
    return _run_lloyd("kmc2", x, c0, max_iters, epsilon, seed_cost)


def minibatch_kmeans(key, x, k, *, batch=100, iters=500) -> FitResult:
    """Sculley (2010): Forgy seeds, then ``iters`` steps over ``batch`` rows
    drawn with replacement, each centre moving towards its batch mean at the
    rate ``1/count``. A step's per-centre sums and counts come from
    ``ops.cluster_sums`` (B4 on the card) with unit weights."""
    x = as_points(x)
    n = x.shape[0]
    key, k0 = rnd.split(key)
    c = kmeanspp.forgy(k0, x, k)
    counts = torch.zeros(k, device=x.device)
    ones = torch.ones(batch, device=x.device)
    for sub in rnd.split(key, iters):
        xb = x[rnd.randint(sub, (batch,), 0, n, device=x.device)]
        assign, _, _ = ops.assign_top2(xb, c)
        sums, add = ops.cluster_sums(xb, ones, assign, k)
        counts = counts + add
        # the batch's per-centre mean step stands for sequential SGD within it
        eta = torch.where(counts > 0, add / torch.clamp(counts, min=1.0), 0.0)
        target = sums / torch.clamp(add, min=1.0)[:, None]
        c = torch.where((add > 0)[:, None], (1.0 - eta)[:, None] * c + eta[:, None] * target, c)
    return _result(
        f"minibatch{batch}", c, float(batch * k * iters),
        iterations=iters, stop_reason="iteration-budget", batch=batch,
    )


def grid_cells(x: torch.Tensor, lo: torch.Tensor, span: torch.Tensor, level: int):
    """The occupied cells of the level's ``2^level`` bins per feature:
    ``(cells [m, d] i64 in lexicographic order, inverse [n], counts [m])``,
    as ``np.unique(axis=0, return_inverse=True, return_counts=True)`` gives
    them for the reference's f32 quantisation."""
    bins = 1 << level
    q = torch.clamp(((x - lo) / span * bins).to(torch.int64), max=bins - 1)
    return torch.unique(q, dim=0, return_inverse=True, return_counts=True)


def cell_means(x: torch.Tensor, inverse: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Each cell's mean row, summed in float64: a stable sort by cell, a
    prefix sum per feature in a fixed order, differences at the cells' ends
    (no atomics, so the same bits on every run)."""
    order = torch.argsort(inverse, stable=True)
    csum = prefix_sum(x[order].double().T.contiguous())  # [d, n]
    total = csum[:, torch.cumsum(counts, dim=0) - 1]
    sums = total - F.pad(total[:, :-1], (1, 0))
    return (sums / counts).T.float().contiguous()


def grid_rpkm(
    key, x, k, *, max_level=6, max_cells=200_000, max_iters=100, epsilon=1e-4
) -> FitResult:
    """Grid-based RPKM (paper reference [8]): weighted Lloyd over the cells
    of the 2^{i·d} grid sequence, warm-started across levels. It stops when
    the occupied cells exceed ``min(max_cells, n // 2)`` past level 1
    (``grid-exhausted``), or after ``max_level`` (``max-level``).
    ``metadata`` has each level's cells and Lloyd iterations."""
    x = as_points(x).float()
    n = x.shape[0]
    lo, hi = x.min(0).values, x.max(0).values
    span = torch.where(hi > lo, hi - lo, 1.0)
    key, k0 = rnd.split(key)
    c = kmeanspp.forgy(k0, x, k)
    distances = 0.0
    stop_reason = "max-level"
    cells, lloyd_iters = [], []
    for level in range(1, max_level + 1):
        _, inverse, counts = grid_cells(x, lo, span, level)
        m = counts.shape[0]
        if m > min(max_cells, n // 2) and level > 1:
            stop_reason = "grid-exhausted"
            break
        reps = cell_means(x, inverse, counts)
        # the reference's accounting, as _run_lloyd's: dense m·K a pass
        res = weighted_lloyd(reps, counts.float(), c, max_iters=max_iters, epsilon=epsilon,
                             prune=False)
        c = res.centroids
        distances += float(res.distances)
        cells.append(m)
        lloyd_iters.append(res.iters)
    return _result(
        "grid-rpkm", c, distances, iterations=len(cells), stop_reason=stop_reason,
        cells=cells, lloyd_iters=lloyd_iters,
    )
