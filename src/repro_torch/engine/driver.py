"""The BWKM driver: paper Algorithm 5 over a data plane, and the k-means||
round loop over a seeding session.

Counterpart of ``repro.engine.driver``'s ``fit_plane`` — weighted Lloyd over
the partition representatives alternating with ε-proportional boundary
splitting, with the six stop criteria of Section 2.4.2 in the reference's
order — and of its ``plane_kmeans_parallel``, ``ll_bernoulli`` and
``resolve_ll_params``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import random as rnd
from repro_torch.core import bounds, lloyd as lloyd_mod
from repro_torch.core import bwkm as core_bwkm
from repro_torch.core import misassignment as mis
from repro_torch.core import partition as part_mod

__all__ = ["fit_plane", "ll_bernoulli", "plane_kmeans_parallel", "resolve_ll_params"]


def fit_plane(key, plane: Any, config: "core_bwkm.BWKMConfig", *, trace_centroids: bool = False):
    """Run BWKM over ``plane`` and return the plane's result.

    Stop criteria in evaluation order: boundary-empty, distance-budget,
    displacement (Thm A.4), gap-bound (Thm 2), capacity, max-iters.
    """
    n, d = plane.n_points, plane.dim
    p = config.resolve(n, d)
    k = config.k

    key, k_init, k_pp = plane.split_key(key)
    part = plane.build_partition(k_init, config, p)
    # initialisation cost (Alg 2): the dominant r·s·K + m·K term (Thm A.3)
    distances = float(p["r"] * p["s"] * k + p["m"] * k)

    reps, w = part_mod.representatives(part)
    c = core_bwkm.seed_centroids(config.init, k_pp, reps, w, k)
    distances += float(int(part.n_blocks)) * k  # seeding distance cost

    weighted_errors: list[float] = []
    n_blocks: list[int] = []
    boundary_sizes: list[int] = []
    trace: list[dict] = []
    stop_reason = "max-iters"

    displacement_eps_w = None
    if config.displacement_epsilon is not None:
        displacement_eps_w = bounds.displacement_threshold(
            plane.extent(part), n, config.displacement_epsilon
        )

    it = 0
    for it in range(1, config.max_iters + 1):
        res = lloyd_mod.weighted_lloyd(
            reps, w, c,
            max_iters=config.lloyd_max_iters, epsilon=config.lloyd_epsilon,
            prune=config.prune,
        )
        c = res.centroids
        distances += float(res.distances)
        weighted_errors.append(float(res.error))
        n_blocks.append(int(part.n_blocks))

        eps = mis.misassignment(part, res.d1, res.d2)
        f_size = int((eps > 0).sum())
        boundary_sizes.append(f_size)
        if trace_centroids:
            trace.append({
                "iteration": it,
                "distances": distances,
                "centroids": c.detach().cpu().numpy(),
                "n_blocks": int(part.n_blocks),
                "boundary": f_size,
                **plane.trace_extra(),
            })
        plane.on_iteration(it, c, part, distances)

        # --- stopping criteria (Section 2.4.2) ---
        if f_size == 0:
            stop_reason = "boundary-empty"  # Theorem 3 applies
            break
        if config.distance_budget is not None and distances >= config.distance_budget:
            stop_reason = "distance-budget"
            break
        if displacement_eps_w is not None and it > 1 and float(res.max_shift) <= displacement_eps_w:
            stop_reason = "displacement"
            break
        if config.gap_bound_threshold is not None:
            if float(bounds.thm2_gap_bound(part, eps, res.d1)) <= config.gap_bound_threshold:
                stop_reason = "gap-bound"
                break
        free_rows = p["capacity"] - int(part.n_blocks)
        if free_rows <= 0:
            stop_reason = "capacity"
            break

        # --- Step 3: sample |F| blocks ∝ ε with replacement, split, retighten
        key, k_cut = rnd.split(key)
        chosen = mis.sample_boundary(k_cut, eps, min(f_size, free_rows))
        plan = part_mod.split_plan(part, chosen)
        part = plane.route_round(part, plan, it)
        reps, w = part_mod.representatives(part)

    return plane.make_result(
        centroids=c,
        partition=part,
        iterations=it,
        distances=distances,
        weighted_errors=weighted_errors,
        n_blocks=n_blocks,
        boundary_sizes=boundary_sizes,
        stop_reason=stop_reason,
        trace=trace,
    )


# --------------------------------------------------- k-means|| (Bahmani 2012)
def resolve_ll_params(
    k: int, oversampling: int | None, rounds: int | None
) -> tuple[int, int, int]:
    """``(ℓ, rounds, cap_round)``. ``cap_round`` is the fixed per-round
    candidate capacity (``2ℓ`` rounded up to a multiple of 8): the number of
    accepted rows is random, so each round packs them into a fixed batch
    with a validity mask, truncating the rare overflow in acceptance order."""
    from repro_torch.core import kmeans_ll as core_ll

    l = int(oversampling) if oversampling is not None else core_ll.default_oversampling(k)  # noqa: E741
    r = int(rounds) if rounds is not None else 5
    if l < 1 or r < 1:
        raise ValueError(f"oversampling and rounds must be >= 1, got {l}, {r}")
    return l, r, max(8, -(-2 * l // 8) * 8)


def ll_bernoulli(u, w, mind2, l, phi):  # noqa: E741
    """The k-means|| oversampling draw: accept each row independently with
    probability ``min(1, ℓ·w·d²(x, C)/φ)``, in the reference's f32 order;
    zero-weight rows are never accepted."""
    p = torch.clamp(l * w * mind2 / torch.clamp(phi, min=1e-30), max=1.0)
    return (u < p) & (w > 0)


def plane_kmeans_parallel(sess: Any, *, rounds: int) -> dict:
    """The oversampling loop over an :class:`~repro_torch.engine.plane.LLSession`:
    per round, fold the pending batch so ``φ`` is exact, draw the round's
    acceptances, pack them as the next pending batch; then ``finish`` runs
    the weighting pass and the weighted K-means++ reduction."""
    sess.seed()
    normalisers: list[float] = []
    for r in range(1, rounds + 1):
        u, w, mind2, phi = sess.begin_round(r)
        normalisers.append(float(phi))
        sess.select(r, u, ll_bernoulli(u, w, mind2, sess.l, phi))
    return sess.finish(tuple(normalisers))
