"""The BWKM driver: paper Algorithm 5 over a data plane.

Counterpart of ``repro.engine.driver.fit_plane``: weighted Lloyd over the
partition representatives alternating with ε-proportional boundary
splitting, with the six stop criteria of Section 2.4.2 in the reference's
order.
"""

from __future__ import annotations

from typing import Any

from repro_torch import random as rnd
from repro_torch.core import bounds, lloyd as lloyd_mod
from repro_torch.core import bwkm as core_bwkm
from repro_torch.core import misassignment as mis
from repro_torch.core import partition as part_mod

__all__ = ["fit_plane"]


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
