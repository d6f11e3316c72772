"""BWKM — Boundary Weighted K-means (paper Algorithm 5): config, result and
the in-core entry point.

Counterpart of ``repro.core.bwkm``. The algorithm itself lives once in
:func:`repro_torch.engine.driver.fit_plane`. Stop reasons (Section 2.4.2):
``boundary-empty``, ``distance-budget``, ``displacement`` (Theorem A.4),
``gap-bound`` (Theorem 2), ``capacity`` and ``max-iters``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from repro_torch.core import init_partition
from repro_torch.core.partition import Partition
from repro_torch.health import RunHealth

__all__ = ["BWKMConfig", "BWKMResult", "fit_incore", "seed_centroids"]


def seed_centroids(name: str, key, reps: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Seed K centroids from the weighted representatives through the named
    strategy of ``repro_torch.api.inits``; a strategy that ignores the
    weights warns."""
    from repro_torch.api.inits import resolve_init

    strategy = resolve_init(name)
    if not strategy.supports_weights:
        warnings.warn(
            f"init strategy {strategy.name!r} ignores point weights; BWKM "
            "representatives are seeded as if unweighted",
            UserWarning,
            stacklevel=2,
        )
    return strategy.seed_centroids(key, reps, w, k)


@dataclasses.dataclass(frozen=True)
class BWKMConfig:
    """Knobs for Algorithm 5; ``m/m_prime/s/r`` default to the paper's values
    (Section 2.4.1)."""

    k: int
    m: int | None = None
    m_prime: int | None = None
    s: int | None = None
    r: int = 5
    capacity: int | None = None  # max blocks; default 64·m
    max_iters: int = 30  # BWKM outer iterations
    lloyd_max_iters: int = 100
    lloyd_epsilon: float = 1e-4
    distance_budget: float | None = None
    displacement_epsilon: float | None = None  # Thm A.4's ε (on E^D scale)
    gap_bound_threshold: float | None = None  # Thm 2 stopping threshold
    init: str = "kmeans++"  # seeding strategy (repro_torch.api.inits)
    init_sample_size: int | None = None  # streaming first-pass sample rows;
    # None = the engine's default (the in-core engine has no such pass)
    prune: bool | None = None  # drift-bound pruned Lloyd; None = default (on)

    def resolve(self, n: int, d: int) -> dict[str, Any]:
        p = init_partition.default_params(n, self.k, d)
        m = self.m or p["m"]
        return {
            "m": m,
            "m_prime": self.m_prime or max(self.k + 1, m // 10),
            "s": self.s or p["s"],
            "r": self.r,
            "capacity": self.capacity or max(64 * m, 4 * self.k),
        }


@dataclasses.dataclass
class BWKMResult:
    centroids: torch.Tensor
    partition: Partition
    iterations: int
    distances: float  # total distance computations (the paper's cost unit)
    weighted_errors: list[float]  # per outer iteration
    n_blocks: list[int]
    boundary_sizes: list[int]
    stop_reason: str
    trace: list[dict]
    health: RunHealth | None = None


def fit_incore(key, x: torch.Tensor, config: BWKMConfig, *, trace_centroids: bool = False) -> BWKMResult:
    """Run BWKM on the resident ``x [n, d]``: the driver over the in-core plane."""
    from repro_torch.engine import driver, incore

    return driver.fit_plane(key, incore.InCorePlane(x), config, trace_centroids=trace_centroids)
