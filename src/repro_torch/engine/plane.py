"""The protocols the driver is written against. Counterparts of
``DataPlane``, ``LLSession``, ``LloydSession`` and ``global_extent`` of
``repro.engine.plane``.

A plane owns the dataset in its layout and exposes the few data-touching
steps that :func:`repro_torch.engine.driver.fit_plane` is written against; a
k-means|| session does the same for
:func:`~repro_torch.engine.driver.plane_kmeans_parallel`, and a Lloyd
session for :func:`~repro_torch.engine.driver.plane_lloyd`. Everything
algorithmic lives in the driver. The port has the in-core plane and
k-means|| session (:mod:`repro_torch.engine.incore`) and the streaming
plane and sessions (:mod:`repro_torch.engine.streaming`).
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core.partition import Partition, SplitPlan
from repro_torch.health import RunHealth

__all__ = ["DataPlane", "LLSession", "LloydSession", "global_extent"]

_BIG = 3.0e38


def global_extent(part: Partition) -> float:
    """``‖max x − min x‖`` over the whole dataset, from the blocks' boxes:
    the displacement threshold's scale without a pass over the data."""
    occ = ((part.count > 0) & part.active)[:, None]
    lo = torch.where(occ, part.lo, _BIG).amin(0)
    hi = torch.where(occ, part.hi, -_BIG).amax(0)
    return float(torch.linalg.vector_norm(torch.clamp(hi - lo, min=0.0)))


@runtime_checkable
class DataPlane(Protocol):
    name: str
    run_health: RunHealth

    @property
    def n_points(self) -> int: ...

    @property
    def dim(self) -> int: ...

    def split_key(self, key) -> tuple[Any, Any, Any]:
        """``(carry_key, k_init, k_pp)``: the keys the plane's driver consumes."""
        ...

    def build_partition(self, k_init, config: Any, p: dict) -> Partition:
        """Initial partition (paper Algorithm 2) with every point's statistics."""
        ...

    def extent(self, part: Partition) -> float:
        """Dataset extent for the Theorem-A.4 displacement threshold."""
        ...

    def route_round(self, part: Partition, plan: SplitPlan, round_index: int) -> Partition:
        """Route points against ``plan``, activate the new rows and
        re-tighten every block's statistics."""
        ...

    def on_iteration(self, it: int, c: torch.Tensor, part: Partition, distances: float) -> None:
        """Hook after Lloyd and the misassignment, before the stop checks."""
        ...

    def trace_extra(self) -> dict: ...

    def make_result(self, **fields: Any) -> Any: ...


class LLSession(Protocol):
    """One k-means|| seeding run over a plane.

    The driver calls ``seed()`` once, then per round ``begin_round`` → the
    shared Bernoulli draw → ``select``, then ``finish``. The session owns
    the candidates, the min-d² state and its keys; ``begin_round`` folds the
    pending candidate batch first, so ``phi`` is the exact current cost.
    """

    l: int  # noqa: E741 — ℓ, the oversampling factor (Bahmani et al.)

    def seed(self) -> None: ...

    def begin_round(self, rnd: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(u, w, mind2, phi)``: per-row uniforms, weights and min squared
        distances, and the exact normaliser."""
        ...

    def select(self, rnd: int, u: torch.Tensor, accept: torch.Tensor) -> None: ...

    def finish(self, normalisers: tuple) -> dict: ...


class LloydSession(Protocol):
    """One full-data Lloyd run over a plane.

    ``seed`` runs the dense pass and returns the folded statistics and the
    Σ w‖x‖² term of the error identity; ``step`` runs one pruned (or dense)
    round against the new centroids. Per-row bound state stays inside the
    session between calls.
    """

    denom: float  # active-fraction denominator: max(k · n_points, 1)

    def seed(self, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float]:
        """``(sums, counts, err, w2sum, n_dist)``."""
        ...

    def step(self, c_new: torch.Tensor, drift: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, float]:
        """``(sums, counts, n_dist)`` under the composed assignment."""
        ...
