"""The protocols the driver is written against. Counterparts of
``DataPlane`` and ``LLSession`` of ``repro.engine.plane``.

A plane owns the dataset in its layout and exposes the few data-touching
steps that :func:`repro_torch.engine.driver.fit_plane` is written against; a
k-means|| session does the same for
:func:`~repro_torch.engine.driver.plane_kmeans_parallel`. Everything
algorithmic lives in the driver. The port has one of each so far,
:class:`repro_torch.engine.incore.InCorePlane` and
:class:`~repro_torch.engine.incore.InCoreLLSession`.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core.partition import Partition, SplitPlan
from repro_torch.health import RunHealth

__all__ = ["DataPlane", "LLSession"]


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
