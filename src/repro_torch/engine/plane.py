"""The ``DataPlane`` protocol — what an execution plane provides to the driver.

Counterpart of the ``DataPlane`` of ``repro.engine.plane``. A plane owns the
dataset in its layout and exposes the few data-touching steps that
:func:`repro_torch.engine.driver.fit_plane` is written against; everything
algorithmic lives in the driver. The port has one plane so far,
:class:`repro_torch.engine.incore.InCorePlane`.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core.partition import Partition, SplitPlan
from repro_torch.health import RunHealth

__all__ = ["DataPlane"]


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
