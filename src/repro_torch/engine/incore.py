"""In-core data plane: the dataset is one resident tensor.

Counterpart of ``repro.engine.incore.InCorePlane``. Memberships live in
``Partition.block_id``; a split round is one routing pass plus one
:func:`~repro_torch.core.partition.block_stats` pass. Non-finite rows are
quarantined up front (one NaN row would poison every centroid); the filter
is a function of the data alone, so reruns are bit-identical.
"""

from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core import bwkm as core_bwkm
from repro_torch.core import init_partition
from repro_torch.core import partition as part_mod
from repro_torch.core.partition import Partition, SplitPlan
from repro_torch.health import RunHealth

__all__ = ["InCorePlane"]


class InCorePlane:
    """Resident-tensor execution plane (``engine="incore"``)."""

    name = "incore"

    def __init__(self, x: torch.Tensor):
        health = RunHealth()
        finite_rows = torch.isfinite(x).all(dim=1)
        n_bad = int(x.shape[0] - finite_rows.sum())
        if n_bad:
            health.quarantined_rows = n_bad
            x = x[finite_rows]
            if x.shape[0] == 0:
                raise ValueError("every input row was non-finite; nothing to cluster")
        self.x = x
        self.run_health = health

    @property
    def n_points(self) -> int:
        return int(self.x.shape[0])

    @property
    def dim(self) -> int:
        return int(self.x.shape[1])

    def split_key(self, key):
        key, k_init, k_pp = rnd.split(key, 3)
        return key, k_init, k_pp

    def build_partition(self, k_init, config, p) -> Partition:
        return init_partition.build_initial_partition(
            k_init, self.x, config.k,
            m=p["m"], m_prime=p["m_prime"], s=p["s"], r=p["r"], capacity=p["capacity"],
        )

    def extent(self, part: Partition) -> float:
        return float(torch.linalg.vector_norm(self.x.amax(0) - self.x.amin(0)))

    def route_round(self, part: Partition, plan: SplitPlan, round_index: int) -> Partition:
        new_bid = part_mod.route_split(self.x, part.block_id, plan)
        out = part_mod.apply_split_plan(part._replace(block_id=new_bid), plan)
        return part_mod.recompute_stats(out, self.x)

    def on_iteration(self, it, c, part, distances) -> None:
        pass

    def trace_extra(self) -> dict:
        return {}

    def make_result(self, **fields) -> core_bwkm.BWKMResult:
        return core_bwkm.BWKMResult(health=self.run_health, **fields)
