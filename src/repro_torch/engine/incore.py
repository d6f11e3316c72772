"""In-core data plane and k-means|| session: the dataset is one resident tensor.

Counterpart of ``repro.engine.incore``'s ``InCorePlane`` and
``InCoreLLSession``. Memberships live in ``Partition.block_id``; a split
round is one routing pass plus one
:func:`~repro_torch.core.partition.block_stats` pass. Non-finite rows are
quarantined up front (one NaN row would poison every centroid); the filter
is a function of the data alone, so reruns are bit-identical.
"""

from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core import bwkm as core_bwkm
from repro_torch.core import init_partition, kmeanspp
from repro_torch.core import kmeans_ll as core_ll
from repro_torch.core import partition as part_mod
from repro_torch.core.partition import Partition, SplitPlan
from repro_torch.health import RunHealth
from repro_torch.kernels import ops
from repro_torch.kernels.ref import _BIG

__all__ = ["InCoreLLSession", "InCorePlane"]


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


class InCoreLLSession:
    """Resident k-means|| session: the min-d² state and the candidates stay
    on the data's device.

    Keys follow the reference: ``keys[0]`` draws the weighted first seed,
    ``keys[rnd]`` round ``rnd``'s uniforms, ``keys[-1]`` the final K-means++
    reduction. Every fold is one ``ops.min_sqdist_update`` (kernel B5 on
    CUDA): the seed, each round's pending batch, and the last batch in
    ``finish`` — ``rounds + 1`` folds.
    """

    def __init__(self, key, x, w, *, k, l, rounds, cap_round):  # noqa: E741
        self.x = x
        self.w = w.float()
        self.k, self.l, self.rounds, self.cap_round = k, l, rounds, cap_round
        self.keys = rnd.split(key, rounds + 2)
        self.n, self.d = x.shape
        cap_total = 1 + rounds * cap_round
        self.cand = torch.full((cap_total, self.d), core_ll._FAR, dtype=x.dtype, device=x.device)
        self.cvalid = torch.zeros(cap_total, dtype=torch.float32, device=x.device)
        self.cvalid[0] = 1.0
        self.pending = None  # (newc, newv): selected but not yet folded

    def seed(self) -> None:
        first = self.x[rnd.categorical(self.keys[0], kmeanspp._log_weights(self.w))]
        self.cand[0] = first
        out = ops.min_sqdist_update(
            self.x, self.w, self.cand[:1], self.cvalid[:1],
            torch.full((self.n,), _BIG, dtype=torch.float32, device=self.x.device),
        )
        self.mind2, self.phi, self.n_dist = out.mind2, out.cost, out.n_dist

    def _fold_pending(self) -> None:
        newc, newv = self.pending
        out = ops.min_sqdist_update(self.x, self.w, newc, newv, self.mind2)
        self.mind2, self.phi = out.mind2, out.cost
        self.n_dist = self.n_dist + out.n_dist
        self.pending = None

    def begin_round(self, rnd_index: int):
        if self.pending is not None:
            self._fold_pending()
        u = rnd.uniform(self.keys[rnd_index], (self.n,), device=self.x.device)
        return u, self.w, self.mind2, self.phi

    def select(self, rnd_index: int, u, accept) -> None:
        # the round's accepted rows in acceptance-priority order (smallest
        # uniform first: the draws any smaller probability would also keep)
        neg, idx = torch.topk(-torch.where(accept, u, float("inf")), self.cap_round)
        newv = torch.isfinite(neg).float()
        newc = self.x[idx]
        start = 1 + (rnd_index - 1) * self.cap_round
        self.cand[start : start + self.cap_round] = torch.where(newv[:, None] > 0, newc, core_ll._FAR)
        self.cvalid[start : start + self.cap_round] = newv
        self.pending = (newc, newv)

    def finish(self, normalisers: tuple) -> dict:
        if self.pending is not None:
            self._fold_pending()
        # weighting pass: each candidate takes the weight of the rows closest
        # to it; parked rows attract nothing and weigh 0
        au = ops.assign_update(self.x, self.w, self.cand)
        n_valid = self.cvalid.sum()
        n_active = (self.w > 0).float().sum()
        n_dist = self.n_dist + n_active * n_valid  # valid columns only
        n_dist = n_dist + n_valid * max(self.k - 1, 1)  # K-means++ reduction
        c = kmeanspp.weighted_kmeanspp(self.keys[-1], self.cand, au.counts, self.k)
        return {
            "centroids": c,
            "n_candidates": n_valid,
            "distances": n_dist,
            "passes": self.rounds + 2,
            "normalisers": normalisers,
        }
