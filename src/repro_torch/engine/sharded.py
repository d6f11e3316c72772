"""Sharded data plane: the dataset's rows split over the batch ranks of a
mesh, and its features over the model ranks.

Counterpart of ``repro.engine.sharded``, SPMD over ``torch.distributed``.
Every rank runs the same driver (:func:`repro_torch.engine.driver.fit_plane`)
with the same key on its part of the data (:func:`shard_points`). What the
reference computes replicated — representatives, Lloyd over them, split
plans, draws, the final K-means++ — every rank computes from all-reduced
statistics, so the ranks hold the same state without sending it. Points
never leave their rank; a round moves O(M·d) statistics.

Layout (the reference's ``("batch", "tensor")``). The rows go over the
batch axes, ``("pod", "data")`` pod-major: batch rank ``b`` of ``B``
(:func:`n_data_shards`) holds the ``b``-th contiguous block. Where the
``"model"`` dimension's M > 1 divides d, model rank ``j`` holds the columns
``[j·d/M, (j+1)·d/M)`` of its batch rank's rows, a :class:`FeatureSlice`;
elsewhere every model rank holds them whole, the reference's rule that
drops an axis that does not divide. Any other layout raises.

Block statistics (:func:`_recompute_stats_ok`). Each rank folds its rows
into :func:`~repro_torch.core.partition.block_stats`' fixed-point form
under one scale from the global row count and the global per-feature
maximum; the int64 sums and counts add exactly over the batch ranks, and
the boxes combine as integers. On a feature split each rank folds its own
columns (the scale is per feature), and the int64 sums and box keys of
the columns are gathered over ``"model"``. The statistics on any mesh are
therefore bit-equal to one ``block_stats`` over all rows with the same
memberships, and a BWKM fit is the same on every mesh. A batch shard whose
rows are not finite in any column contributes nothing, on every model rank
(the reference's sanitising ``_stats_body``), and the round reweights the
surviving mass (:func:`_apply_shard_loss`).

No rank raises alone: a rank that raised while the others wait in a
collective would hang the group, so :class:`ShardLossError` and every other
abort is decided from all-reduced values, the same on every rank.

Routing after a split needs one value a row, its block's split column: on
a feature split the rank that owns the column supplies it and a SUM over
``"model"`` of ``[n_local]`` f32 delivers it. The passes that need whole
rows — routing into the sample's boxes, and the full-data passes
(:class:`ShardedLloydSession`, :class:`ShardedLLSession`,
:func:`dist_assign_step`) — gather the rank's rows whole over ``"model"``
and run on them, as the reference's ``in_specs`` ``("batch", None)`` do: the
work is repeated on each model rank of a batch group. The kernel passes —
B2/B3 for Lloyd, B5 for the k-means|| fold, B2 (or B1 then B4) for its
weighting pass — take the rows in one piece and add their f32 partials
over the batch ranks in rank order, so they repeat bit for bit on a given
mesh, and a mesh with M model ranks gives the bits of the one with M = 1.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import bwkm as core_bwkm
from repro_torch.core import init_partition, kmeanspp
from repro_torch.core import kmeans_ll as core_ll
from repro_torch.core import lloyd as lloyd_mod
from repro_torch.core import partition as part_mod
from repro_torch.core.partition import FixedBlockStats, Partition, SplitPlan
from repro_torch.device import as_points, resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.engine.plane import global_extent
from repro_torch.health import RunHealth
from repro_torch.kernels import ops

__all__ = [
    "DistLloydResult",
    "FeatureSlice",
    "ShardLossError",
    "ShardedLLSession",
    "ShardedLloydSession",
    "ShardedPlane",
    "dist_assign_step",
    "dist_recompute_stats",
    "dist_route_points",
    "n_data_shards",
    "shard_points",
]

_BIG = 3.0e38
#: bytes of whole rows gathered over "model" at a time to route into boxes
ROUTE_GATHER_BYTES = 64 << 20


class ShardLossError(RuntimeError):
    """Shard-stat losses in one round exceeded ``max_shard_loss_frac``:
    drop-and-reweight would no longer be a defensible approximation, so the
    round aborts, on every rank, instead of fitting a sliver of the data."""


def n_data_shards() -> int:
    """Number of data-parallel shards on the current mesh, pod × data (1
    when unmeshed)."""
    return sh.group_size(sh.batch_axes())


class FeatureSlice(torch.Tensor):
    """This rank's columns of its rows, ``[n_local, d/M]``: what
    :func:`shard_points` returns where the ``"model"`` dimension's M > 1
    divides d. The type carries the layout through torch's operations (a
    slice, ``.to``), as a subclass's does; the engine's functions read it,
    and take a plain tensor as whole rows."""


def _layout(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(rows, m)``: ``x`` as a plain tensor, and the model ranks its
    columns are split over (1: whole rows). Raises on a layout the port
    does not take: a :class:`FeatureSlice` without a model axis, or whole
    rows that the model axis would split. The rule reads only the mesh and
    ``x``, so ranks that placed their data alike decide alike."""
    m = sh.axis_size(sh.MODEL)
    if isinstance(x, FeatureSlice):
        if m == 1:
            raise ValueError("a FeatureSlice holds a rank's columns over a 'model' dimension "
                             "of more than one rank; the current mesh has none")
        return x.as_subclass(torch.Tensor), m
    if m > 1 and x.shape[1] % m == 0:
        raise ValueError(f"whole rows of {x.shape[1]} features on a 'model' dimension of {m} "
                         "ranks, which splits them: place the data with shard_points")
    return x, 1


def _columns(d: int) -> tuple[int, int]:
    """``[start, stop)`` of this rank's columns of ``d`` features: its
    model rank's ``d/M`` where M divides d, all of them elsewhere."""
    if sh._dim_spec(sh.MODEL, d) is None:
        return 0, d
    m, j = sh.axis_size(sh.MODEL), sh.group_rank((sh.MODEL,))
    return j * d // m, (j + 1) * d // m


def _whole_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows whole ``[n, d]``, in one piece: on a feature split
    its columns gathered over ``"model"`` as bytes, each entry's from its
    one owner, so exactly (signed zeros included); else ``x``."""
    x, m = _layout(x)
    if m == 1:
        return x
    parts = sh._gather(x.contiguous().view(torch.uint8), axes=(sh.MODEL,))  # [M, n, bytes]
    return parts.permute(1, 0, 2).reshape(x.shape[0], m * parts.shape[2]).view(x.dtype)


def _gather_rows(x: torch.Tensor, rows: torch.Tensor, offset: int, width: int):
    """``[len(rows), width]``: the rows ``rows`` (global, sorted) of the
    dataset on every rank. Each rank fills its own columns of its own rows
    and one SUM of the bytes over the ranks that hold parts delivers them,
    exactly (one non-zero term an entry)."""
    x, m = _layout(x)
    es = x.element_size()
    mine = (rows >= offset) & (rows < offset + x.shape[0])
    c0 = 0 if m == 1 else sh.group_rank((sh.MODEL,)) * x.shape[1]
    out = torch.zeros(rows.shape[0], width * es, dtype=torch.uint8, device=x.device)
    out[mine, c0 * es : (c0 + x.shape[1]) * es] = x[rows[mine] - offset].view(torch.uint8)
    axes = sh.batch_axes() + ((sh.MODEL,) if m > 1 else ())
    return sh._all_reduce(out, axes=axes).view(x.dtype)


def _block(n: int, shards: int, rank: int) -> tuple[int, int]:
    """``[start, stop)`` of rank ``rank``'s rows: as even as possible, the
    first ``n mod shards`` ranks one row more."""
    base, extra = divmod(n, shards)
    start = rank * base + min(rank, extra)
    return start, start + base + (rank < extra)


def _rank_device() -> torch.device:
    """``cuda:(local rank mod cards)`` on a mesh (``LOCAL_RANK`` where a
    launcher sets it, else the rank over every mesh dimension); the current
    card without one."""
    if sh.current_mesh() is None:
        return resolve_device("cuda")
    resolve_device("cuda")  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", sh._process_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def shard_points(x, device=None) -> torch.Tensor:
    """This rank's part of ``x [n, d]`` (a tensor or an array; all of it
    without a mesh) on ``device``, by default ``cuda:(local rank mod
    cards)``; f32 unless it is bf16. The part is its batch rank's
    contiguous block of rows (pod-major over ``("pod", "data")``) and,
    where the ``"model"`` dimension's M > 1 divides d, its model rank's
    contiguous ``d/M`` columns of them, a :class:`FeatureSlice`; else the
    rows whole. Only the part is copied to the device."""
    dev = _rank_device() if device is None else resolve_device(device)
    n, d = int(x.shape[0]), int(x.shape[1])
    start, stop = _block(n, n_data_shards(), sh._mesh_rank())
    c0, c1 = _columns(d)
    if isinstance(x, torch.Tensor):
        part = x.as_subclass(torch.Tensor)[start:stop, c0:c1]
    else:
        part = torch.from_numpy(np.array(np.asarray(x)[start:stop, c0:c1]))
    part = as_points(part).to(dev).contiguous()
    return part.as_subclass(FeatureSlice) if c1 - c0 < d else part


# ------------------------------------------------------------ statistics
def _recompute_stats_ok(
    part: Partition,
    x: torch.Tensor,
    bid: torch.Tensor,
    alive_rows: torch.Tensor | None = None,
    *,
    n: int | None = None,
) -> tuple[Partition, int]:
    """:func:`dist_recompute_stats` plus the number of batch shards whose
    rows were finite (the drop-and-reweight round needs it). ``n`` is the
    row count over all ranks, found here when not given."""
    x, split = _layout(x)
    m, d = part.capacity, x.shape[1]
    dev = x.device
    if n is None:
        n = sh._row_block(x.shape[0], dev)[0]
    valid = None if alive_rows is None else alive_rows > 0
    xm, bidm, seg = part_mod._masked(x, bid, m, valid)
    ok = torch.isfinite(xm).all().reshape(1)
    if split > 1:  # a batch shard's rows count whole or not at all
        ok = sh._all_reduce(ok.int(), "min", axes=(sh.MODEL,)) > 0
    amax = xm.abs().amax(0) if xm.shape[0] else torch.zeros(d, device=dev)
    # a rank whose rows are not finite sets no scale and adds nothing
    amax = sh._all_reduce(torch.where(ok, amax, 0.0), "max")
    scale = part_mod.fixed_point_scale(amax, n)
    st = part_mod._fixed(xm, bidm, seg, m, scale)
    summed = sh._all_reduce(torch.cat([
        torch.where(ok, st.qsum, 0).reshape(-1),
        torch.where(ok, st.count, 0),
        ok.long(),
    ]))
    keys = sh._all_reduce(
        part_mod.box_keys(torch.where(ok, st.lo, _BIG), torch.where(ok, st.hi, -_BIG)), "min"
    )
    qsum = summed[: m * d].view(m, d)
    if split > 1:  # the columns of every model rank, as integers: exact
        qsum, keys, scale = _gather_columns(qsum, keys, scale, split)
    lo, hi = part_mod.boxes_from_keys(keys)
    out = part_mod.from_fixed(FixedBlockStats(qsum, summed[m * d : m * d + m], lo, hi), scale)
    part = part._replace(psum=out.psum, count=out.count, lo=out.lo, hi=out.hi, block_id=bid)
    return part, int(summed[-1])


def _gather_columns(qsum: torch.Tensor, keys: torch.Tensor, scale: torch.Tensor, split: int):
    """The fixed-point sums ``[M, d/s]``, box keys ``[2, M, d/s]`` and
    scales ``[d/s]`` of this rank's columns put together with the other
    model ranks' in column order, in one gather of their int64 bits."""
    m, dl = qsum.shape
    g = sh._gather(torch.cat([qsum.reshape(-1), keys.reshape(-1), scale.view(torch.int64)]),
                   axes=(sh.MODEL,))  # [s, 3·M·dl + dl]
    qsum = g[:, : m * dl].reshape(split, m, dl).permute(1, 0, 2).reshape(m, split * dl)
    keys = g[:, m * dl : 3 * m * dl].reshape(split, 2, m, dl).permute(1, 2, 0, 3)
    scale = g[:, 3 * m * dl :].reshape(-1).view(torch.float64)
    return qsum, keys.reshape(2, m, split * dl), scale


def dist_recompute_stats(
    part: Partition,
    x: torch.Tensor,
    bid: torch.Tensor,
    alive_rows: torch.Tensor | None = None,
) -> Partition:
    """``(Σx, count, lo, hi)`` of every block over the rows of all ranks,
    each rank passing its own ``x`` and ``bid``; ``alive_rows`` (f32 0/1
    per local row) drops rows from the fold, the row-level form of "this
    shard's statistics are lost this round"."""
    return _recompute_stats_ok(part, x, bid, alive_rows)[0]


def _route_split(x: torch.Tensor, bid: torch.Tensor, plan: SplitPlan) -> torch.Tensor:
    """``partition.route_split`` on this rank's rows. On a feature split
    each row's value on its block's split axis comes from the model rank
    that owns the column, delivered by one SUM over ``"model"`` of
    ``[n_local]`` f32 (one non-zero term a row)."""
    x, split = _layout(x)
    if split == 1:
        return part_mod.route_split(x, bid, plan)
    dl = x.shape[1]
    col = plan.axis[bid.long()] - sh.group_rank((sh.MODEL,)) * dl
    mine = (col >= 0) & (col < dl)
    vals = x.gather(1, col.clamp(0, dl - 1)[:, None])[:, 0].float()
    vals = sh._all_reduce(torch.where(mine, vals, 0.0), axes=(sh.MODEL,))
    return part_mod.route_split(None, bid, plan, values=vals)


def dist_route_points(x: torch.Tensor, bid: torch.Tensor, fits, axis, mid, right_row) -> torch.Tensor:
    """Each rank's memberships after a split round: ``partition.route_split``
    on its own rows (the plan is replicated); on a feature split only each
    row's split column moves."""
    plan = SplitPlan(fits, axis, mid, right_row, fits.sum(dtype=torch.int32))
    return _route_split(x, bid, plan)


def dist_assign_step(x: torch.Tensor, c: torch.Tensor, w: torch.Tensor | None = None):
    """One Lloyd iteration over the rows of all ranks, ``(new_c, error)``:
    the fused pass on each rank's whole rows (B2 on the card; on a feature
    split every model rank runs it), its statistics added over the batch
    ranks in rank order."""
    x = _whole_rows(x)
    w = torch.ones(x.shape[0], device=x.device) if w is None else w.float()
    fu = ops.assign_update(x, w, c)
    sums, counts, err = sh._sum_over_ranks(fu.sums, fu.counts, fu.err)
    return lloyd_mod._next_centroids(sums, counts, c), err


# ------------------------------------------- pruned distributed Lloyd
class DistLloydResult(NamedTuple):
    centroids: torch.Tensor  # [K, d], the same on every rank
    error: float  # exact weighted error at the final centroids
    iters: int
    distances: float  # kernel-reported, summed over shards


class ShardedLloydSession:
    """Full-data Lloyd over the ranks' rows, the bound state on each rank.

    The mesh form of ``core.lloyd.weighted_lloyd``'s pruned loop: each
    rank keeps (assignment, upper, lower) of its own rows across
    iterations; the drift is replicated for free, since every rank computes
    the same centroids from the same combined statistics. ``seed`` is B2
    per rank; ``step`` B3 (pruned) or B2 (dense). Pruned and dense reach
    the same centroids bit for bit. On a feature split the rank's rows are
    gathered whole once, for the session, and every model rank runs the
    passes on them.
    """

    def __init__(self, x: torch.Tensor, w: torch.Tensor | None, *, k: int, prune: bool):
        x = self.x = _whole_rows(x)
        self.k = k
        self.prune = prune
        self.w = torch.ones(x.shape[0], device=x.device) if w is None else w.float()
        self.denom = max(k * sh._row_block(x.shape[0], x.device)[0], 1)

    def seed(self, c: torch.Tensor):
        fu = ops.assign_update(self.x, self.w, c)
        w2 = (self.w * (self.x.float() ** 2).sum(-1)).sum()
        self.assign = fu.assign
        self.ub, self.lb = lloyd_mod._sqrt0(fu.d1), lloyd_mod._sqrt0(fu.d2)
        sums, counts, err, w2sum, n_dist = sh._sum_over_ranks(
            fu.sums, fu.counts, fu.err, w2, fu.n_dist
        )
        return sums, counts, err, w2sum, float(n_dist)

    def step(self, c_new: torch.Tensor, drift: torch.Tensor):
        if self.prune:
            ub, lb = lloyd_mod.drift_bound_update(self.ub, self.lb, self.assign, drift)
            active = ub >= lb
            fu = ops.assign_update_pruned(self.x, self.w, c_new, self.assign, active)
            self.ub = torch.where(active, lloyd_mod._sqrt0(fu.d1), ub)
            self.lb = torch.where(active, lloyd_mod._sqrt0(fu.d2), lb)
        else:
            fu = ops.assign_update(self.x, self.w, c_new)
        self.assign = fu.assign
        sums, counts, n_dist = sh._sum_over_ranks(fu.sums, fu.counts, fu.n_dist)
        return sums, counts, float(n_dist)


# ------------------------------------------------------- k-means|| session
class ShardedLLSession:
    """k-means|| over the ranks' rows.

    Each rank keeps the min-d² of its own rows; every fold is B5 on each
    rank with the cost ``φ`` added over the ranks in rank order. The draws
    do not depend on W: the first seed is a categorical draw over all rows'
    weights (gathered once), and each round every rank draws the uniforms
    of all ``n`` rows from the same key and takes its own slice. A round's
    batch is each rank's accepted rows, smallest uniform first, gathered
    and merged by (uniform, global row): the global top-``cap_round`` with
    the reference's first-index rule for ties. The weighting pass and the
    final weighted K-means++ run on replicated values, so every rank ends
    with the same seeds. Keys follow the in-core session. On a feature
    split the rank's rows are gathered whole once, for the session: every
    model rank of a batch group runs the folds and holds the same min-d²,
    and the row fetches read the whole rows.
    """

    def __init__(self, key, x, w, *, k, l, rounds, cap_round):  # noqa: E741
        x = self.x = _whole_rows(x)
        self.w = w.float()
        self.k, self.l, self.rounds, self.cap_round = k, l, rounds, cap_round
        self.keys = rnd.split(key, rounds + 2)
        self.n_local, self.d = x.shape
        self.n, self.offset = sh._row_block(self.n_local, x.device)
        cap_total = 1 + rounds * cap_round
        self.cand = torch.full((cap_total, self.d), core_ll._FAR, dtype=x.dtype, device=x.device)
        self.cvalid = torch.zeros(cap_total, device=x.device)
        self.cvalid[0] = 1.0
        self.pending = None  # (newc, newv): selected but not yet folded

    def _fold(self, cand, cvalid, mind2) -> None:
        out = ops.min_sqdist_update(self.x, self.w, cand, cvalid, mind2)
        self.mind2 = out.mind2
        (self.phi,) = sh._sum_over_ranks(out.cost)

    def seed(self) -> None:
        w_all = torch.zeros(self.n, device=self.x.device)
        w_all[self.offset : self.offset + self.n_local] = self.w
        first = int(rnd.categorical(self.keys[0], kmeanspp._log_weights(sh._all_reduce(w_all))))
        row = torch.zeros(self.d, dtype=self.x.dtype, device=self.x.device)
        if self.offset <= first < self.offset + self.n_local:
            row = self.x[first - self.offset].clone()
        self.cand[0] = sh._all_reduce(row)
        mind2 = torch.full((self.n_local,), _BIG, device=self.x.device)
        self._fold(self.cand[:1], self.cvalid[:1], mind2)

    def begin_round(self, rnd_index: int):
        if self.pending is not None:
            self._fold(*self.pending, self.mind2)
            self.pending = None
        u = rnd.uniform(self.keys[rnd_index], (self.n,), device=self.x.device)
        return u[self.offset : self.offset + self.n_local], self.w, self.mind2, self.phi

    def select(self, rnd_index: int, u, accept) -> None:
        cap, d = self.cap_round, self.d
        idx = accept.nonzero()[:, 0]  # ascending row order
        idx = idx[torch.sort(u[idx], stable=True).indices[:cap]]
        # this rank's slot: (uniform, global row, row), inf where unfilled
        slot = torch.full((cap, 2 + d), float("inf"), dtype=torch.float64, device=self.x.device)
        slot[: idx.shape[0], 0] = u[idx].double()
        slot[: idx.shape[0], 1] = (idx + self.offset).double()
        slot[: idx.shape[0], 2:] = self.x[idx].double()
        every = sh._gather(slot).reshape(-1, 2 + d)
        every = every[torch.sort(every[:, 1], stable=True).indices]
        every = every[torch.sort(every[:, 0], stable=True).indices[:cap]]
        newv = torch.isfinite(every[:, 0]).float()
        newc = torch.where(newv[:, None] > 0, every[:, 2:], core_ll._FAR).to(self.x.dtype)
        start = 1 + (rnd_index - 1) * cap
        self.cand[start : start + cap] = newc
        self.cvalid[start : start + cap] = newv
        self.pending = (newc, newv)

    def finish(self, normalisers: tuple) -> dict:
        if self.pending is not None:
            self._fold(*self.pending, self.mind2)
            self.pending = None
        # weighting pass: each candidate takes the weight of the rows closest
        # to it, over all ranks
        (counts,) = sh._sum_over_ranks(ops.assign_update(self.x, self.w, self.cand).counts)
        c = kmeanspp.weighted_kmeanspp(self.keys[-1], self.cand, counts, self.k)
        return {
            "centroids": c,
            "n_candidates": self.cvalid.sum(),
            "distances": 0.0,  # the mesh path reports no count, as the reference's
            "passes": self.rounds + 2,
            "normalisers": normalisers,
        }


# ------------------------------------------------------------------ plane
def _route_into_boxes(x: torch.Tensor, part: Partition) -> torch.Tensor:
    """Each rank's rows routed into the replicated boxes by
    ``partition.route_into_boxes``' clipped-L∞ rule, against the live
    prefix ``[0, n_blocks)`` rounded up to a multiple of 128, not the whole
    capacity (the rows past it are inactive and never win). On a feature
    split the rows are gathered whole over ``"model"``
    :data:`ROUTE_GATHER_BYTES` at a time (a row's box depends on that row
    alone) and every model rank routes them."""
    m_live = min(part.capacity, max(128, -(-int(part.n_blocks) // 128) * 128))
    boxes = part.lo[:m_live], part.hi[:m_live], part.active[:m_live]
    plain, split = _layout(x)
    if split == 1:
        return part_mod.route_into_boxes(plain, *boxes)
    rows = max(1, ROUTE_GATHER_BYTES // (plain.shape[1] * split * plain.element_size()))
    out = torch.empty(plain.shape[0], dtype=torch.int32, device=plain.device)
    for i in range(0, plain.shape[0], rows):
        out[i : i + rows] = part_mod.route_into_boxes(_whole_rows(x[i : i + rows]), *boxes)
    return out


def _alive_mask_for(n: int, n_shards: int, lost: Sequence[int]) -> torch.Tensor | None:
    """f32 row mask over all ``n`` rows zeroing the contiguous row blocks of
    the lost shards (``shard_points`` places rows contiguously)."""
    if not lost:
        return None
    # the geometry of repro_torch.testing.faults.shard_loss_rows_mask,
    # inlined so that the plane does not import the test harness
    if n % n_shards != 0:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    mask = np.ones(n, np.float32)
    per = n // n_shards
    for s in lost:
        if not 0 <= int(s) < n_shards:
            raise ValueError(f"shard {s} out of range [0, {n_shards})")
        mask[int(s) * per : (int(s) + 1) * per] = 0.0
    return torch.from_numpy(mask)


def _apply_shard_loss(
    part: Partition,
    *,
    n: int,
    n_ok: int,
    n_shards: int,
    n_injected: int,
    health: RunHealth,
    max_shard_loss_frac: float,
    round_index: int,
) -> Partition:
    """Round-level drop-and-reweight: if the recomputed statistics miss
    mass (injected shard loss, or shards whose rows were not finite), scale
    the survivors' ``psum`` and ``count`` by ``n / Σcount`` so the total
    mass is restored. The uniform scale leaves every representative and
    every weight ratio as it was, so weighted Lloyd's fixed points on the
    surviving blocks do not move, and the weighted errors stay on the scale
    of a lossless run. Raises :class:`ShardLossError` when the lost
    fraction exceeds ``max_shard_loss_frac``; every input is replicated, so
    every rank decides alike."""
    total = float(part.count.double().sum())
    lost_frac = max(0.0, 1.0 - total / float(n))
    n_lost = n_injected + max(0, n_shards - n_ok - n_injected)
    if n_lost == 0 and lost_frac <= 1e-6:
        return part
    if lost_frac > max_shard_loss_frac:
        raise ShardLossError(
            f"round {round_index}: lost {lost_frac:.1%} of the data mass "
            f"({n_lost} of {n_shards} shards), above "
            f"max_shard_loss_frac={max_shard_loss_frac:.1%}; aborting rather "
            "than fitting the remnant"
        )
    scale = float(n) / max(total, 1e-30)
    part = part._replace(psum=part.psum * scale, count=part.count * scale)
    health.lost_shards += n_lost
    health.degraded_rounds += 1
    health.lost_mass_frac = max(health.lost_mass_frac, lost_frac)
    return part


class ShardedPlane:
    """Mesh-sharded execution plane (``engine="distributed"``).

    ``x`` is this rank's part of the data (:func:`shard_points`; the
    ``BWKM`` facade places it): its rows, or their columns on a feature
    split (``dim`` is the global d). Every rank builds the same plane over
    its own part and runs the same driver with the same key.

    Fault injection: ``shard_faults`` maps a statistics round (0 = the
    initial routing round, ``i`` = the split round of outer iteration
    ``i``) to the data shards whose ``BlockStats`` are lost that round.
    The survivors are mass-reweighted and the round continues;
    :class:`ShardLossError` aborts the fit when a round loses more than
    ``max_shard_loss_frac`` of the data mass. The result's ``health``
    records shards lost and degraded rounds; a shard is a batch rank's
    rows (pod × data of them). ``checkpoint_dir``: the rank at coordinate
    0 of every mesh dimension writes the driver state (centroids and
    boxes) after every iteration.
    """

    name = "distributed"

    def __init__(
        self,
        x: torch.Tensor,
        *,
        checkpoint_dir: str | None = None,
        shard_faults: "dict[int, Sequence[int]] | None" = None,
        max_shard_loss_frac: float = 0.5,
    ):
        self.x = x
        self.checkpoint_dir = checkpoint_dir
        self.faults = {int(r): tuple(s) for r, s in (shard_faults or {}).items()}
        self.max_shard_loss_frac = max_shard_loss_frac
        self.run_health = RunHealth()
        self.n_shards = n_data_shards()
        self._dim = int(x.shape[1]) * _layout(x)[1]
        self._n, self._offset = sh._row_block(x.shape[0], x.device)
        self.bid: torch.Tensor | None = None

    @property
    def n_points(self) -> int:
        return self._n

    @property
    def dim(self) -> int:
        return self._dim

    def split_key(self, key):
        # the reference's 4-way split: the extra key draws the init sample
        key, k_init, k_pp, self._k_s = rnd.split(key, 4)
        return key, k_init, k_pp

    def _stats_round(self, part_in: Partition, bid_in: torch.Tensor, round_index: int) -> Partition:
        lost = self.faults.get(round_index, ())
        alive = _alive_mask_for(self.n_points, self.n_shards, lost)
        if alive is not None:
            alive = alive[self._offset : self._offset + self.x.shape[0]].to(self.x.device)
        part_out, n_ok = _recompute_stats_ok(part_in, self.x, bid_in, alive, n=self._n)
        return _apply_shard_loss(
            part_out, n=self.n_points, n_ok=n_ok, n_shards=self.n_shards,
            n_injected=len(lost), health=self.run_health,
            max_shard_loss_frac=self.max_shard_loss_frac, round_index=round_index,
        )

    def build_partition(self, k_init, config, p) -> Partition:
        # Algorithm 2 on a sample gathered to every rank (O(s·d), not
        # O(n·d)), then every rank routes its rows into the sample's boxes
        n, dev = self.n_points, self.x.device
        s_init = min(n, max(p["s"] * p["r"] * 4, 4 * p["m"]))
        idx = torch.sort(rnd.choice(self._k_s, n, (s_init,), device=dev)).values
        sample = _gather_rows(self.x, idx, self._offset, self.dim)
        # a non-finite row would poison the sample's boxes; its rank's
        # statistics drop in the statistics round instead
        sample = sample[torch.isfinite(sample).all(1)]
        sample_part = init_partition.build_initial_partition(
            k_init, sample, config.k,
            m=p["m"], m_prime=p["m_prime"], s=min(p["s"], s_init), r=p["r"],
            capacity=p["capacity"],
        )
        self.bid = _route_into_boxes(self.x, sample_part)
        return self._stats_round(sample_part, self.bid, 0)

    def extent(self, part: Partition) -> float:
        # the displacement threshold needs only the global bounding box,
        # which the block statistics already hold
        return global_extent(part)

    def route_round(self, part: Partition, plan: SplitPlan, round_index: int) -> Partition:
        self.bid = _route_split(self.x, self.bid, plan)
        return self._stats_round(part_mod.apply_split_plan(part, plan), self.bid, round_index)

    def on_iteration(self, it, c, part, distances) -> None:
        if self.checkpoint_dir is None or sh._process_rank() != 0:
            return
        from repro_torch.train import checkpoint as ckpt

        ckpt.save(
            self.checkpoint_dir, it,
            {"centroids": c, "boxes": {"lo": part.lo, "hi": part.hi, "active": part.active,
                                       "n_blocks": part.n_blocks}},
            extra={"distances": distances, "iteration": it, "health": self.run_health.as_dict()},
        )

    def trace_extra(self) -> dict:
        return {}

    def make_result(self, **fields) -> core_bwkm.BWKMResult:
        return core_bwkm.BWKMResult(health=self.run_health, **fields)
