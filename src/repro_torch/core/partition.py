"""Dataset partitions induced by spatial partitions (paper Definition 1).

Counterpart of ``repro.core.partition``. A partition lives in fixed-capacity
tensors: ``capacity`` block rows, a per-row active mask and a per-point
``block_id``. A split turns the parent row into the left child and takes a
fresh row for the right child; points are rerouted by one gather and one
compare against the split plane. Blocks are recorded by their tight
bounding boxes.

:func:`block_stats` is the O(n·d) step of every split round. It is written
to give the same bits on every run, on the CPU and on CUDA alike: one sort
of packed ``(block id, value)`` keys per feature yields each block's
minimum and maximum as the first and last key of its run, and the sums are
taken in 64-bit fixed point, whose addition is exact and so does not depend
on the order of the terms. No float atomics are involved, and no block's
reduction is serialised on one thread however skewed the partition is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "Partition",
    "BlockStats",
    "SplitPlan",
    "create_partition",
    "block_stats",
    "recompute_stats",
    "split_plan",
    "route_split",
    "apply_split_plan",
    "split_blocks",
    "representatives",
    "diagonals",
]

_BIG = 3.0e38
#: fixed-point magnitude per term: |q| < 2^36, so the running sum over
#: d·n ≤ 2^26.5 terms stays inside int64 and each term keeps 36 bits of the
#: feature's largest magnitude
_FIXED_BITS = 36


class Partition(NamedTuple):
    """Fixed-capacity partition state.

    ``lo, hi [M, d]`` tight boxes (lo > hi for empty rows), ``psum [M, d]``
    member sums, ``count [M]`` member counts (f32: the weights), ``active
    [M]`` bool, ``block_id [n]`` int32, ``n_blocks`` scalar int32 tensor.
    """

    lo: torch.Tensor
    hi: torch.Tensor
    psum: torch.Tensor
    count: torch.Tensor
    active: torch.Tensor
    block_id: torch.Tensor
    n_blocks: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.lo.shape[0]

    @property
    def dim(self) -> int:
        return self.lo.shape[1]


def _occupied(part: Partition) -> torch.Tensor:
    return (part.count > 0) & part.active


def representatives(part: Partition) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block centres of mass and weights ``(reps [M,d], w [M])``; empty
    and inactive rows get weight 0 and a representative at the origin."""
    safe = torch.clamp(part.count, min=1.0)
    occ = _occupied(part)
    reps = torch.where(occ[:, None], part.psum / safe[:, None], 0.0)
    return reps, torch.where(occ, part.count, 0.0)


def diagonals(part: Partition) -> torch.Tensor:
    """Length of each block's tight-box diagonal, ``[M]`` (0 if empty)."""
    ext = torch.clamp(part.hi - part.lo, min=0.0)
    return torch.where(_occupied(part), torch.linalg.vector_norm(ext, dim=-1), 0.0)


class BlockStats(NamedTuple):
    """Per-block ``(Σx, |B|, min x, max x)``."""

    psum: torch.Tensor  # [M, d]
    count: torch.Tensor  # [M]
    lo: torch.Tensor  # [M, d]
    hi: torch.Tensor  # [M, d]


def _orderable(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 in [0, 2^32) with the order of the floats."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b + 0x80000000)


def _from_orderable(u: torch.Tensor) -> torch.Tensor:
    b = torch.where(u >= 0x80000000, u - 0x80000000, 0xFFFFFFFF - u)
    b = torch.where(b >= 0x80000000, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def block_stats(x: torch.Tensor, bid: torch.Tensor, m: int) -> BlockStats:
    """Segment sums, counts, minima and maxima of the rows of ``x [n, d]``
    over ``m`` block rows, bit-identical from run to run (module docs)."""
    n, d = x.shape
    if n == 0:
        raise ValueError("block_stats needs at least one row")
    dev = x.device
    x = x.float()
    # one sort per feature of (block id << 32 | orderable value): each block
    # is a run, sorted by value inside it
    keys = (bid.to(torch.int64)[None, :] << 32) | _orderable(x.T.contiguous())
    keys = torch.sort(keys, dim=1).values  # [d, n]
    starts = torch.searchsorted(
        keys[0], torch.arange(m + 1, device=dev, dtype=torch.int64) << 32
    )  # the run of block b is [starts[b], starts[b+1])
    count_i = starts[1:] - starts[:-1]
    empty = (count_i == 0)[:, None]
    vals = _from_orderable(keys & 0xFFFFFFFF)  # [d, n] f32, grouped by block
    lo = torch.where(empty, _BIG, vals[:, starts[:-1].clamp(max=n - 1)].T)
    hi = torch.where(empty, -_BIG, vals[:, (starts[1:] - 1).clamp(min=0)].T)
    # exact sums in fixed point with a power-of-two scale per feature
    amax = x.abs().amax(0)
    scale = torch.ldexp(
        torch.ones(d, dtype=torch.float64, device=dev),
        (_FIXED_BITS - torch.frexp(amax).exponent).to(torch.float64),
    )  # |x| < 2^e  =>  |x·scale| < 2^36
    q = torch.round(vals.double() * scale[:, None]).to(torch.int64)
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(q.reshape(-1), 0)])
    base = (torch.arange(d, device=dev, dtype=torch.int64) * n)[:, None]
    seg = csum[base + starts[None, 1:]] - csum[base + starts[None, :-1]]  # [d, m]
    psum = (seg.double() / scale[:, None]).float().T.contiguous()
    return BlockStats(psum, count_i.float(), lo.contiguous(), hi.contiguous())


def recompute_stats(part: Partition, x: torch.Tensor) -> Partition:
    """Recompute (psum, count, lo, hi) for all rows from the memberships."""
    st = block_stats(x, part.block_id, part.capacity)
    return part._replace(psum=st.psum, count=st.count, lo=st.lo, hi=st.hi)


def create_partition(x: torch.Tensor, capacity: int) -> Partition:
    """The one-block partition: the smallest bounding box of the data."""
    n, d = x.shape
    dev = x.device
    active = torch.zeros(capacity, dtype=torch.bool, device=dev)
    active[0] = True
    part = Partition(
        lo=torch.full((capacity, d), _BIG, device=dev),
        hi=torch.full((capacity, d), -_BIG, device=dev),
        psum=torch.zeros(capacity, d, device=dev),
        count=torch.zeros(capacity, device=dev),
        active=active,
        block_id=torch.zeros(n, dtype=torch.int32, device=dev),
        n_blocks=torch.tensor(1, dtype=torch.int32, device=dev),
    )
    return recompute_stats(part, x)


class SplitPlan(NamedTuple):
    """A resolved split round: which rows split (``fits``), along which axis
    at which midpoint, and the row of each right child."""

    fits: torch.Tensor  # [M] bool
    axis: torch.Tensor  # [M] int64
    mid: torch.Tensor  # [M] f32
    right_row: torch.Tensor  # [M] int32
    n_new: torch.Tensor  # scalar int32


def split_plan(part: Partition, chosen: torch.Tensor) -> SplitPlan:
    """Resolve ``chosen [M]`` into a plan: each block splits at the midpoint
    of its longest side. Singleton blocks, and blocks whose right child would
    exceed capacity, do not split."""
    m = part.capacity
    chosen = chosen & part.active & (part.count > 1)
    rank = torch.cumsum(chosen.to(torch.int32), 0, dtype=torch.int32) - 1
    right_row = part.n_blocks + rank
    fits = chosen & (right_row < m)
    right_row = torch.where(fits, right_row, 0).to(torch.int32)
    ext = torch.clamp(part.hi - part.lo, min=0.0)
    axis = torch.argmax(ext, dim=-1)  # first maximum on ties
    mid = 0.5 * (
        part.lo.gather(1, axis[:, None])[:, 0] + part.hi.gather(1, axis[:, None])[:, 0]
    )
    return SplitPlan(fits, axis, mid, right_row, fits.sum(dtype=torch.int32))


def route_split(x: torch.Tensor, bid: torch.Tensor, plan: SplitPlan) -> torch.Tensor:
    """New memberships: a member of a split block goes right iff
    ``x[axis] > mid``."""
    b = bid.long()
    p_val = x.gather(1, plan.axis[b][:, None])[:, 0]
    goes_right = plan.fits[b] & (p_val > plan.mid[b])
    return torch.where(goes_right, plan.right_row[b], bid.to(torch.int32))


def apply_split_plan(part: Partition, plan: SplitPlan) -> Partition:
    """Activate the right-child rows of ``plan`` (stats stay stale until the
    caller recomputes them)."""
    r = torch.arange(part.capacity, device=part.active.device)
    active = part.active | ((r >= part.n_blocks) & (r < part.n_blocks + plan.n_new))
    return part._replace(active=active, n_blocks=part.n_blocks + plan.n_new)


def split_blocks(part: Partition, x: torch.Tensor, chosen: torch.Tensor) -> Partition:
    """In-core split round: plan, route every point, re-tighten all boxes."""
    plan = split_plan(part, chosen)
    new_bid = route_split(x, part.block_id, plan)
    out = apply_split_plan(part._replace(block_id=new_bid), plan)
    return recompute_stats(out, x)
