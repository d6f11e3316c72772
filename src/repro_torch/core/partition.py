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

The streaming plane folds statistics chunk by chunk: :func:`block_stats`
masks a chunk's padding rows through ``valid``, and
:func:`combine_block_stats` adds the chunks' sums in f32 in chunk order and
takes their minima and maxima exactly, as the reference does, so a streamed
fit is deterministic too. :func:`route_into_boxes` routes a chunk into the
boxes of a partition built from a sample, tiled so that its ``[rows, M, d]``
temporaries stay under a byte budget. The online service decays block mass
(:func:`decay_stats`) and splits blocks without a data pass
(:func:`split_blocks_virtual`).
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
    "combine_block_stats",
    "decay_stats",
    "empty_block_stats",
    "recompute_stats",
    "route_into_boxes",
    "split_plan",
    "route_split",
    "apply_split_plan",
    "split_blocks",
    "split_blocks_virtual",
    "representatives",
    "diagonals",
]

_BIG = 3.0e38
#: fixed-point magnitude per term, at most: |q| ≤ 2^36 keeps 36 bits of the
#: feature's largest magnitude
_FIXED_BITS = 36
#: bytes of the two ``[rows, M, d]`` f32 temporaries of one route tile
ROUTE_TILE_BYTES = 64 << 20


def _fixed_bits(n: int) -> int:
    """Fixed-point bits of :func:`block_stats` over ``n`` rows. Each
    feature's running sum covers its ``n`` terms, each of magnitude at most
    ``2^bits``, so ``n·2^bits ≤ 2^62`` keeps it inside int64: 36 bits up to
    ``n = 2^26``, one bit fewer for each doubling beyond."""
    return min(_FIXED_BITS, 62 - (n - 1).bit_length())


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


def block_stats(
    x: torch.Tensor, bid: torch.Tensor, m: int, valid: torch.Tensor | None = None
) -> BlockStats:
    """Segment sums, counts, minima and maxima of the rows of ``x [n, d]``
    over ``m`` block rows, bit-identical from run to run (module docs).
    ``valid [n]`` bool masks rows out (a streamed chunk's padding): they go
    to a scratch segment ``m`` that is dropped."""
    n, d = x.shape
    if n == 0:
        raise ValueError("block_stats needs at least one row")
    dev = x.device
    x = x.float()
    seg = m
    if valid is not None:
        bid = torch.where(valid, bid.to(torch.int64), m)
        x = torch.where(valid[:, None], x, 0.0)  # masked rows set no scale
        seg = m + 1
    # one sort per feature of (block id << 32 | orderable value): each block
    # is a run, sorted by value inside it
    keys = (bid.to(torch.int64)[None, :] << 32) | _orderable(x.T.contiguous())
    keys = torch.sort(keys, dim=1).values  # [d, n]
    starts = torch.searchsorted(
        keys[0], torch.arange(seg + 1, device=dev, dtype=torch.int64) << 32
    )  # the run of block b is [starts[b], starts[b+1])
    count_i = starts[1:] - starts[:-1]
    empty = (count_i == 0)[:, None]
    vals = _from_orderable(keys & 0xFFFFFFFF)  # [d, n] f32, grouped by block
    lo = torch.where(empty, _BIG, vals[:, starts[:-1].clamp(max=n - 1)].T)
    hi = torch.where(empty, -_BIG, vals[:, (starts[1:] - 1).clamp(min=0)].T)
    # exact sums in fixed point with a power-of-two scale per feature, one
    # running sum per feature (n terms each, _fixed_bits)
    amax = x.abs().amax(0)
    scale = torch.ldexp(
        torch.ones(d, dtype=torch.float64, device=dev),
        (_fixed_bits(n) - torch.frexp(amax).exponent).to(torch.float64),
    )  # |x| < 2^e  =>  |x·scale| < 2^bits
    q = torch.round(vals.double() * scale[:, None]).to(torch.int64)
    csum = torch.zeros(d, n + 1, dtype=torch.int64, device=dev)
    for j in range(d):  # a 1-D scan each: PyTorch's scan along dim 1 of [d, n] is slow on CUDA
        torch.cumsum(q[j], 0, out=csum[j, 1:])
    seg_sum = csum[:, starts[1:]] - csum[:, starts[:-1]]  # [d, seg]
    psum = (seg_sum.double() / scale[:, None]).float().T
    return BlockStats(
        psum[:m].contiguous(), count_i[:m].float(), lo[:m].contiguous(), hi[:m].contiguous()
    )


def empty_block_stats(m: int, d: int, device) -> BlockStats:
    """The identity of :func:`combine_block_stats`."""
    return BlockStats(
        psum=torch.zeros(m, d, device=device),
        count=torch.zeros(m, device=device),
        lo=torch.full((m, d), _BIG, device=device),
        hi=torch.full((m, d), -_BIG, device=device),
    )


def combine_block_stats(a: BlockStats, b: BlockStats) -> BlockStats:
    """Merge two partial statistics: f32 sums, exact minima and maxima (the
    empty rows' ±_BIG are absorbing, so no masking is needed)."""
    return BlockStats(
        psum=a.psum + b.psum,
        count=a.count + b.count,
        lo=torch.minimum(a.lo, b.lo),
        hi=torch.maximum(a.hi, b.hi),
    )


def decay_stats(part: Partition, gamma: float) -> Partition:
    """Exponential forgetting of block mass (the online service's merge
    rule): sums and counts scale by ``gamma`` in f32; the boxes stay, since
    they are geometric routing state."""
    return part._replace(psum=part.psum * gamma, count=part.count * gamma)


def route_into_boxes(
    x: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    active: torch.Tensor,
    *,
    tile_bytes: int = ROUTE_TILE_BYTES,
) -> torch.Tensor:
    """Each row's box of smallest clipped L∞ distance, ``int32 [n]``:
    containment for rows inside some box, the nearest box for the rest;
    ties go to the first box. The rows are taken in tiles whose two
    ``[rows, M, d]`` f32 temporaries fit ``tile_bytes``."""
    n, d = x.shape
    m = lo.shape[0]
    lo_ = torch.where(active[:, None], lo, _BIG)
    hi_ = torch.where(active[:, None], hi, -_BIG)
    rows = max(1, tile_bytes // (2 * 4 * m * d))
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    for i in range(0, n, rows):
        xt = x[i : i + rows].float()
        below = (lo_[None] - xt[:, None, :]).clamp_(min=0.0)
        below += (xt[:, None, :] - hi_[None]).clamp_(min=0.0)
        out[i : i + rows] = below.amax(-1).argmin(-1)  # [rows, M] clipped L∞
    return out


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


def split_blocks_virtual(part: Partition, plan: SplitPlan) -> Partition:
    """A split round without a data pass, for the online service, whose
    member points are gone: each child takes the parent's box clipped at the
    split plane, and the parent's statistics go wholly to the child holding
    the parent's representative (the other starts empty). Elementwise and
    deterministic, so a resumed session replays it bit for bit."""
    fits = plan.fits
    onehot = torch.nn.functional.one_hot(plan.axis.long(), part.dim).bool()  # [M, d]
    mid_col = plan.mid[:, None]
    hi_left = torch.where(fits[:, None] & onehot, torch.minimum(part.hi, mid_col), part.hi)
    lo_right = torch.where(onehot, torch.maximum(part.lo, mid_col), part.lo)
    # the representative's side inherits the parent's mass
    safe = torch.clamp(part.count, min=1.0)
    rep_ax = (part.psum / safe[:, None]).gather(1, plan.axis.long()[:, None])[:, 0]
    rep_right = fits & (rep_ax > plan.mid)
    psum_left = torch.where(rep_right[:, None], 0.0, part.psum)
    count_left = torch.where(rep_right, 0.0, part.count)
    psum_right = torch.where(rep_right[:, None], part.psum, 0.0)
    count_right = torch.where(rep_right, part.count, 0.0)
    # the right children go to their allocated rows; rows that do not split
    # write nothing (the reference's scatter with mode="drop")
    src = fits.nonzero()[:, 0]
    dst = plan.right_row.long()[src]
    return apply_split_plan(part._replace(
        lo=part.lo.index_copy(0, dst, lo_right[src]),
        hi=hi_left.index_copy(0, dst, part.hi[src]),
        psum=psum_left.index_copy(0, dst, psum_right[src]),
        count=count_left.index_copy(0, dst, count_right[src]),
    ), plan)
