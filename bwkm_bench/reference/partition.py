"""A partition's statistics, routing into boxes and the service's split,
written from their definitions (paper Definition 1; the service's rules).

* :func:`member_stats`: each block's member count, float64 sum and tight
  box from the rows and their memberships;
* :func:`overlaps`: pairs of blocks whose closed boxes meet (the blocks of
  a spatial partition's tight boxes never do);
* :func:`route`: each row's box of smallest clipped L∞ distance, ties to
  the first box, in float32 as the rule is stated (exact: differences of
  two float32 values, a clamp and a maximum);
* :func:`virtual_split`: the service's split without member points: each
  chosen block splits at the midpoint of its longest side, the children
  take the parent's box clipped at the plane, and the parent's mass goes
  wholly to the side of its representative.
"""

from __future__ import annotations

import torch

__all__ = ["member_stats", "overlaps", "route", "virtual_split"]

_BIG = 3.0e38


def member_stats(x: torch.Tensor, bid: torch.Tensor, m: int):
    """``(count int64 [m], psum f64 [m, d], lo f32 [m, d], hi f32 [m, d])``;
    an empty block has ``lo = +BIG``, ``hi = −BIG``."""
    d = x.shape[1]
    b = bid.long()
    count = torch.bincount(b, minlength=m)[:m]
    psum = torch.zeros(m, d, dtype=torch.float64, device=x.device).index_add_(0, b, x.double())
    idx = b[:, None].expand(-1, d)
    lo = torch.full((m, d), _BIG, device=x.device).scatter_reduce_(
        0, idx, x.float(), "amin", include_self=True)
    hi = torch.full((m, d), -_BIG, device=x.device).scatter_reduce_(
        0, idx, x.float(), "amax", include_self=True)
    return count, psum, lo, hi


def overlaps(lo: torch.Tensor, hi: torch.Tensor, mask: torch.Tensor, *, rows: int = 512) -> int:
    """Unordered pairs of the blocks in ``mask`` whose closed boxes meet."""
    lo, hi = lo[mask], hi[mask]
    n = lo.shape[0]
    total = 0
    for s in range(0, n, rows):
        a_lo, a_hi = lo[s : s + rows, None, :], hi[s : s + rows, None, :]
        meet = ((a_lo <= hi[None]) & (lo[None] <= a_hi)).all(-1)  # [rows, n]
        total += int(meet.sum()) - meet.shape[0]  # each box meets itself
    return total // 2


def route(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, active: torch.Tensor,
          *, tile_bytes: int = 64 << 20) -> torch.Tensor:
    """Each row's box of smallest clipped L∞ distance (``int64 [n]``);
    inactive boxes never win; ties go to the first box."""
    m, d = lo.shape
    lo_ = torch.where(active[:, None], lo.float(), _BIG)
    hi_ = torch.where(active[:, None], hi.float(), -_BIG)
    rows = max(1, tile_bytes // (4 * m * d))
    out = torch.empty(x.shape[0], dtype=torch.long, device=x.device)
    for s in range(0, x.shape[0], rows):
        xt = x[s : s + rows].float()[:, None, :]
        dist = torch.maximum((lo_[None] - xt).clamp(min=0.0), (xt - hi_[None]).clamp(min=0.0))
        out[s : s + rows] = dist.amax(-1).argmin(1)  # argmin keeps the first minimum
    return out


def virtual_split(psum, count, lo, hi, chosen, first_free: int, port_right=None,
                  tie: float = 1e-5):
    """Split the blocks of ``chosen`` (bool ``[m]``, taken in increasing
    index) into the rows from ``first_free`` on. ``psum f64``, ``count f64``
    and the boxes are returned as new tensors. A representative within
    ``tie`` (relative) of the plane lies on it to rounding: there the side
    the port chose (``port_right[r]``: the right child ``r`` got the mass)
    is taken, as either side obeys the rule."""
    psum, count, lo, hi = psum.clone(), count.clone(), lo.clone(), hi.clone()
    parents = chosen.nonzero()[:, 0]
    ext = (hi - lo).clamp(min=0.0)
    for j, p in enumerate(parents.tolist()):
        r = first_free + j
        ax = int(torch.argmax(ext[p]))
        mid = 0.5 * (lo[p, ax] + hi[p, ax])  # float32, as the rule states it
        rep_ax = psum[p, ax] / max(float(count[p]), 1.0)
        lo[r], hi[r] = lo[p], hi[p]
        lo[r, ax] = torch.maximum(lo[p, ax], mid)
        hi[p, ax] = torch.minimum(hi[p, ax], mid)
        near = abs(float(rep_ax) - float(mid)) <= tie * (abs(float(mid)) + 1e-30)
        if (bool(port_right[r]) if near and port_right is not None else float(rep_ax) > float(mid)):
            psum[r], count[r] = psum[p], count[p]
            psum[p], count[p] = 0.0, 0.0
        else:
            psum[r], count[r] = 0.0, 0.0
    return psum, count, lo, hi
