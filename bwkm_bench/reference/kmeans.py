"""Distances, assignments and weighted means, in float64.

Each judge measures one output of the port against what the definition
says it is, so that a near-tie that the port resolves the other way reads
as a gap of rounding size and not as a wrong answer:

* ``label_gap``: how far a row's chosen centre lies beyond its nearest one,
  ``(‖x − c_label‖² − min_j ‖x − c_j‖²) / (‖x‖² + max(‖c_label‖², ‖c_min‖²))``,
  the scale of the rounding of a distance computed as ``‖x‖² − 2x·c + ‖c‖²``;
* ``dist_gap``: the reported top-2 squared distances against the float64
  ones, each on the scale ``‖x‖² + ‖c‖²`` of its own centre;
* ``sum_gap``: per-cluster weighted sums and weights under the port's own
  labels, against the float64 sums, relative to ``Σ w·|x|``;
* ``update_gap``: a centroid against the weighted mean it was updated to,
  relative to the data's extent.
"""

from __future__ import annotations

import torch

__all__ = ["label_gaps", "next_centroids", "sqdist", "sum_gap", "top2"]

_BIG = 1.0e37


def sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``[n, K]`` squared distances in float64."""
    x, c = x.double(), c.double()
    return ((x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None, :]).clamp_(min=0.0)


def top2(x: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(label, d1, d2)`` in float64; ``d2`` is inf for one centre."""
    dd = sqdist(x, c)
    if c.shape[0] == 1:
        return torch.zeros(x.shape[0], dtype=torch.long, device=x.device), dd[:, 0], \
            torch.full_like(dd[:, 0], float("inf"))
    v, i = torch.topk(dd, 2, dim=1, largest=False)
    return i[:, 0], v[:, 0], v[:, 1]


def label_gaps(x, c, labels, d1=None, d2=None, *, where=None,
               rows: int = 65_536) -> tuple[float, float]:
    """``(label_gap, dist_gap)`` over every row, in blocks of ``rows``. A
    label outside ``[0, K)`` reads inf. ``d1``/``d2`` are compared where
    they are given, where ``where`` (bool ``[n]``) holds, and below the
    port's "not computed" value."""
    k = c.shape[0]
    cn = (c.double() ** 2).sum(1)
    lg = dg = 0.0
    for s in range(0, x.shape[0], rows):
        xb = x[s : s + rows].double()
        lb = labels[s : s + rows].long()
        if bool(((lb < 0) | (lb >= k)).any()):
            return float("inf"), float("inf")
        dd = sqdist(xb, c)
        xn = (xb * xb).sum(1) + 1e-30
        mine = dd.gather(1, lb[:, None])[:, 0]
        best, ib = dd.min(1)
        scale = xn + torch.maximum(cn[lb], cn[ib])
        lg = max(lg, float(((mine - best) / scale).max()))
        if d1 is not None:
            i1, r1, r2 = top2(xb, c)
            p1 = d1[s : s + rows].double()
            ok = p1 < _BIG
            if where is not None:
                ok = ok & where[s : s + rows].bool()
            gap = torch.where(ok, (p1 - r1).abs() / (xn + cn[i1]), 0.0)
            if d2 is not None and k > 1:
                p2 = d2[s : s + rows].double()
                ok2 = ok & torch.isfinite(p2) & torch.isfinite(r2)
                i2 = torch.topk(dd, 2, dim=1, largest=False).indices[:, 1]
                gap = torch.maximum(gap, torch.where(ok2, (p2 - r2).abs() / (xn + cn[i2]), 0.0))
                # inf reported where a second distance exists, or the reverse
                bad = ok & (torch.isfinite(p2) != torch.isfinite(r2))
                if bool(bad.any()):
                    return lg, float("inf")
            dg = max(dg, float(gap.max()))
    return lg, dg


def sum_gap(x, w, labels, sums, counts) -> float:
    """Per-cluster ``Σ w·x`` and ``Σ w`` under ``labels`` against the port's
    ``sums [K, d]`` and ``counts [K]``."""
    k, d = sums.shape
    lb = labels.long()
    xd, wd = x.double(), w.double()
    ref = torch.zeros(k, d, dtype=torch.float64, device=x.device).index_add_(0, lb, wd[:, None] * xd)
    mag = torch.zeros(k, d, dtype=torch.float64, device=x.device).index_add_(
        0, lb, (wd[:, None] * xd).abs())
    cnt = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(0, lb, wd)
    g1 = ((sums.double() - ref).abs() / (mag + 1e-30)).max()
    g2 = ((counts.double() - cnt).abs() / (cnt + 1e-30)).max()
    return float(torch.maximum(g1, g2))


def next_centroids(sums, counts, c) -> torch.Tensor:
    """Lloyd's update in float64: the weighted mean where a cluster has
    weight, the old centre where it has none."""
    cnt = counts.double()
    return torch.where((cnt > 0)[:, None], sums.double() / cnt.clamp(min=1e-300)[:, None],
                       c.double())
