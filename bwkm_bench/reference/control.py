"""The control: the reference put in the port's place at the precision
below the one the configurations state (float32 with TF32 off).

The step that would tempt a later change is a TF32 product: float32 rows
and centres rounded to TF32's 10-bit mantissa (round to nearest even), the
products summed in float32. :func:`tf32` does that rounding the same way on
the CPU and on the card, so the control reads alike on both. The judges of
:mod:`bwkm_bench.reference.kmeans` must fail it; the limits sit between
what sound runs of the port read and what the control reads.
"""

from __future__ import annotations

import torch

__all__ = ["misassignment", "stats", "sums", "tf32", "top2"]


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32: 10 mantissa bits, nearest even."""
    i = t.float().contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    i = torch.where(i >= 1 << 31, i - (1 << 32), i)
    return i.to(torch.int32).view(torch.float32)


def top2(x: torch.Tensor, c: torch.Tensor, *, rows: int = 65_536):
    """``(label int32, d1, d2)`` from TF32 products, float32 sums."""
    xt, ct = tf32(x), tf32(c)
    cn = (ct * ct).sum(1)
    labels, d1s, d2s = [], [], []
    for s in range(0, x.shape[0], rows):
        xb = xt[s : s + rows]
        dd = ((xb * xb).sum(1)[:, None] - 2.0 * (xb @ ct.T) + cn[None]).clamp_(min=0.0)
        if c.shape[0] == 1:
            v, i = dd, torch.zeros_like(dd, dtype=torch.long)
            v = torch.cat([v, torch.full_like(v, float("inf"))], 1)
        else:
            v, i = torch.topk(dd, 2, dim=1, largest=False)
        labels.append(i[:, 0].int())
        d1s.append(v[:, 0])
        d2s.append(v[:, 1])
    return torch.cat(labels), torch.cat(d1s), torch.cat(d2s)


def sums(x, w, labels, k: int):
    """``(sums [K, d], counts [K])`` in float32 over TF32 rows."""
    lb = labels.long()
    xt = tf32(x)
    s = torch.zeros(k, x.shape[1], device=x.device).index_add_(0, lb, w.float()[:, None] * xt)
    n = torch.zeros(k, device=x.device).index_add_(0, lb, w.float())
    return s, n


def stats(x, bid, m: int):
    """Block sums ``f32 [m, d]`` over TF32 rows."""
    return torch.zeros(m, x.shape[1], device=x.device).index_add_(0, bid.long(), tf32(x))


def misassignment(lo, hi, occupied, d1, d2):
    """``ε [M]`` from the control's own top-2 distances, the box diagonal's
    squares from TF32 sides summed in float32."""
    ext = tf32(torch.where(occupied[:, None], (hi.float() - lo.float()).clamp(min=0.0), 0.0))
    delta = d2.float().clamp(min=0.0).sqrt() - d1.float().clamp(min=0.0).sqrt()
    eps = (2.0 * (ext * ext).sum(-1).sqrt() - delta).clamp(min=0.0)
    return torch.where(occupied, eps, 0.0)
