"""Seeding: Forgy and weighted K-means++.

Counterpart of ``repro.core.kmeanspp`` (``weighted_kmeanspp``, ``forgy``).
The reference's ``lax.scan`` over seeds is a Python loop here; every draw
stays on the device, so seeding makes no host round trip.
"""

from __future__ import annotations

import torch

from repro_torch import random as rnd

__all__ = ["forgy", "weighted_kmeanspp"]


def _log_weights(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w > 0, torch.log(torch.clamp(w, min=1e-30)), float("-inf"))


def forgy(key, x: torch.Tensor, k: int, w: torch.Tensor) -> torch.Tensor:
    """K rows drawn weight-proportionally without replacement (Gumbel top-k
    on log-weights). With fewer than ``k`` positive-weight rows the short
    slots cycle through the valid draws; no positive weight is an error."""
    w = w.float()
    if not bool((w > 0).any()):
        raise ValueError("forgy: no rows with positive weight to seed from")
    g = rnd.gumbel(key, (x.shape[0],), device=x.device) + _log_weights(w)
    gv, idx = torch.topk(g, k)
    finite = torch.isfinite(gv)
    n_pos = torch.clamp(finite.sum(), min=1)
    idx = torch.where(finite, idx, idx[torch.arange(k, device=x.device) % n_pos])
    return x[idx]


def weighted_kmeanspp(key, x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Weighted K-means++: each seed is drawn ∝ ``w·d(x, C)²`` (the first
    ∝ ``w``). Zero-weight rows are never drawn."""
    w = w.float()
    logw = _log_weights(w)
    key0, key = rnd.split(key)
    first = x[rnd.categorical(key0, logw)]
    centroids = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    centroids[0] = first
    mind2 = ((x - first[None, :]) ** 2).sum(-1)
    for i in range(1, k):
        key, sub = rnd.split(key)
        logits = logw + torch.log(torch.clamp(mind2, min=1e-30))
        # all remaining mass zero: fall back to the weights alone
        logits = torch.where(torch.isfinite(logits).any(), logits, logw)
        c_new = x[rnd.categorical(sub, logits)]
        centroids[i] = c_new
        mind2 = torch.minimum(mind2, ((x - c_new[None, :]) ** 2).sum(-1))
    return centroids
