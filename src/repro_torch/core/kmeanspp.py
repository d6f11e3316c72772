"""Seeding: Forgy, (weighted) K-means++ and AFK-MC².

Counterpart of ``repro.core.kmeanspp``. The paper seeds BWKM with weighted
K-means++ over the partition's representatives (Algorithm 5 Step 1) and
compares against Forgy (FKM), K-means++ (KM++) and AFK-MC² (KMC2, Bachem
et al. 2016) as baselines. The reference's ``lax.scan`` over seeds is a
Python loop here. The draws are made on the device, but each K-means++
draw waits for the host once (``chip_smoke.py`` counts K synchronizing
calls in a seeding of K; ROADMAP B2), and AFK-MC² reads each seed's chain
back once for its sequential accept pass.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as rnd

__all__ = ["afkmc2", "forgy", "kmeanspp", "weighted_kmeanspp"]


def _log_weights(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w > 0, torch.log(torch.clamp(w, min=1e-30)), float("-inf"))


def forgy(key, x: torch.Tensor, k: int, w: torch.Tensor | None = None) -> torch.Tensor:
    """K distinct rows drawn uniformly, or weight-proportionally without
    replacement when ``w`` is given (Gumbel top-k on log-weights). With
    fewer than ``k`` positive-weight rows the short slots cycle through the
    valid draws; no positive weight is an error."""
    if w is None:
        return x[rnd.choice(key, x.shape[0], (k,), device=x.device)]
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


def kmeanspp(key, x: torch.Tensor, k: int) -> torch.Tensor:
    """Unweighted K-means++ (the paper's KM++ seeding)."""
    return weighted_kmeanspp(key, x, torch.ones(x.shape[0], device=x.device), k)


def afkmc2(key, x: torch.Tensor, k: int, chain_length: int = 200) -> torch.Tensor:
    """AFK-MC²: the assumption-free MCMC approximation of K-means++.

    Proposal ``q(x) = 0.5·d(x, c₁)²/Σd(·, c₁)² + 0.5/n``; each of the other
    ``k − 1`` seeds is the end of a Metropolis–Hastings chain over
    ``chain_length`` candidates drawn from ``q``, so seeding costs
    ``n + (k − 1)·chain_length·k`` distances, sublinear in n past the first
    pass. The candidates' distances are computed on the device; the
    sequential accept pass runs on the host over one copy of the chain per
    seed, in the reference's f32 operations.
    """
    n = x.shape[0]
    key0, _, key = rnd.split(key, 3)
    c1 = x[rnd.randint(key0, (), 0, n, device=x.device)]
    d1 = ((x - c1[None, :]) ** 2).sum(-1)
    q = 0.5 * d1 / torch.clamp(d1.sum(), min=1e-30) + 0.5 / n  # [n]
    logq = torch.log(q)
    centroids = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    centroids[0] = c1
    slots = torch.arange(k, device=x.device)
    tiny = np.float32(1e-30)
    for i in range(1, k):
        key, kidx, kacc = rnd.split(key, 3)
        cand = rnd.categorical(kidx, logq, shape=(chain_length,))
        xc = x[cand]  # [m, d]
        # d(candidate, seeds so far)², masked to the i seeds chosen so far
        mask = torch.where(slots < i, 0.0, float("inf"))
        dd = ((xc[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        dc = (dd + mask[None, :]).min(-1).values
        ratio = dc / q[cand]
        u = rnd.uniform(kacc, (chain_length,), device=x.device)
        # one read: indices below 2^53 and f32 values are exact in f64
        chain = torch.stack([cand.double(), ratio.double(), u.double()]).cpu().numpy()
        cand_h = chain[0].astype(np.int64)
        ratio_h, u_h = chain[1].astype(np.float32), chain[2].astype(np.float32)
        cur, cur_ratio = cand_h[0], ratio_h[0]
        for j in range(chain_length):
            if u_h[j] < ratio_h[j] / max(cur_ratio, tiny):
                cur, cur_ratio = cand_h[j], ratio_h[j]
        centroids[i] = x[int(cur)]
    return centroids
