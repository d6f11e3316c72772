"""BWKM's initial partition (paper Algorithms 2, 3 and 4).

Counterpart of ``repro.core.init_partition``. Algorithm 3 grows the bounding
box to ``m'`` blocks, sampling blocks ∝ ``l_B · |B(S)|``; Algorithm 4 scores
each block by the misassignment accumulated over ``r`` K-means++ runs on
subsample representatives; Algorithm 2 splits ∝ those scores until ``m``
blocks exist. Point memberships are kept up to date through every round.
"""

from __future__ import annotations

import math

import torch

from repro_torch import random as rnd
from repro_torch.core import misassignment as mis
from repro_torch.core import partition as part_mod
from repro_torch.core.kmeanspp import weighted_kmeanspp
from repro_torch.core.partition import Partition
from repro_torch.kernels import ops

__all__ = [
    "build_initial_partition",
    "cutting_probabilities_alg4",
    "default_params",
    "starting_partition",
]


def default_params(n: int, k: int, d: int) -> dict:
    """The paper's defaults (Section 2.4.1): m = 10·√(K·d), s = √n, r = 5."""
    m = max(k + 1, int(math.ceil(10.0 * math.sqrt(k * d))))
    return {
        "m": m,
        "m_prime": max(k + 1, m // 10),
        "s": max(1, int(math.ceil(math.sqrt(n)))),
        "r": 5,
    }


def _sample_split_round(key, part: Partition, x, weights_per_block, target: int) -> Partition:
    """One round: sample ``min(|B|, target − |B|)`` blocks ∝ weights, split them."""
    num = torch.minimum(part.n_blocks, target - part.n_blocks)
    chosen = mis.sample_boundary(key, weights_per_block, num)
    return part_mod.split_blocks(part, x, chosen)


def starting_partition(key, x: torch.Tensor, m_prime: int, s: int, capacity: int) -> Partition:
    """Algorithm 3: grow to ``m'`` blocks with Pr ∝ ``l_B · |B(S)|``."""
    part = part_mod.create_partition(x, capacity)
    n = x.shape[0]
    for _ in range(4 * m_prime):
        if int(part.n_blocks) >= m_prime:
            break
        key, k_s, k_c = rnd.split(key, 3)
        sample_idx = rnd.randint(k_s, (s,), 0, n, device=x.device)
        occ = torch.bincount(
            part.block_id[sample_idx].long(), minlength=part.capacity
        ).float()
        diag = part_mod.diagonals(part)
        w = diag * occ
        # the sample missed every splittable block: fall back to diagonals
        splittable = (part.count > 1) & part.active
        w = torch.where(
            (torch.where(splittable, w, 0.0) > 0).any(), w, torch.where(splittable, diag, 0.0)
        )
        part = _sample_split_round(k_c, part, x, w, m_prime)
    return part


def cutting_probabilities_alg4(
    key, part: Partition, x: torch.Tensor, k: int, s: int, r: int
) -> torch.Tensor:
    """Algorithm 4: the misassignment of every block, accumulated over ``r``
    K-means++ runs on subsample-induced representatives (unnormalised)."""
    n = x.shape[0]
    m = part.capacity
    eps_sum = torch.zeros(m, device=x.device)
    for _ in range(r):
        key, k_s, k_pp = rnd.split(key, 3)
        idx = rnd.randint(k_s, (s,), 0, n, device=x.device)
        # representatives of the sample-induced partition P = B(S^i)
        st = part_mod.block_stats(x[idx], part.block_id[idx], m)
        reps = st.psum / torch.clamp(st.count, min=1.0)[:, None]
        w = torch.where(part.active, st.count, 0.0)
        c_i = weighted_kmeanspp(k_pp, reps, w, k)
        _, d1, d2 = ops.assign_top2(reps, c_i)
        eps_sum = eps_sum + mis.misassignment(part._replace(count=st.count), d1, d2)
    return eps_sum


def build_initial_partition(
    key, x: torch.Tensor, k: int, *, m: int, m_prime: int, s: int, r: int, capacity: int
) -> Partition:
    """Algorithm 2: the starting partition, then splits ∝ Algorithm-4
    probabilities until ``m`` blocks exist or every block looks well
    assigned."""
    key, k0 = rnd.split(key)
    part = starting_partition(k0, x, m_prime, s, capacity)
    for _ in range(4 * m):
        if int(part.n_blocks) >= m:
            break
        key, k_p, k_c = rnd.split(key, 3)
        eps_sum = cutting_probabilities_alg4(k_p, part, x, k, s, r)
        splittable = (part.count > 1) & part.active
        eps_sum = torch.where(splittable, eps_sum, 0.0)
        if not bool((eps_sum > 0).any()):
            break
        part = _sample_split_round(k_c, part, x, eps_sum, m)
    return part
