"""Theorem-backed bounds used as stopping criteria.

Counterpart of ``repro.core.bounds``:

* Theorem 2:   |E^D(C) − E^P(C)| ≤ Σ_B 2·|P|·ε(B)·(2·l_B + ‖P̄−c_P̄‖) + (|P|−1)/2·l_B²
* Theorem A.1: grid-RPKM iteration i is a (K, ε)-coreset with
               ε = 2^{1−i}·(1 + (n−1)/(n·2^{i+2}))·n·l²/OPT
* Theorem A.4: ‖C − C'‖_∞ ≤ ε_w = sqrt(l² + ε²/n²) − l  ⇒  |E^D(C) − E^D(C')| ≤ ε
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import partition as part_mod
from repro_torch.core.partition import Partition

__all__ = ["coreset_epsilon", "displacement_threshold", "thm2_gap_bound"]


def thm2_gap_bound(part: Partition, eps: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """The Theorem-2 upper bound on ``|E^D(C) − E^P(C)|``."""
    occupied = (part.count > 0) & part.active
    l_b = part_mod.diagonals(part)
    dist_rep = torch.sqrt(torch.clamp(d1, min=0.0))
    per_block = 2.0 * part.count * eps * (2.0 * l_b + dist_rep) + torch.clamp(
        part.count - 1.0, min=0.0
    ) / 2.0 * l_b**2
    return torch.where(occupied, per_block, 0.0).sum()


def coreset_epsilon(i: int, n: int, l: float, opt: float) -> float:  # noqa: E741
    """Theorem A.1's (K, ε)-coreset ε for the i-th grid-RPKM iteration."""
    return (1.0 / 2 ** (i - 1)) * (1.0 + (n - 1) / (n * 2 ** (i + 2))) * n * l * l / opt


def displacement_threshold(l: float, n: int, epsilon: float) -> float:  # noqa: E741
    """Theorem A.4's ε_w: the centroid displacement that guarantees Eq.-2
    stopping, as ``a / (sqrt(l² + a) + l)`` with ``a = ε²/n²`` — the same
    number as ``sqrt(l² + a) − l`` without its cancellation."""
    a = (epsilon * epsilon) / (n * n)
    return a / (math.sqrt(l * l + a) + l) if a > 0 else 0.0
