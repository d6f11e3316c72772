"""Misassignment function and boundary sampling (paper Section 2).

Counterpart of ``repro.core.misassignment``. Definition 3:
``ε(B) = max{0, 2·l_B − δ_P(C)}`` with ``δ_P(C) = ‖P̄ − c₂‖ − ‖P̄ − c₁‖``;
Definition 4: the boundary ``F = {B : ε(B) > 0}``; Eq. 5: blocks are cut
with probability ∝ ε.
"""

from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core import partition as part_mod
from repro_torch.core.partition import Partition

__all__ = ["boundary_mask", "cutting_probabilities", "misassignment", "sample_boundary"]


def misassignment(part: Partition, d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """ε per block row ``[M]`` from the representatives' top-2 squared
    distances; empty and inactive rows get 0."""
    occupied = (part.count > 0) & part.active
    l_b = part_mod.diagonals(part)
    delta = torch.sqrt(torch.clamp(d2, min=0.0)) - torch.sqrt(torch.clamp(d1, min=0.0))
    eps = torch.clamp(2.0 * l_b - delta, min=0.0)
    return torch.where(occupied, eps, 0.0)


def boundary_mask(eps: torch.Tensor) -> torch.Tensor:
    """The blocks that may not be well assigned (Definition 4)."""
    return eps > 0.0


def cutting_probabilities(eps_sum: torch.Tensor) -> torch.Tensor:
    """``Pr(B)`` ∝ accumulated misassignment (Eq. 5); all zero when it sums to 0."""
    total = eps_sum.sum()
    return torch.where(total > 0, eps_sum / torch.clamp(total, min=1e-30), 0.0)


def sample_boundary(key, eps: torch.Tensor, num_draws) -> torch.Tensor:
    """Draw ``num_draws`` blocks with replacement ∝ ε and return the chosen
    mask (Algorithm 5 Step 3; duplicates collapse). ``M`` draws are taken
    from the one distribution and the first ``num_draws`` kept, so
    ``num_draws`` may be a device scalar."""
    m = eps.shape[0]
    pos = eps > 0
    logits = torch.where(pos, torch.log(torch.clamp(eps, min=1e-30)), float("-inf"))
    any_pos = pos.any()
    safe_logits = torch.where(any_pos, logits, torch.zeros_like(logits))
    draws = rnd.categorical(key, safe_logits, shape=(m,))
    keep = torch.arange(m, device=eps.device) < num_draws
    chosen = torch.zeros(m, dtype=torch.bool, device=eps.device)
    chosen[draws[keep]] = True
    return chosen & pos & any_pos
