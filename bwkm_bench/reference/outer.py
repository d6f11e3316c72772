"""Algorithm 5's outer loop, written from its rules (paper Definition 3,
Eq. 5 and Section 2.4.2), in float64 where it measures:

* :func:`misassignment`: ``ε(B) = max{0, 2·l_B − (‖P̄ − c₂‖ − ‖P̄ − c₁‖)}``
  for every occupied block, from its tight box and its representative's
  top-2 squared distances;
* :func:`fit_loop_bad`: each iteration's decision to go on or to stop, and
  the stop reason, against the stated criteria — the boundary empty, the
  block capacity reached, the iteration cap (no distance budget, no
  displacement or gap-bound threshold is configured);
* :func:`split_bad`: a split round cuts only boundary blocks (``ε > 0``), at
  least one and at most as many as it draws, and plans exactly the blocks
  that may split (active, more than one member, a free row for the child);
* :func:`draw_moments`: the mean and a bound on the variance of the number
  of distinct blocks that ``D`` draws with replacement ``∝ ε`` hit. With
  ``N_B`` the draws that hit block ``B`` (multinomial), both the indicators
  ``[N_B ≥ 1]`` and the repeats ``(N_B − 1)⁺`` are increasing functions of
  the counts of disjoint blocks, so negatively associated: the sum of
  either's variances bounds the variance of their sum, and the distinct
  blocks are ``D − Σ (N_B − 1)⁺``. The smaller of the two sums is the bound;
  a round that cuts far fewer blocks than its draws would reads many of
  these deviations short.
"""

from __future__ import annotations

import torch

__all__ = ["draw_moments", "fit_loop_bad", "misassignment", "split_bad"]


def misassignment(lo, hi, occupied, d1, d2) -> torch.Tensor:
    """``ε [M]`` in float64; 0 where a block is not occupied."""
    ext = (hi.double() - lo.double()).clamp(min=0.0)
    ext = torch.where(occupied[:, None], ext, 0.0)
    diag = torch.linalg.vector_norm(ext, dim=-1)
    delta = d2.double().clamp(min=0.0).sqrt() - d1.double().clamp(min=0.0).sqrt()
    eps = (2.0 * diag - delta).clamp(min=0.0)
    return torch.where(occupied, eps, 0.0)


def split_bad(eps, chosen, fits, n_new, n_blocks: int, active, count, capacity: int,
              draws: int) -> int:
    """Violations of the split rule in one round (see the module's doc)."""
    pos = eps > 0
    got = int(chosen.sum())
    bad = int(bool((chosen & ~pos).any())) + int(not 1 <= got <= draws)
    want = chosen & active & (count > 1)
    rank = torch.cumsum(want.long(), 0) - 1
    want = want & (n_blocks + rank < capacity)
    return bad + int(bool((fits != want).any())) + int(int(n_new) != int(want.sum()))


def draw_moments(eps, draws: int) -> tuple[float, float]:
    """``(mean, variance bound)`` of the distinct blocks hit by ``draws``
    draws with replacement, block ``B`` with probability ``ε_B / Σε``."""
    e = eps.double().clamp(min=0.0)
    p = e / e.sum().clamp(min=1e-300)
    q = -torch.expm1(draws * torch.log1p(-p.clamp(max=1.0)))  # P(N_B >= 1)
    mean_n = draws * p
    # (N − 1)⁺: mean D·p − q, second moment E[N²] − 2E[N] + q
    rep = mean_n - q
    rep2 = mean_n * (1.0 - p) + mean_n ** 2 - 2.0 * mean_n + q
    var = min(float((q * (1.0 - q)).sum()), float((rep2 - rep ** 2).clamp(min=0.0).sum()))
    return float(q.sum()), var


def fit_loop_bad(iterations: int, reason: str, rounds: list, final_blocks: int,
                 capacity: int, max_iters: int) -> int:
    """Violations of the stop rules over one fit. ``rounds`` has one
    ``(boundary non-empty, blocks, blocks added by its split or None)`` an
    outer iteration, in order; ``final_blocks`` is the result's."""
    bad = int(len(rounds) != iterations)
    for t, (pos, nb, new) in enumerate(rounds, 1):
        go_on = pos and nb < capacity
        if t < len(rounds):
            bad += int(not (go_on and new is not None and t < max_iters
                            and rounds[t][1] == nb + new))
        elif reason == "boundary-empty":
            bad += int(not (not pos and new is None and final_blocks == nb))
        elif reason == "capacity":
            bad += int(not (pos and nb >= capacity and new is None and final_blocks == nb))
        elif reason == "max-iters":
            bad += int(not (go_on and t == max_iters and new is not None
                            and final_blocks == nb + new))
        else:  # a criterion the configuration does not state
            bad += 1
    return bad
