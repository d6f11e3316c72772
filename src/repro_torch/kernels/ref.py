"""Plain PyTorch versions of the clustering kernels.

These are the semantics the hand-written CUDA kernels in ``csrc/`` must
reproduce: the CPU path of every seam, and the yardstick ``chip_smoke.py``
holds each kernel against on the card. Counterpart of ``repro.kernels.ref``.

Distances use the decomposition ``‖x‖² − 2·x·c + ‖c‖²`` in f32, clamped at
0. The assignment step also returns the *second*-closest squared distance,
which the misassignment function (paper Definition 3) consumes; it is
``+inf`` when K == 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "AssignUpdate",
    "MinSqDistUpdate",
    "PrunedAssignUpdate",
    "pairwise_sqdist",
    "assign_top2",
    "cluster_sums",
    "assign_update",
    "assign_update_pruned",
    "min_sqdist_update",
    "two_pass",
    "weighted_error",
]

_BIG = 3.0e38  # "masked distance" sentinel shared with the CUDA kernels


class AssignUpdate(NamedTuple):
    """Everything one weighted Lloyd step needs from one data pass."""

    assign: torch.Tensor  # [n] i32
    d1: torch.Tensor  # [n] f32, squared distance to the closest centroid
    d2: torch.Tensor  # [n] f32, squared distance to the second closest
    sums: torch.Tensor  # [K, d] f32, Σ 1[assign==k]·w·x
    counts: torch.Tensor  # [K] f32, Σ 1[assign==k]·w
    err: torch.Tensor  # scalar f32, Σ w·d1
    n_dist: torch.Tensor | None = None  # scalar f32, filled by the ops layer


class PrunedAssignUpdate(NamedTuple):
    """One drift-bound-pruned pass: statistics under the composed assignment
    (argmin where ``active``, cached elsewhere); ``d1``/``d2``/``err`` are
    defined only where ``active``."""

    assign: torch.Tensor
    d1: torch.Tensor
    d2: torch.Tensor
    sums: torch.Tensor
    counts: torch.Tensor
    err: torch.Tensor  # Σ_active w·d1
    n_dist: torch.Tensor | None = None


class MinSqDistUpdate(NamedTuple):
    """One k-means|| fold: the running per-row minimum squared distance to
    the candidates folded so far, updated with one batch, and the weighted
    cost ``φ = Σ w·min-d²`` of the updated state."""

    mind2: torch.Tensor  # [n] f32
    cost: torch.Tensor  # scalar f32
    n_dist: torch.Tensor | None = None  # scalar f32, filled by the ops layer


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[n, K]`` between rows of ``x [n,d]`` and ``c [K,d]``."""
    x = x.float()
    c = c.float()
    xn = (x * x).sum(-1, keepdim=True)
    cn = (c * c).sum(-1)
    return torch.clamp(xn - 2.0 * (x @ c.T) + cn[None, :], min=0.0)


def assign_top2(
    x: torch.Tensor, c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(assign [n] i32, d1 [n] f32, d2 [n] f32)``; ties go to the smallest
    centroid id and ``d2 = +inf`` when K == 1."""
    d2all = pairwise_sqdist(x, c)
    assign = torch.argmin(d2all, dim=-1)  # first minimum on ties
    d1 = d2all.gather(1, assign[:, None])[:, 0]
    if c.shape[0] == 1:
        second = torch.full_like(d1, float("inf"))
    else:
        masked = d2all.scatter(1, assign[:, None], float("inf"))
        second = masked.min(dim=-1).values
    return assign.to(torch.int32), d1, second


def cluster_sums(
    x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor, num_clusters: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-cluster sums ``[K, d]`` and counts ``[K]`` as a one-hot
    contraction (the same function for every device and every caller, so
    the dense and pruned passes accumulate in the same order)."""
    w = w.float()
    onehot = (
        assign.long()[:, None] == torch.arange(num_clusters, device=x.device)[None, :]
    ).float() * w[:, None]
    return onehot.T @ x.float(), onehot.sum(0)


def two_pass(top2, sums_fn, x, w, c, cached=None, active=None):
    """``(assign, d1, d2, sums, counts, err)`` of one Lloyd pass in two
    passes: ``top2(x, c)``, then ``sums_fn`` under the assignment — argmin
    where ``active``, ``cached`` elsewhere (argmin everywhere when ``active``
    is None). ``err`` covers the active rows. One body for the dense and
    pruned passes, so their statistics are bit-equal whenever the
    assignments agree; ``ops`` runs it with the kernels' seams."""
    a_new, d1, d2 = top2(x, c)
    wd1 = w.float() * d1
    if active is None:
        a, err = a_new, wd1.sum()
    else:
        active = active.bool()
        a = torch.where(active, a_new, cached.to(torch.int32))
        err = torch.where(active, wd1, torch.zeros_like(wd1)).sum()
    sums, counts = sums_fn(x, w, a, c.shape[0])
    return a, d1, d2, sums, counts, err


def assign_update(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> AssignUpdate:
    """Two-pass reference for the fused kernel: top-2 then statistics over the
    same centroids. Zero-weight rows get an assignment but add nothing."""
    return AssignUpdate(*two_pass(assign_top2, cluster_sums, x, w, c))


def assign_update_pruned(
    x: torch.Tensor,
    w: torch.Tensor,
    c: torch.Tensor,
    assign: torch.Tensor,
    active: torch.Tensor,
) -> PrunedAssignUpdate:
    """Semantics of the pruned pass, computed densely."""
    return PrunedAssignUpdate(*two_pass(assign_top2, cluster_sums, x, w, c, assign, active))


def min_sqdist_update(
    x: torch.Tensor,
    w: torch.Tensor,
    cand: torch.Tensor,
    cvalid: torch.Tensor,
    mind2: torch.Tensor,
) -> MinSqDistUpdate:
    """Fold the batch ``cand [L, d]`` (rows with ``cvalid == 0`` masked to
    ``_BIG``, so they never win) into ``mind2 [n]``, which may be ``_BIG`` on
    the first fold. Zero-weight rows update ``mind2`` but add nothing."""
    d2 = pairwise_sqdist(x, cand)
    d2 = torch.where(cvalid.bool()[None, :], d2, _BIG)
    new = torch.minimum(mind2.float(), d2.min(dim=-1).values)
    return MinSqDistUpdate(new, (w.float() * new).sum())


def weighted_error(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``E^P(C) = Σ_i w_i·‖x_i − c_{x_i}‖²`` (paper Section 1.2.2.1)."""
    _, d1, _ = assign_top2(x, c)
    return (w.float() * d1).sum()
