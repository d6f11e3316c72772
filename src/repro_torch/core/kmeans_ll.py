"""k-means|| — scalable K-means++ by oversampling (Bahmani et al., VLDB 2012).

Counterpart of ``repro.core.kmeans_ll``. Each of a few rounds draws every
row independently with probability ``min(1, ℓ·w·d²(x, C)/φ)`` (``φ`` the
current weighted cost, ``ℓ`` the oversampling factor, default ``2K``), so
the candidate set grows to about ``1 + rounds·ℓ`` rows. A weighting pass
gives each candidate the weight of the rows closest to it, and weighted
K-means++ reduces the candidates to the K seeds: K-means++ quality in
``rounds + 2`` data passes instead of K.

The round loop lives once in :func:`repro_torch.engine.driver.plane_kmeans_parallel`;
this module is the resident-tensor entry point over
:class:`repro_torch.engine.incore.InCoreLLSession`. Each round's fold is one
``ops.min_sqdist_update`` (kernel B5 on CUDA) and the weighting pass one
``ops.assign_update`` (B2, or B1 + B4 where the candidates are too many for
B2). Each round's accepted rows are packed into a fixed batch of
``cap_round`` rows with a validity mask; unfilled rows are parked at
``_FAR`` so the weighting pass never assigns a row to one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["KMeansLLResult", "default_oversampling", "kmeans_parallel"]

#: parking coordinate for unfilled candidate rows: far enough that no real
#: row is ever assigned to one, small enough that its squared distance
#: (~1e30·d) stays finite in f32 for any practical d
_FAR = 1.0e15


class KMeansLLResult(NamedTuple):
    centroids: torch.Tensor  # [k, d]
    n_candidates: torch.Tensor  # scalar f32: valid candidates after all rounds
    distances: torch.Tensor  # scalar f32: distance evaluations (the paper's unit)
    passes: int  # sequential data passes (rounds + 2)


def default_oversampling(k: int) -> int:
    """The conventional ℓ = 2K (Bahmani et al. evaluate ℓ from 0.1K to 10K)."""
    return 2 * k


def kmeans_parallel(
    key,
    x,
    w: torch.Tensor | None,
    k: int,
    *,
    oversampling: int | None = None,
    rounds: int | None = None,
    return_info: bool = False,
) -> torch.Tensor | KMeansLLResult:
    """Weighted k-means|| seeding over a resident point set.

    ``key`` is a key of :mod:`repro_torch.random`; ``x [n, d]`` the points
    (a tensor stays on its device, anything else goes to CUDA; taken as f32
    unless it is bf16); ``w [n]`` nonnegative weights (``None``: all ones). Zero-weight rows are never drawn and add
    nothing to ``φ``. ``oversampling`` is ℓ (default ``2K``),
    ``rounds`` the number of oversampling rounds (default 5). Returns the
    ``[k, d]`` seeds, or a :class:`KMeansLLResult` with ``return_info``.
    """
    from repro_torch.engine import driver
    from repro_torch.engine.incore import InCoreLLSession

    x = torch.as_tensor(x, device=x.device if isinstance(x, torch.Tensor) else "cuda")
    if x.dtype != torch.bfloat16:  # the kernels load f32 or bf16 and compute in f32
        x = x.float()
    w = torch.ones(x.shape[0], device=x.device) if w is None else torch.as_tensor(
        w, dtype=torch.float32, device=x.device)
    l, r, cap_round = driver.resolve_ll_params(k, oversampling, rounds)  # noqa: E741
    sess = InCoreLLSession(key, x, w, k=k, l=l, rounds=r, cap_round=cap_round)
    out = driver.plane_kmeans_parallel(sess, rounds=r)
    if not return_info:
        return out["centroids"]
    return KMeansLLResult(
        centroids=out["centroids"],
        n_candidates=out["n_candidates"],
        distances=out["distances"],
        passes=out["passes"],
    )
