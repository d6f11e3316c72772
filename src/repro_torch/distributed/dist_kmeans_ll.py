"""Distributed k-means|| over the rows of a mesh.

Counterpart of ``repro.distributed.dist_kmeans_ll``: the shared
:func:`repro_torch.engine.driver.plane_kmeans_parallel` over
:class:`~repro_torch.engine.sharded.ShardedLLSession`. Each rank keeps the
min-d² of its own rows (gathered whole over ``"model"`` on a feature
split) and folds every candidate batch with B5; the cost
``φ`` and the weighting counts are added over the ranks in rank order; the
draws and the final weighted K-means++ run on replicated values, so every
rank gets the same seeds. Without a mesh this is exactly
``core.kmeans_ll.kmeans_parallel``.
"""

from __future__ import annotations

import torch

from repro_torch.core import kmeans_ll as core_ll
from repro_torch.distributed import sharding as sh
from repro_torch.engine import driver as engine_driver
from repro_torch.engine import sharded

__all__ = ["dist_kmeans_parallel"]


def dist_kmeans_parallel(
    key,
    x: torch.Tensor,
    k: int,
    *,
    w: torch.Tensor | None = None,
    oversampling: int | None = None,
    rounds: int | None = None,
) -> torch.Tensor:
    """k-means|| seeding of ``k`` centroids from this rank's part ``x`` of
    the data (:func:`~repro_torch.engine.sharded.shard_points`; ``w``
    split with its rows), every rank with the same ``key``. The seeds are
    the same on every rank and from run to run on a given mesh."""
    if sh.current_mesh() is None:
        return core_ll.kmeans_parallel(key, x, w, k, oversampling=oversampling, rounds=rounds)
    w = torch.ones(x.shape[0], device=x.device) if w is None else w
    l, r, cap_round = engine_driver.resolve_ll_params(k, oversampling, rounds)  # noqa: E741
    sess = sharded.ShardedLLSession(key, x, w, k=k, l=l, rounds=r, cap_round=cap_round)
    return engine_driver.plane_kmeans_parallel(sess, rounds=r)["centroids"]
