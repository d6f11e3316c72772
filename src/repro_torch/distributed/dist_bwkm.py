"""Distributed BWKM: the paper's algorithm over the rows, and the features,
of a mesh.

Counterpart of ``repro.distributed.dist_bwkm``. The outer loop is the shared
:func:`repro_torch.engine.driver.fit_plane` over
:class:`~repro_torch.engine.sharded.ShardedPlane`; the mesh form of the data
passes (exact cross-rank block statistics, drop-and-reweight, the sample →
build → route initialisation) lives in :mod:`repro_torch.engine.sharded`
and is re-exported here for callers that reach for the distributed layer
directly. Every rank calls these functions with its own part of the data
(:func:`shard_points`: its batch rank's rows, and its model rank's columns
of them where the ``"model"`` dimension divides d) and gets the same
result.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import bwkm as core_bwkm
from repro_torch.engine import driver as engine_driver
from repro_torch.engine import sharded
from repro_torch.engine.sharded import (  # noqa: F401  (re-exported surface)
    DistLloydResult,
    ShardedPlane,
    ShardLossError,
    dist_assign_step,
    dist_recompute_stats,
    dist_route_points,
    n_data_shards,
    shard_points,
)

__all__ = ["ShardLossError", "shard_points", "dist_recompute_stats",
           "dist_route_points", "dist_assign_step", "dist_lloyd",
           "DistLloydResult", "fit_distributed", "n_data_shards"]


def dist_lloyd(
    x: torch.Tensor,
    c: torch.Tensor,
    *,
    w: torch.Tensor | None = None,
    max_iters: int = 50,
    epsilon: float = 1e-4,
    prune: bool | None = None,
) -> DistLloydResult:
    """Full-data Lloyd over the ranks' rows (``x`` from :func:`shard_points`)
    with drift-bound pruning (``prune=None`` means on), from ``c [K, d]``
    on every rank: the shared
    :func:`repro_torch.engine.driver.plane_lloyd` loop over
    :class:`~repro_torch.engine.sharded.ShardedLloydSession`. Pruned and
    dense reach the same centroids bit for bit; ``distances`` counts the
    kernels' distance evaluations over all ranks."""
    sess = sharded.ShardedLloydSession(x, w, k=c.shape[0], prune=prune is None or bool(prune))
    c, err, it, distances, _ = engine_driver.plane_lloyd(sess, c, max_iters=max_iters, epsilon=epsilon)
    return DistLloydResult(centroids=c, error=err, iters=it, distances=distances)


def fit_distributed(
    key,
    x: torch.Tensor,
    config: core_bwkm.BWKMConfig,
    *,
    checkpoint_dir: str | None = None,
    shard_faults: "dict[int, Sequence[int]] | None" = None,
    max_shard_loss_frac: float = 0.5,
) -> core_bwkm.BWKMResult:
    """Distributed Algorithm 5 over this rank's part ``x`` of the data
    (:func:`shard_points`), every rank with the same ``key``. The engine
    behind ``BWKM(engine="distributed")``; its statistics, and so its
    result, are bit-equal on every mesh.

    ``shard_faults`` maps a statistics round (0 = the initial routing
    round, ``i`` = the split round of outer iteration ``i``) to data shards
    whose ``BlockStats`` are lost that round; the survivors are
    mass-reweighted, and :class:`ShardLossError` aborts (on every rank) a
    round that loses more than ``max_shard_loss_frac`` of the mass. The
    result's ``health`` records shards lost and degraded rounds."""
    plane = sharded.ShardedPlane(
        x, checkpoint_dir=checkpoint_dir, shard_faults=shard_faults,
        max_shard_loss_frac=max_shard_loss_frac,
    )
    return engine_driver.fit_plane(key, plane, config)
