"""Incremental BWKM session: mini-batch updates on a live partition.

Counterpart of ``repro.service.session``. The loop per batch:

  1. **Decay**: ``decay_stats`` scales block mass by γ so old stream
     regimes fade (the boxes stay: they are geometric routing state).
  2. **Merge**: route the batch into the live boxes with the clipped-L∞
     rule (``core.partition.route_into_boxes``), fold it to
     :class:`BlockStats` and combine it into the partition.
  3. **Track**: a few warm-started weighted-Lloyd iterations over the
     updated representatives (kernels B2/B3) keep the centroids current
     and refresh the per-block top-2 squared distances that the
     misassignment criterion reads.
  4. **Refit on drift**: when the ε-boundary holds more than the configured
     fraction of the mass, sample boundary blocks ∝ ε, split them
     *virtually* (``split_blocks_virtual``: the member points are gone) and
     run a longer weighted Lloyd.

Every step is a deterministic function of ``(SessionState, batch)`` on one
device: ``block_stats`` sums in exact fixed point, ``combine_block_stats``
adds in f32 in one order, the routing's ``argmin`` keeps the first index on
ties, B2/B3 use no float atomics, and each draw seeds a fresh generator
from its key. So a session restored from a checkpoint and fed the rest of
the stream reproduces the uninterrupted run bit for bit.

A session runs on ``device``, CUDA unless the caller asks for another; the
device is not part of :class:`ServiceConfig`, which a checkpoint's manifest
stores whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import bwkm as core_bwkm
from repro_torch.core import lloyd
from repro_torch.core import misassignment as mis
from repro_torch.core import partition as part_mod
from repro_torch.core.bwkm import BWKMConfig
from repro_torch.core.partition import BlockStats, Partition
from repro_torch.data import chunks as ck
from repro_torch.device import resolve_device
from repro_torch.health import RunHealth
from repro_torch.kernels import ops

__all__ = [
    "BWKMSession",
    "ServiceConfig",
    "SessionState",
    "resume_service",
    "run_service",
]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service-lifecycle knobs around a batch :class:`BWKMConfig`.

    ``decay`` is the per-batch forgetting factor γ (1.0 = infinite memory;
    0.9 halves a batch's influence every ~7 batches). ``refit_boundary_frac``
    is the drift trigger: refit when the ε-boundary holds more than this
    fraction of the partition's mass. ``track_lloyd_iters`` bounds the cheap
    per-batch tracking Lloyd; ``refit_lloyd_iters`` the post-split refit.
    ``keep_checkpoints`` keeps the newest N step directories on each save
    (the newest step that verifies is never deleted); None keeps all.
    """

    base: BWKMConfig
    decay: float = 1.0
    refit_boundary_frac: float = 0.05
    track_lloyd_iters: int = 3
    refit_lloyd_iters: int = 20
    max_splits_per_refit: int | None = None
    seed: int = 0
    keep_checkpoints: int | None = None

    def __post_init__(self):
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.refit_boundary_frac < 0:
            raise ValueError("refit_boundary_frac must be >= 0")


class SessionState(NamedTuple):
    """Everything a resumed session needs, checkpointed whole.

    ``partition.block_id`` is empty: the service keeps no member points,
    only their sufficient statistics. ``d1``/``d2`` are the squared top-2
    centroid distances of every block representative from the last weighted
    Lloyd pass, the bound state the misassignment criterion reads at the
    next batch. ``key`` is advanced only by a refit's split sampling.
    """

    partition: Partition
    centroids: torch.Tensor  # [K, d]
    d1: torch.Tensor  # [M] f32
    d2: torch.Tensor  # [M] f32
    key: rnd.Key
    batches: torch.Tensor  # scalar int32, partial_fit calls so far
    points: torch.Tensor  # scalar f32, cumulative rows consumed


def _session_key(seed: int) -> rnd.Key:
    """The session's root key, made here and nowhere else (a test puts a
    key that follows the reference's draws in its place)."""
    return rnd.key(seed)


def _route_fold(x: torch.Tensor, part: Partition) -> BlockStats:
    """Route a batch into the live boxes and fold it to BlockStats. The
    live rows are the prefix ``[0, n_blocks)`` (splits take rows from
    ``n_blocks`` upward), and every other row is inactive and never wins,
    so routing against the prefix gives the full routing's answer."""
    n_live = int(part.n_blocks)
    bid = part_mod.route_into_boxes(
        x, part.lo[:n_live], part.hi[:n_live], part.active[:n_live]
    )
    return part_mod.block_stats(x, bid, part.capacity)


def _merge_batch(part: Partition, x: torch.Tensor) -> Partition:
    """Combine a batch's folded statistics into the partition (boxes union)."""
    st = _route_fold(x, part)
    merged = part_mod.combine_block_stats(BlockStats(part.psum, part.count, part.lo, part.hi), st)
    return part._replace(psum=merged.psum, count=merged.count, lo=merged.lo, hi=merged.hi)


class BWKMSession:
    """Online BWKM over mini-batches on ``device``; state lives in ``self.state``.

    The first ``partial_fit`` bootstraps with the in-core engine on that
    batch (the full Algorithm 5), then drops the per-point memberships and
    keeps only the weighted partition. Later calls run the
    decay → merge → track → refit loop.
    """

    def __init__(self, config: ServiceConfig, *, device: str | torch.device = "cuda"):
        if not isinstance(config, ServiceConfig):
            raise TypeError(f"expected ServiceConfig, got {type(config).__name__}")
        self.device = resolve_device(device)
        self.config = config
        self.state: SessionState | None = None
        self.last_metrics: dict[str, Any] | None = None
        # cumulative degradation ledger; in every checkpoint's manifest
        self.health = RunHealth()

    # -- lifecycle -----------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self.state is not None

    @property
    def centroids(self) -> torch.Tensor:
        if self.state is None:
            raise RuntimeError("session has no state yet; call partial_fit first")
        return self.state.centroids

    def _as_rows(self, batch) -> torch.Tensor:
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)

    def partial_fit(self, batch) -> dict[str, Any]:
        """Consume one mini-batch; returns its metrics."""
        x = self._as_rows(batch)
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"expected non-empty [n, d] batch, got {tuple(x.shape)}")
        # Quarantine non-finite rows: a NaN would poison every block it
        # merges into, and the service cannot recompute. A function of the
        # batch alone, so replays match.
        finite = torch.isfinite(x).all(dim=1)
        n_bad = int(x.shape[0] - finite.sum())
        if n_bad:
            self.health.quarantined_rows += n_bad
            x = x[finite]
            if x.shape[0] == 0:
                metrics = self._noop_metrics(quarantined=n_bad)
                self.last_metrics = metrics
                return metrics
        if self.state is None:
            metrics = self._bootstrap(x)
        else:
            if x.shape[1] != self.state.partition.dim:
                raise ValueError(
                    f"batch dim {x.shape[1]} != session dim {self.state.partition.dim}"
                )
            metrics = self._update(x)
        self.last_metrics = metrics
        return metrics

    def _noop_metrics(self, *, quarantined: int) -> dict[str, Any]:
        """Metrics of a batch that quarantine consumed whole: the state is
        untouched, the schema is a real batch's."""
        state = self.state
        return {
            "batch": int(state.batches) if state is not None else 0,
            "n_points": 0,
            "quarantined": quarantined,
            "boundary_frac": 0.0,
            "refit": False,
            "n_splits": 0,
            "n_blocks": int(state.partition.n_blocks) if state is not None else 0,
            "error": float(self.last_metrics["error"])
            if self.last_metrics and "error" in self.last_metrics
            else float("nan"),
        }

    def _lloyd(self, reps, w, centroids: torch.Tensor, iters: int) -> lloyd.LloydResult:
        base = self.config.base
        return lloyd.weighted_lloyd(
            reps, w, centroids, max_iters=iters, epsilon=base.lloyd_epsilon, prune=base.prune
        )

    def _bootstrap(self, x: torch.Tensor) -> dict[str, Any]:
        cfg = self.config
        k_fit, carry = rnd.split(_session_key(cfg.seed))
        res = core_bwkm.fit_incore(k_fit, x, cfg.base)
        part = res.partition._replace(
            block_id=torch.zeros(0, dtype=torch.int32, device=self.device)
        )
        reps, w = part_mod.representatives(part)
        lres = self._lloyd(reps, w, res.centroids, cfg.track_lloyd_iters)
        self.state = SessionState(
            partition=part,
            centroids=lres.centroids,
            d1=lres.d1,
            d2=lres.d2,
            key=carry,
            batches=torch.tensor(1, dtype=torch.int32, device=self.device),
            points=torch.tensor(float(x.shape[0]), dtype=torch.float32, device=self.device),
        )
        n_blocks = int(part.n_blocks)
        return {
            "batch": 1,
            "n_points": int(x.shape[0]),
            "boundary_frac": 0.0,
            "refit": True,
            "n_splits": n_blocks - 1,
            "n_blocks": n_blocks,
            "error": float(lres.error),
        }

    def _update(self, x: torch.Tensor) -> dict[str, Any]:
        cfg = self.config
        state = self.state
        part = part_mod.decay_stats(state.partition, cfg.decay)
        part = _merge_batch(part, x)
        reps, w = part_mod.representatives(part)
        lres = self._lloyd(reps, w, state.centroids, cfg.track_lloyd_iters)

        eps = mis.misassignment(part, lres.d1, lres.d2)
        total_w = torch.clamp(w.sum(), min=1e-30)
        boundary_frac = float(torch.where(eps > 0, w, 0.0).sum() / total_w)
        f_size = int((eps > 0).sum())
        free_rows = part.capacity - int(part.n_blocks)

        key = state.key
        n_splits = 0
        refit = boundary_frac > cfg.refit_boundary_frac and f_size > 0 and free_rows > 0
        if refit:
            key, k_cut = rnd.split(key)
            draws = min(f_size, free_rows)
            if cfg.max_splits_per_refit is not None:
                draws = min(draws, cfg.max_splits_per_refit)
            chosen = mis.sample_boundary(k_cut, eps, draws)
            plan = part_mod.split_plan(part, chosen)
            part = part_mod.split_blocks_virtual(part, plan)
            n_splits = int(plan.n_new)
            reps, w = part_mod.representatives(part)
            lres = self._lloyd(reps, w, lres.centroids, cfg.refit_lloyd_iters)

        self.state = SessionState(
            partition=part,
            centroids=lres.centroids,
            d1=lres.d1,
            d2=lres.d2,
            key=key,
            batches=state.batches + 1,
            points=state.points + x.shape[0],
        )
        return {
            "batch": int(self.state.batches),
            "n_points": int(x.shape[0]),
            "boundary_frac": boundary_frac,
            "refit": bool(refit),
            "n_splits": n_splits,
            "n_blocks": int(part.n_blocks),
            "error": float(lres.error),
        }

    # -- inference -----------------------------------------------------------

    def predict(self, x, *, chunk_size: int = 4096) -> torch.Tensor:
        """Nearest-centroid labels ``int32 [n]``, one B1 launch a chunk."""
        c = self.centroids
        x = self._as_rows(x)
        out = [torch.zeros(0, dtype=torch.int32, device=self.device)]
        for start in range(0, x.shape[0], chunk_size):
            seg = x[start : start + chunk_size]
            out.append(ops.assign_top2_chunk(seg, c, chunk_size=chunk_size)[0])
        return torch.cat(out)

    def transform(self, x, *, chunk_size: int = 4096) -> torch.Tensor:
        """The ``[n, K]`` squared distances to the centroids, by chunk."""
        c = self.centroids
        x = self._as_rows(x)
        out = [torch.zeros(0, c.shape[0], dtype=torch.float32, device=self.device)]
        for start in range(0, x.shape[0], chunk_size):
            seg = x[start : start + chunk_size]
            out.append(ops.pairwise_sqdist_chunk(seg, c, chunk_size=chunk_size))
        return torch.cat(out)


def run_service(
    session: BWKMSession,
    source: ck.ChunkSource,
    *,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    start_chunk: int = 0,
    max_chunks: int | None = None,
) -> list[dict[str, Any]]:
    """Drive a session over ``source`` from chunk ``start_chunk``.

    A checkpoint written after chunk ``i`` records cursor ``i + 1``, so
    :func:`resume_service` continues at the first unprocessed chunk. A
    final checkpoint is always written when ``checkpoint_dir`` is set, so a
    cleanly finished stream resumes as a no-op.
    """
    from repro_torch.service import checkpoint as svc_ckpt

    def _checkpoint(cursor: int) -> None:
        # the manifest's health joins the session's ledger with the source's
        # (a ResilientChunkSource's retries and skips): one record says how
        # trustworthy the state is
        src_health = getattr(source, "health", None)
        health = (
            session.health.merged(src_health)
            if isinstance(src_health, RunHealth)
            else session.health
        )
        svc_ckpt.save_session(
            checkpoint_dir, session, cursor=cursor, health=health,
            keep_last_n=session.config.keep_checkpoints,
        )

    metrics: list[dict[str, Any]] = []
    cursor = start_chunk
    for chunk in ck.chunks_from(source, start_chunk):
        if max_chunks is not None and cursor - start_chunk >= max_chunks:
            break
        metrics.append(session.partial_fit(chunk))
        cursor += 1
        if checkpoint_dir and checkpoint_every > 0 and cursor % checkpoint_every == 0:
            _checkpoint(cursor)
    if checkpoint_dir and session.initialized:
        _checkpoint(cursor)
    return metrics


def resume_service(
    checkpoint_dir: str,
    source: ck.ChunkSource,
    *,
    config: ServiceConfig | None = None,
    checkpoint_every: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[BWKMSession, list[dict[str, Any]]]:
    """Restore the latest checkpoint in ``checkpoint_dir`` onto ``device``
    (or start fresh from ``config`` when there is none: a crash before the
    first checkpoint) and consume the rest of ``source`` from the stored
    cursor."""
    from repro_torch.service import checkpoint as svc_ckpt

    restored = svc_ckpt.load_session(checkpoint_dir, device=device)
    if restored is None:
        if config is None:
            raise ValueError(
                f"no checkpoint under {checkpoint_dir!r} and no config to start fresh from"
            )
        session, cursor = BWKMSession(config, device=device), 0
    else:
        session, cursor = restored
    metrics = run_service(
        session,
        source,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        start_chunk=cursor,
    )
    return session, metrics
