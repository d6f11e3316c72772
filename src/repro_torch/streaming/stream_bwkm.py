"""Out-of-core BWKM (paper Algorithm 5) and full-stream Lloyd.

Counterpart of ``repro.streaming.stream_bwkm``. :func:`fit_streaming` is the
shared driver :func:`repro_torch.engine.driver.fit_plane` over
:class:`repro_torch.engine.streaming.StreamingPlane`: a split round is one
pass that repairs each chunk's memberships and folds its block statistics;
Lloyd and the misassignment run on the representatives with no pass at
all. :func:`streaming_lloyd` is :func:`~repro_torch.engine.driver.plane_lloyd`
over :class:`~repro_torch.engine.streaming.StreamingLloydSession`. Every
entry point runs on ``device``, CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bwkm as core_bwkm
from repro_torch.data.chunks import ChunkSource, padded_device_chunks
from repro_torch.device import resolve_device
from repro_torch.engine import driver
from repro_torch.engine.streaming import (
    StreamBWKMResult,
    StreamingLloydSession,
    StreamingPlane,
    StreamStats,
)
from repro_torch.kernels import ops

__all__ = [
    "StreamBWKMResult",
    "StreamStats",
    "StreamingLloydResult",
    "fit_streaming",
    "streaming_error",
    "streaming_lloyd",
    "streaming_lloyd_step",
]


def fit_streaming(
    key,
    source: ChunkSource,
    config: core_bwkm.BWKMConfig,
    *,
    trace_centroids: bool = False,
    device: str | torch.device = "cuda",
) -> StreamBWKMResult:
    """Algorithm 5 over a chunked stream. The result's ``partition.block_id``
    is empty (the memberships are host state); ``result.stream`` counts the
    passes and the rows streamed."""
    plane = StreamingPlane(source, resolve_device(device))
    return driver.fit_plane(key, plane, config, trace_centroids=trace_centroids)


def _centroids(c, device) -> torch.Tensor:
    if isinstance(c, torch.Tensor):
        return c.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.require(c, np.float32, ["C", "W"])).to(device)


def streaming_lloyd_step(
    source: ChunkSource, c, *, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, float]:
    """One exact Lloyd iteration over the whole stream: ``(new_c, error)``.
    The statistics and the error add up on the device, chunk by chunk."""
    dev = resolve_device(device)
    c = _centroids(c, dev)
    k, d = c.shape
    sums = torch.zeros(k, d, device=dev)
    counts = torch.zeros(k, device=dev)
    err = torch.zeros((), device=dev)
    for x, nv in padded_device_chunks(source, dev):
        wv = (torch.arange(x.shape[0], device=dev) < nv).float()
        fu = ops.assign_update_chunk(x, wv, c, chunk_size=x.shape[0])
        sums, counts, err = sums + fu.sums, counts + fu.counts, err + fu.err
    new_c = torch.where((counts > 0)[:, None], sums / torch.clamp(counts, min=1e-30)[:, None], c)
    return new_c, float(err)


def streaming_error(source: ChunkSource, c, *, device: str | torch.device = "cuda") -> float:
    """The exact K-means error E^D(C) (Eq. 1) in one pass."""
    return streaming_lloyd_step(source, c, device=device)[1]


class StreamingLloydResult(NamedTuple):
    centroids: torch.Tensor  # [K, d]
    error: float  # exact weighted error at the final centroids
    iters: int  # Lloyd iterations after the seeding pass
    distances: float  # distance computations
    active_fractions: list[float]  # per iteration, the share of rows rescanned


def streaming_lloyd(
    source: ChunkSource,
    c,
    *,
    max_iters: int = 50,
    epsilon: float = 1e-4,
    prune: bool | None = None,
    device: str | torch.device = "cuda",
) -> StreamingLloydResult:
    """Full-stream Lloyd from ``c [K, d]``, with drift-bound pruning carried
    across chunk folds (``prune=None`` means on). Stops on Eq. 2's relative
    error change; pruned and dense reach the same centroids bit for bit."""
    dev = resolve_device(device)
    c = _centroids(c, dev)
    sess = StreamingLloydSession(source, c.shape[0], prune=prune is None or bool(prune), device=dev)
    c, err, it, distances, active_fractions = driver.plane_lloyd(
        sess, c, max_iters=max_iters, epsilon=epsilon
    )
    return StreamingLloydResult(c, err, it, distances, active_fractions)
