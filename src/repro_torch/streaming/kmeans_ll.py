"""k-means|| over a :class:`~repro_torch.data.chunks.ChunkSource`.

Counterpart of ``repro.streaming.kmeans_ll``. The round loop is the shared
:func:`repro_torch.engine.driver.plane_kmeans_parallel` over
:class:`repro_torch.engine.streaming.StreamLLSession`:

* pass 0 — fold the reservoir-drawn first seed into every chunk's min-d²
  (kernel B5), accumulating the exact cost φ₀;
* rounds 1..R — fold the previous round's candidates first (B5), so φ is
  the exact current normaliser, then draw the round's acceptances on the
  host from the min-d² state and gather the accepted rows by random access;
* final pass — each row to its nearest candidate (B2, or B1 then B4 when
  the candidates are too many for B2) weights the candidates; weighted
  K-means++ reduces them to K seeds.

``rounds + 1`` passes over the data in all.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.data.chunks import ChunkSource
from repro_torch.device import resolve_device
from repro_torch.engine import driver
from repro_torch.engine.streaming import StreamLLSession

__all__ = ["StreamKMeansLLResult", "kmeans_parallel_streaming"]


class StreamKMeansLLResult(NamedTuple):
    centroids: torch.Tensor  # [k, d]
    n_candidates: int  # candidates the oversampling rounds produced
    passes: int  # passes over the data (rounds + 1)
    distances: float  # distance evaluations (the paper's unit)
    normalisers: tuple = ()  # φ of each selection round


def kmeans_parallel_streaming(
    key,
    source: ChunkSource,
    k: int,
    *,
    oversampling: int | None = None,
    rounds: int | None = None,
    device: str | torch.device = "cuda",
) -> StreamKMeansLLResult:
    """k-means|| seeding of ``k`` centroids from a chunked stream, on
    ``device`` (CUDA unless the caller asks for the CPU). Host memory: 4
    B/point of min-d² and the candidates; device memory: a chunk or two."""
    l, r, cap_round = driver.resolve_ll_params(k, oversampling, rounds)  # noqa: E741
    sess = StreamLLSession(
        key, source, k=k, l=l, rounds=r, cap_round=cap_round, device=resolve_device(device)
    )
    out = driver.plane_kmeans_parallel(sess, rounds=r)
    return StreamKMeansLLResult(
        centroids=out["centroids"],
        n_candidates=out["n_candidates"],
        passes=out["passes"],
        distances=out["distances"],
        normalisers=out["normalisers"],
    )
