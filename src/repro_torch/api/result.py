"""The fit-result schema. Counterpart of ``repro.api.result``."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["FitResult", "from_driver_result"]


@dataclasses.dataclass
class FitResult:
    """What a fit reports. ``metadata`` carries the block counts, boundary
    sizes, weighted errors, the final ``Partition`` and the health ledger,
    and for the streaming engine the passes, rows streamed, chunks and
    chunk size; a baseline of ``repro_torch.core.baselines`` reports its
    own extras there."""

    centroids: Any  # [K, d] torch.Tensor
    distances: float  # total distance computations (the paper's cost unit)
    iterations: int
    stop_reason: str
    engine: str  # "incore" | "streaming" | "baseline:<name>"
    trace: list = dataclasses.field(default_factory=list)
    metadata: dict = dataclasses.field(default_factory=dict)

    @property
    def k(self) -> int:
        return int(self.centroids.shape[0])

    def schema(self) -> tuple[str, ...]:
        """The field names every engine and baseline reports."""
        return tuple(f.name for f in dataclasses.fields(FitResult))


def from_driver_result(res: Any, engine: str) -> FitResult:
    """Convert a ``BWKMResult``-shaped driver result into a :class:`FitResult`."""
    metadata = {
        "n_blocks": list(res.n_blocks),
        "boundary_sizes": list(res.boundary_sizes),
        "weighted_errors": list(res.weighted_errors),
        "partition": res.partition,
    }
    stream = getattr(res, "stream", None)
    if stream is not None:
        metadata["passes"] = stream.passes
        metadata["points_streamed"] = stream.points_streamed
        metadata["n_chunks"] = stream.n_chunks
        metadata["chunk_size"] = stream.chunk_size
    health = getattr(res, "health", None)
    if health is not None:
        metadata["health"] = health.as_dict()
    return FitResult(
        centroids=res.centroids,
        distances=float(res.distances),
        iterations=int(res.iterations),
        stop_reason=res.stop_reason,
        engine=engine,
        trace=list(res.trace),
        metadata=metadata,
    )
