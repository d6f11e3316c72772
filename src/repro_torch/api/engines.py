"""Engine registry and auto-selection. Counterpart of ``repro.api.engines``.

One BWKM algorithm (``engine.driver.fit_plane``), three planes:

* ``incore`` — :class:`~repro_torch.engine.incore.InCorePlane` over a
  resident tensor;
* ``streaming`` — :class:`~repro_torch.engine.streaming.StreamingPlane` over
  a chunk source; O(chunk + M·d) device memory, several passes;
* ``distributed`` — :class:`~repro_torch.engine.sharded.ShardedPlane` over
  the rows of a mesh (``repro_torch.distributed.sharding.use_mesh``), each
  rank holding its own block; one shard without a mesh.

Rules of ``engine="auto"``, the reference's:

1. an explicit engine name wins;
2. out-of-core data (a path, glob, directory, shard list or chunk source)
   goes to ``streaming``;
3. data in memory with an active mesh goes to ``distributed``;
4. data in memory larger than ``incore_limit_bytes`` goes to ``streaming``;
5. everything else to ``incore``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api import adapters
from repro_torch.api.result import FitResult, from_driver_result

__all__ = [
    "INCORE_LIMIT_BYTES", "Engine", "get_engine", "list_engines", "register_engine",
    "select_engine",
]

#: auto-selection: data in memory beyond this is streamed in chunks
INCORE_LIMIT_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class Engine:
    name: str
    description: str
    # (key, data, config, *, chunk_size, trace_centroids, device, checkpoint_dir)
    fit: Callable[..., FitResult]


def _warn_dropped(engine: str, **options: Any) -> None:
    """An option set explicitly that an engine cannot honour must not
    vanish silently."""
    for name, value in options.items():
        if value:
            warnings.warn(
                f"the {engine!r} engine does not support {name}; the option is ignored",
                UserWarning,
                stacklevel=4,
            )


def _fit_incore(key, data, config, *, chunk_size, trace_centroids, device, checkpoint_dir) -> FitResult:
    del chunk_size
    _warn_dropped("incore", checkpoint_dir=checkpoint_dir, init_sample_size=config.init_sample_size)
    from repro_torch.engine import driver, incore

    x = adapters.to_array(data, device)
    res = driver.fit_plane(key, incore.InCorePlane(x), config, trace_centroids=trace_centroids)
    return from_driver_result(res, "incore")


def _fit_streaming(key, data, config, *, chunk_size, trace_centroids, device, checkpoint_dir) -> FitResult:
    _warn_dropped("streaming", checkpoint_dir=checkpoint_dir)
    from repro_torch.engine import driver, streaming

    source = adapters.to_chunk_source(data, chunk_size)
    res = driver.fit_plane(
        key, streaming.StreamingPlane(source, device), config, trace_centroids=trace_centroids
    )
    return from_driver_result(res, "streaming")


def _fit_distributed(key, data, config, *, chunk_size, trace_centroids, device, checkpoint_dir) -> FitResult:
    del chunk_size
    _warn_dropped("distributed", trace_centroids=trace_centroids,  # keeps no trace
                  init_sample_size=config.init_sample_size)
    from repro_torch.engine import driver, sharded

    # only this rank's block goes to the device
    rows = data if isinstance(data, torch.Tensor) else adapters.to_array(data, "cpu")
    plane = sharded.ShardedPlane(
        sharded.shard_points(rows, device=device), checkpoint_dir=checkpoint_dir
    )
    return from_driver_result(driver.fit_plane(key, plane, config), "distributed")


_REGISTRY: dict[str, Engine] = {}


def register_engine(engine: Engine) -> Engine:
    """Make ``engine`` selectable by name in every ``BWKM``."""
    _REGISTRY[engine.name] = engine
    return engine


def list_engines() -> dict[str, str]:
    """``{name: description}`` for every registered engine."""
    return {e.name: e.description for e in _REGISTRY.values()}


def get_engine(name: str) -> Engine:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(f"unknown engine {name!r}; known: {sorted(_REGISTRY)} (or 'auto')")


def select_engine(
    data: Any, requested: str = "auto", *, incore_limit_bytes: int = INCORE_LIMIT_BYTES
) -> str:
    """The engine the rules above pick for ``data``."""
    if requested != "auto":
        return get_engine(requested).name
    if adapters.is_out_of_core(data):
        return "streaming"
    from repro_torch.distributed import sharding as sh

    if sh.current_mesh() is not None:
        return "distributed"
    nbytes = getattr(data, "nbytes", None)
    if nbytes is None:
        nbytes = np.asarray(data).nbytes
    return "streaming" if nbytes > incore_limit_bytes else "incore"


register_engine(Engine("incore", "single-device Algorithm 5 over a resident tensor", _fit_incore))
register_engine(Engine(
    "streaming",
    "out-of-core Algorithm 5 over fixed-size chunks; device memory stays O(chunk + M·d)",
    _fit_streaming,
))
register_engine(Engine(
    "distributed",
    "Algorithm 5 over the rows of a mesh; points stay on their rank, block statistics "
    "combine exactly over the ranks",
    _fit_distributed,
))
