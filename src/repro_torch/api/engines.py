"""Engine registry and auto-selection. Counterpart of ``repro.api.engines``.

One BWKM algorithm (``engine.driver.fit_plane``), two planes so far:

* ``incore`` — :class:`~repro_torch.engine.incore.InCorePlane` over a
  resident tensor;
* ``streaming`` — :class:`~repro_torch.engine.streaming.StreamingPlane` over
  a chunk source; O(chunk + M·d) device memory, several passes.

The reference's ``distributed`` engine is named here so that asking for it
says which ROADMAP item brings it. Rules of ``engine="auto"``, the
reference's without its mesh rule (the port has no mesh yet):

1. an explicit engine name wins;
2. out-of-core data (a path, glob, directory, shard list or chunk source)
   goes to ``streaming``;
3. data in memory larger than ``incore_limit_bytes`` goes to ``streaming``;
4. everything else to ``incore``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import numpy as np

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
    fit: Callable[..., FitResult]  # (key, data, config, *, chunk_size, trace_centroids, device)


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


def _fit_incore(key, data, config, *, chunk_size, trace_centroids, device) -> FitResult:
    del chunk_size
    _warn_dropped("incore", init_sample_size=config.init_sample_size)
    from repro_torch.engine import driver, incore

    x = adapters.to_array(data, device)
    res = driver.fit_plane(key, incore.InCorePlane(x), config, trace_centroids=trace_centroids)
    return from_driver_result(res, "incore")


def _fit_streaming(key, data, config, *, chunk_size, trace_centroids, device) -> FitResult:
    from repro_torch.engine import driver, streaming

    source = adapters.to_chunk_source(data, chunk_size)
    res = driver.fit_plane(
        key, streaming.StreamingPlane(source, device), config, trace_centroids=trace_centroids
    )
    return from_driver_result(res, "streaming")


_REGISTRY: dict[str, Engine] = {}
_NOT_PORTED = {"distributed": "queue A item 13 (distributed)"}


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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported to repro_torch yet: ROADMAP {_NOT_PORTED[name]}"
        )
    raise ValueError(f"unknown engine {name!r}; known: {sorted(_REGISTRY)} (or 'auto')")


def select_engine(
    data: Any, requested: str = "auto", *, incore_limit_bytes: int = INCORE_LIMIT_BYTES
) -> str:
    """The engine the rules above pick for ``data``."""
    if requested != "auto":
        return get_engine(requested).name
    if adapters.is_out_of_core(data):
        return "streaming"
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
