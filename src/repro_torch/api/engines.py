"""Engine registry. Counterpart of ``repro.api.engines``, with the ``incore``
engine only: the reference's ``streaming`` and ``distributed`` engines are
named here so that asking for one says which ROADMAP item brings it."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.api.result import FitResult, from_driver_result

__all__ = ["Engine", "get_engine"]


@dataclasses.dataclass(frozen=True)
class Engine:
    name: str
    description: str
    fit: Callable[..., FitResult]  # (key, x: resident tensor, config, *, trace_centroids)


def _fit_incore(key, x: torch.Tensor, config, *, trace_centroids: bool) -> FitResult:
    from repro_torch.engine import driver, incore

    res = driver.fit_plane(key, incore.InCorePlane(x), config, trace_centroids=trace_centroids)
    return from_driver_result(res, "incore")


_REGISTRY = {
    "incore": Engine(
        "incore", "single-device Algorithm 5 over a resident tensor", _fit_incore
    )
}
_NOT_PORTED = {
    "streaming": "queue A item 11 (streaming)",
    "distributed": "queue A item 13 (distributed)",
}


def get_engine(name: str) -> Engine:
    """The engine ``name``; ``"auto"`` resolves to ``incore``, the only one."""
    name = "incore" if name == "auto" else name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported to repro_torch yet: ROADMAP {_NOT_PORTED[name]}"
        )
    raise ValueError(f"unknown engine {name!r}; known: {sorted(_REGISTRY)} (or 'auto')")
