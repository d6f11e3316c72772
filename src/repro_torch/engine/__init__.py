"""The plane and session protocols, the driver, and the in-core, streaming
and sharded planes."""

from repro_torch.engine.driver import (
    fit_plane,
    ll_bernoulli,
    plane_kmeans_parallel,
    plane_lloyd,
    resolve_ll_params,
)
from repro_torch.engine.incore import InCoreLLSession, InCorePlane
from repro_torch.engine.plane import DataPlane, LLSession, LloydSession, global_extent
from repro_torch.engine.sharded import ShardedPlane
from repro_torch.engine.streaming import StreamingLloydSession, StreamingPlane, StreamLLSession

__all__ = [
    "DataPlane",
    "InCoreLLSession",
    "InCorePlane",
    "LLSession",
    "LloydSession",
    "ShardedPlane",
    "StreamLLSession",
    "StreamingLloydSession",
    "StreamingPlane",
    "fit_plane",
    "global_extent",
    "ll_bernoulli",
    "plane_kmeans_parallel",
    "plane_lloyd",
    "resolve_ll_params",
]
