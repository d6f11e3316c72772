"""The data-plane and k-means|| session protocols, the driver and the in-core plane."""

from repro_torch.engine.driver import (
    fit_plane,
    ll_bernoulli,
    plane_kmeans_parallel,
    resolve_ll_params,
)
from repro_torch.engine.incore import InCoreLLSession, InCorePlane
from repro_torch.engine.plane import DataPlane, LLSession

__all__ = [
    "DataPlane",
    "InCoreLLSession",
    "InCorePlane",
    "LLSession",
    "fit_plane",
    "ll_bernoulli",
    "plane_kmeans_parallel",
    "resolve_ll_params",
]
