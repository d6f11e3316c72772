"""The estimator, its registries and its result schema."""

from repro_torch.api.engines import (
    Engine,
    get_engine,
    list_engines,
    register_engine,
    select_engine,
)
from repro_torch.api.estimator import BWKM, DEFAULT_CHUNK_SIZE
from repro_torch.api.inits import InitStrategy, list_inits, register_init, resolve_init
from repro_torch.api.result import FitResult, from_driver_result
from repro_torch.service.session import BWKMSession, ServiceConfig

__all__ = [
    "BWKM",
    "BWKMSession",
    "DEFAULT_CHUNK_SIZE",
    "Engine",
    "FitResult",
    "InitStrategy",
    "ServiceConfig",
    "from_driver_result",
    "get_engine",
    "list_engines",
    "list_inits",
    "register_engine",
    "register_init",
    "resolve_init",
    "select_engine",
]
