"""BWKM (Boundary Weighted K-means) in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the ``repro`` package: ``BWKM(k).fit(x)`` on a resident tensor,
then ``predict`` / ``score`` / ``transform``; k-means|| and AFK-MC²
seeding; the out-of-core streaming engine, which ``BWKM(k).fit`` picks for
a path, glob, directory, shard list, ``ChunkSource`` or an array over 1 GiB
(``repro_torch.streaming`` has its entry points); the online service
(``BWKMSession``, ``BWKM.partial_fit``); and the paper's baselines and
trade-off metrics (``repro_torch.core.baselines``,
``repro_torch.core.metrics``); and ``repro_torch.vq``, KV-cache
quantization and MoE router seeding over the models of
``repro_torch.models`` (dense, moe and audio families). It runs on CUDA unless the caller passes
``device="cpu"``, where every kernel seam takes its plain PyTorch version.
The engine and init registries are open: ``register_engine`` and
``register_init`` plug new strategies into the same ``BWKM``.
"""

from repro_torch.api import (
    BWKM,
    BWKMSession,
    Engine,
    FitResult,
    InitStrategy,
    ServiceConfig,
    get_engine,
    list_engines,
    list_inits,
    register_engine,
    register_init,
    select_engine,
)
from repro_torch.core.bwkm import BWKMConfig
from repro_torch.data.chunks import ChunkSource, as_chunk_source
from repro_torch.data.resilient import ResilientChunkSource, RetryPolicy
from repro_torch.health import RunHealth
from repro_torch import vq

__version__ = "0.2.0"

__all__ = [
    "BWKM",
    "BWKMConfig",
    "BWKMSession",
    "ChunkSource",
    "Engine",
    "FitResult",
    "InitStrategy",
    "ResilientChunkSource",
    "RetryPolicy",
    "RunHealth",
    "ServiceConfig",
    "as_chunk_source",
    "get_engine",
    "list_engines",
    "list_inits",
    "register_engine",
    "register_init",
    "select_engine",
    "vq",
    "__version__",
]
