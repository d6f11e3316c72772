"""``repro_torch.BWKM`` — the estimator. Counterpart of ``repro.api.estimator``.

    >>> model = BWKM(k=27).fit(x)                 # x: [n, d] tensor or array; runs on CUDA
    >>> model = BWKM(k=27).fit("shards/*.npy")    # out of core: the streaming engine
    >>> labels = model.predict("shards/*.npy")    # int32 tensor on the model's device
    >>> model.score(x), model.result_.stop_reason, model.engine_
    >>> model = BWKM(k=27).partial_fit(batch)     # one mini-batch of a stream: the service

``fit`` takes a tensor, an array or nested lists, a ``.npy`` path, a glob or
a directory of shards, a list of shard paths, or any ``ChunkSource``
(``repro_torch.api.adapters``); ``engines.select_engine`` picks the engine.
The model runs on ``device`` ("cuda" unless the caller asks for another);
without a CUDA device the default raises instead of carrying on on the CPU.
``predict``/``score``/``transform`` walk the data in ``chunk_size`` chunks
through the chunk-shaped seams, one kernel launch a chunk: a tensor already
on the model's device is sliced where it lies, anything else streams through
``padded_device_chunks``, so they take out-of-core inputs too.
``partial_fit`` feeds one mini-batch to a
:class:`~repro_torch.service.BWKMSession` on the model's device, after
which ``predict``/``score``/``transform`` serve the session's centroids.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.api import adapters, engines
from repro_torch.api.inits import resolve_init
from repro_torch.api.result import FitResult
from repro_torch.core.bwkm import BWKMConfig
from repro_torch.data.chunks import padded_device_chunks
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.service.session import BWKMSession, ServiceConfig

__all__ = ["BWKM", "DEFAULT_CHUNK_SIZE"]

#: rows per chunk for the streaming engine and predict/score/transform
DEFAULT_CHUNK_SIZE = 65_536

_CONFIG_FIELDS = {f.name for f in dataclasses.fields(BWKMConfig)}


class BWKM:
    """Boundary Weighted K-means estimator (paper Algorithm 5).

    ``k`` clusters; ``device`` where the model and its data live; ``engine``
    ``"auto"``, ``"incore"`` or ``"streaming"``; ``init`` a name of
    ``repro_torch.api.inits``; ``chunk_size`` rows per chunk of the
    streaming engine and of predict/score/transform; ``seed`` the default
    key (``fit(..., key=...)`` overrides it); ``trace`` records
    per-iteration snapshots; ``incore_limit_bytes`` the size beyond which
    ``engine="auto"`` streams data held in memory; ``config`` a prebuilt
    :class:`BWKMConfig`, or its fields as keyword overrides (such as
    ``init_sample_size``, the streaming engine's first-pass sample);
    ``service`` a :class:`ServiceConfig` for ``partial_fit`` (it carries its
    own base config, so it excludes ``config``).
    """

    def __init__(
        self,
        k: int | None = None,
        *,
        device: str | torch.device = "cuda",
        engine: str = "auto",
        init: str | None = None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        seed: int = 0,
        trace: bool = False,
        incore_limit_bytes: int = engines.INCORE_LIMIT_BYTES,
        config: BWKMConfig | None = None,
        service: ServiceConfig | None = None,
        **config_overrides: Any,
    ):
        self.device = resolve_device(device)
        if engine != "auto":
            engines.get_engine(engine)  # fail fast on typos and unported engines
        if service is not None:
            if config is not None:
                raise ValueError(
                    "pass either service= (which carries its own base config) or config=, not both"
                )
            if k is not None and k != service.base.k:
                raise ValueError(f"k={k} conflicts with service.base.k={service.base.k}")
            config = service.base
        if config is not None:
            if k is not None and k != config.k:
                raise ValueError(f"k={k} conflicts with config.k={config.k}")
            if config_overrides:
                raise ValueError(
                    "pass either a prebuilt config or config overrides, not both: "
                    f"{sorted(config_overrides)}"
                )
            if init is not None:
                config = dataclasses.replace(config, init=init)
        else:
            if k is None:
                raise ValueError("BWKM requires k (or a prebuilt config)")
            unknown = set(config_overrides) - _CONFIG_FIELDS
            if unknown:
                raise TypeError(
                    f"unknown BWKMConfig fields {sorted(unknown)}; valid: {sorted(_CONFIG_FIELDS)}"
                )
            config = BWKMConfig(k=k, init="kmeans++" if init is None else init, **config_overrides)
        resolve_init(config.init)  # fail fast
        self.config = config
        self.engine = engine
        self.chunk_size = int(chunk_size)
        self.seed = int(seed)
        self.trace = bool(trace)
        self.incore_limit_bytes = int(incore_limit_bytes)
        self.service = service
        self.result_: FitResult | None = None
        self.centroids_: torch.Tensor | None = None
        self.engine_: str | None = None
        self.n_iter_: int | None = None
        self.session_: BWKMSession | None = None

    @classmethod
    def from_centroids(cls, centroids, *, device: str | torch.device = "cuda", **kwargs) -> "BWKM":
        """A fitted model from ``centroids [K, d]`` (e.g. a ``repro.BWKM``'s
        ``centroids_`` as numpy), ready to ``predict``/``score``/``transform``."""
        c = torch.from_numpy(np.require(centroids, np.float32, ["C", "W"]))
        model = cls(k=c.shape[0], device=device, **kwargs)
        model.centroids_ = c.to(model.device)
        return model

    @property
    def k(self) -> int:
        return self.config.k

    @property
    def init(self) -> str:
        return self.config.init

    # ------------------------------------------------------------------ fit
    def fit(self, data: Any, *, key=None) -> "BWKM":
        """Cluster ``data [n, d]`` with the selected (or auto-selected) engine."""
        if key is None:
            key = rnd.key(self.seed)
        name = engines.select_engine(data, self.engine, incore_limit_bytes=self.incore_limit_bytes)
        res = engines.get_engine(name).fit(
            key, data, self.config,
            chunk_size=self.chunk_size, trace_centroids=self.trace, device=self.device,
        )
        self.result_ = res
        self.centroids_ = res.centroids
        self.engine_ = name
        self.n_iter_ = res.iterations
        return self

    def fit_predict(self, data: Any, *, key=None) -> torch.Tensor:
        """``fit(data)``, then the labels of ``predict(data)``."""
        return self.fit(data, key=key).predict(data)

    # --------------------------------------------------------- online updates
    def partial_fit(self, batch: Any) -> "BWKM":
        """Consume one mini-batch of an unbounded stream.

        The first call opens a :class:`~repro_torch.service.BWKMSession`
        on the model's device (``session_``), configured from ``service=``
        or, without one, from a default :class:`ServiceConfig` around this
        estimator's ``config`` and ``seed``. After every call
        ``centroids_`` are the session's, so ``predict``/``score``/
        ``transform`` serve the current model; the batch's metrics are in
        ``session_.last_metrics``.
        """
        if self.session_ is None:
            service = self.service or ServiceConfig(base=self.config, seed=self.seed)
            self.session_ = BWKMSession(service, device=self.device)
        self.session_.partial_fit(batch)
        self.centroids_ = self.session_.centroids
        self.engine_ = "service"
        self.n_iter_ = int(self.session_.state.batches)
        return self

    # ------------------------------------------------- chunked inference ops
    def _chunks(self, data: Any):
        """``(x, n_valid)`` per chunk on the model's device, every chunk the
        same number of rows, zero padding past ``n_valid``."""
        if self.centroids_ is None:
            raise RuntimeError("this BWKM instance is not fitted yet; call fit()")
        if isinstance(data, torch.Tensor) and data.device == self.device:
            x, cs = data.float(), self.chunk_size
            for i in range(0, x.shape[0], cs):
                nv = min(cs, x.shape[0] - i)
                yield (x[i : i + cs] if nv == cs else F.pad(x[i:], (0, 0, 0, cs - nv))), nv
            return
        yield from padded_device_chunks(adapters.to_chunk_source(data, self.chunk_size), self.device)

    def predict(self, data: Any) -> torch.Tensor:
        """Closest-centroid labels ``int32 [n]``, one kernel launch per chunk."""
        c = self.centroids_
        out = [torch.zeros(0, dtype=torch.int32, device=self.device)]
        for x, nv in self._chunks(data):
            out.append(ops.assign_top2_chunk(x, c, chunk_size=x.shape[0])[0][:nv])
        return torch.cat(out)

    def score(self, data: Any) -> float:
        """Full-dataset K-means error ``E^D(C)`` (paper Eq. 1), accumulated on
        the device across chunks; one host sync at the end."""
        c = self.centroids_
        err = torch.zeros((), dtype=torch.float64, device=self.device)
        for x, nv in self._chunks(data):
            _, d1, _ = ops.assign_top2_chunk(x, c, chunk_size=x.shape[0])
            err = err + d1[:nv].sum(dtype=torch.float64)
        return float(err)

    def transform(self, data: Any) -> torch.Tensor:
        """Squared distances to every centroid, ``f32 [n, K]``, chunked."""
        c = self.centroids_
        out = [torch.zeros(0, c.shape[0], device=self.device)]
        for x, nv in self._chunks(data):
            out.append(ops.pairwise_sqdist_chunk(x, c, chunk_size=x.shape[0])[:nv])
        return torch.cat(out)

    def __repr__(self) -> str:
        fitted = f", engine_={self.engine_!r}" if self.engine_ else ""
        return f"BWKM(k={self.k}, device={str(self.device)!r}, init={self.config.init!r}{fitted})"
