"""``repro_torch.BWKM`` — the estimator. Counterpart of ``repro.api.estimator``.

    >>> model = BWKM(k=27).fit(x)          # x: [n, d] tensor or array; runs on CUDA
    >>> labels = model.predict(x)          # int32 tensor on the model's device
    >>> model.score(x), model.result_.stop_reason

The model runs on ``device`` ("cuda" unless the caller asks for another);
without a CUDA device the default raises instead of carrying on on the CPU.
``predict``/``score``/``transform`` walk the data in ``chunk_size`` slices
through the chunk-shaped seams, so each slice is one kernel launch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.api import engines
from repro_torch.api.inits import resolve_init
from repro_torch.api.result import FitResult
from repro_torch.core.bwkm import BWKMConfig
from repro_torch.kernels import ops

__all__ = ["BWKM", "DEFAULT_CHUNK_SIZE"]

#: rows per chunk for predict/score/transform
DEFAULT_CHUNK_SIZE = 65_536

_CONFIG_FIELDS = {f.name for f in dataclasses.fields(BWKMConfig)}


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.BWKM runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return device


class BWKM:
    """Boundary Weighted K-means estimator (paper Algorithm 5).

    ``k`` clusters; ``device`` where the model and its data live; ``engine``
    ``"auto"`` or ``"incore"``; ``init`` a name of ``repro_torch.api.inits``;
    ``chunk_size`` rows per slice of predict/score/transform; ``seed`` the
    default key (``fit(..., key=...)`` overrides it); ``trace`` records
    per-iteration snapshots; ``config`` a prebuilt :class:`BWKMConfig`, or
    its fields as keyword overrides.
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
        config: BWKMConfig | None = None,
        **config_overrides: Any,
    ):
        self.device = _resolve_device(device)
        engines.get_engine(engine)  # fail fast on typos and unported engines
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
        self.result_: FitResult | None = None
        self.centroids_: torch.Tensor | None = None
        self.engine_: str | None = None
        self.n_iter_: int | None = None

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

    def _as_tensor(self, data: Any) -> torch.Tensor:
        if isinstance(data, torch.Tensor):
            return data.to(device=self.device, dtype=torch.float32)
        if isinstance(data, (str, list, tuple)) or not hasattr(data, "__array__"):
            raise NotImplementedError(
                "repro_torch takes resident tensors and arrays; out-of-core "
                "sources wait for ROADMAP queue A item 11 (streaming)"
            )
        # torch shares the array's memory, so a read-only array is copied
        return torch.from_numpy(np.require(data, np.float32, ["C", "W"])).to(self.device)

    # ------------------------------------------------------------------ fit
    def fit(self, data: Any, *, key=None) -> "BWKM":
        """Cluster ``data [n, d]`` (moved to the model's device as f32)."""
        if key is None:
            key = rnd.key(self.seed)
        x = self._as_tensor(data)
        res = engines.get_engine(self.engine).fit(key, x, self.config, trace_centroids=self.trace)
        self.result_ = res
        self.centroids_ = res.centroids
        self.engine_ = res.engine
        self.n_iter_ = res.iterations
        return self

    def fit_predict(self, data: Any, *, key=None) -> torch.Tensor:
        """``fit(data)``, then the labels of ``predict(data)``."""
        return self.fit(data, key=key).predict(data)

    # ------------------------------------------------- chunked inference ops
    def _chunks(self, data: Any):
        if self.centroids_ is None:
            raise RuntimeError("this BWKM instance is not fitted yet; call fit()")
        x = self._as_tensor(data)
        for i in range(0, x.shape[0], self.chunk_size):
            yield x[i : i + self.chunk_size]

    def predict(self, data: Any) -> torch.Tensor:
        """Closest-centroid labels ``int32 [n]``, one kernel launch per chunk."""
        c = self.centroids_
        out = [torch.zeros(0, dtype=torch.int32, device=self.device)]
        for x in self._chunks(data):
            out.append(ops.assign_top2_chunk(x, c, chunk_size=self.chunk_size)[0])
        return torch.cat(out)

    def score(self, data: Any) -> float:
        """Full-dataset K-means error ``E^D(C)`` (paper Eq. 1), accumulated on
        the device across chunks; one host sync at the end."""
        c = self.centroids_
        err = torch.zeros((), dtype=torch.float64, device=self.device)
        for x in self._chunks(data):
            _, d1, _ = ops.assign_top2_chunk(x, c, chunk_size=self.chunk_size)
            err = err + d1.sum(dtype=torch.float64)
        return float(err)

    def transform(self, data: Any) -> torch.Tensor:
        """Squared distances to every centroid, ``f32 [n, K]``, chunked."""
        c = self.centroids_
        out = [torch.zeros(0, c.shape[0], device=self.device)]
        for x in self._chunks(data):
            out.append(ops.pairwise_sqdist_chunk(x, c, chunk_size=self.chunk_size))
        return torch.cat(out)

    def __repr__(self) -> str:
        fitted = f", engine_={self.engine_!r}" if self.engine_ else ""
        return f"BWKM(k={self.k}, device={str(self.device)!r}, init={self.config.init!r}{fitted})"
