"""Per-layer KV codebooks: fit through the facade, look up through the
assignment kernel. Counterpart of ``repro.vq.codebook``.

A :class:`KVCodebook` is the serving artifact of a vector-quantized KV
cache: ``[L, K, hd]`` float32 centroid stacks for K and V (host arrays)
plus a fit audit trail. Quantization is cluster assignment:
``kernels.ops.assign_top2_chunk`` (B1 on CUDA, the kernel every Lloyd
pass's first half runs) maps f32 rows to code indices; dequantization is a
centroid gather. Codes are ``torch.uint8`` for ``k <= 256`` and
``torch.uint16`` up to 65,536, stored in that dtype and widened to int64
only where they index.

Persistence reuses ``train.checkpoint`` (npz + JSON manifest, atomic
rename) with the reference's schema-versioned manifest, so a codebook saved
by either package loads in the other bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import numpy as np
import torch

from repro_torch.data import chunks as ck
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.train import checkpoint as train_ckpt
from repro_torch.vq.source import kv_dump_sources, n_kv_layers, params_device

__all__ = [
    "KVCodebook",
    "code_dtype_for",
    "fit_kv_codebook",
    "random_kv_codebook",
    "quantize_rows",
    "dequantize_rows",
    "quantize_cache",
    "dequantize_cache",
    "kv_cache_nbytes",
    "save_codebook",
    "load_codebook",
]

_SCHEMA = 1


def code_dtype_for(k: int) -> torch.dtype:
    """Narrowest unsigned dtype that can index a ``k``-entry codebook."""
    if k < 1:
        raise ValueError(f"codebook size must be >= 1, got {k}")
    if k <= 256:
        return torch.uint8
    if k <= 65536:
        return torch.uint16
    raise ValueError(f"codebook size {k} exceeds uint16 code range (65536)")


@dataclasses.dataclass
class KVCodebook:
    """Per-layer K/V centroid stacks ``[L, K, hd]`` (float32 host arrays)
    and fit metadata."""

    k_centroids: np.ndarray
    v_centroids: np.ndarray
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.k_centroids = _host_f32(self.k_centroids)
        self.v_centroids = _host_f32(self.v_centroids)
        for name, c in (("k", self.k_centroids), ("v", self.v_centroids)):
            if c.ndim != 3:
                raise ValueError(f"{name}_centroids must be [L, K, hd], got {c.shape}")
        if self.k_centroids.shape != self.v_centroids.shape:
            raise ValueError(
                f"K/V centroid stacks disagree: {self.k_centroids.shape} "
                f"vs {self.v_centroids.shape}"
            )
        code_dtype_for(self.k)  # fail fast on unindexable sizes

    @property
    def n_layers(self) -> int:
        return self.k_centroids.shape[0]

    @property
    def k(self) -> int:
        return self.k_centroids.shape[1]

    @property
    def dim(self) -> int:
        return self.k_centroids.shape[2]

    @property
    def code_dtype(self) -> torch.dtype:
        return code_dtype_for(self.k)

    def centroids(self, kind: str) -> np.ndarray:
        if kind == "k":
            return self.k_centroids
        if kind == "v":
            return self.v_centroids
        raise ValueError(f"kind must be 'k' or 'v', got {kind!r}")

    @property
    def nbytes(self) -> int:
        return self.k_centroids.nbytes + self.v_centroids.nbytes


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _f32_on(a, device) -> torch.Tensor:
    """``a`` (a tensor or an array) as an f32 tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(_host_f32(a))
    return t.to(device, torch.float32)


def _stacks(n_layers: int, k: int, hd: int) -> dict[str, np.ndarray]:
    return {kind: np.zeros((n_layers, k, hd), np.float32) for kind in ("k", "v")}


def _source_seed(seed: int, kind: str, layer: int) -> int:
    return seed + 1000 * layer + (0 if kind == "k" else 1)


# -------------------------------------------------------------------- fitting
def fit_kv_codebook(
    cfg,
    params: dict,
    prompts,
    *,
    k: int,
    chunk_size: int = 2048,
    prompt_batch: int = 8,
    seed: int = 0,
    init: str = "kmeans||",
    max_iters: int = 8,
    engine: str = "streaming",
    layers=None,
    **config_overrides: Any,
) -> KVCodebook:
    """Fit one BWKM codebook per (layer, K/V) over prefill cache dumps.

    Every fit goes through ``repro_torch.BWKM`` on the parameters' device,
    the streaming engine consuming a :class:`CacheDumpSource`: the dump is
    never one array. ``meta["layers"]`` records the audit per fit (engine,
    distance ops, iterations, stop reason, rows). ``layers`` fits those KV
    layers only (default: every one); the others' centroids stay zero."""
    from repro_torch.api.estimator import BWKM

    code_dtype_for(k)
    # a partition sized to a KV dump, not to "massive data": a codebook
    # needs representatives a few times k (the reference's defaults)
    config_overrides.setdefault("m", max(4 * k, 64))
    config_overrides.setdefault("capacity", 8 * config_overrides["m"])
    config_overrides.setdefault("lloyd_max_iters", 20)
    sources = kv_dump_sources(cfg, params, prompts, chunk_size=chunk_size,
                              prompt_batch=prompt_batch, layers=layers)
    stacks = _stacks(n_kv_layers(cfg), k, cfg.hd)
    audit: list[dict[str, Any]] = []
    for (kind, layer), src in sorted(sources.items()):
        model = BWKM(
            k=k, device=params_device(params), engine=engine, init=init,
            chunk_size=chunk_size, seed=_source_seed(seed, kind, layer),
            max_iters=max_iters, **config_overrides,
        )
        model.fit(src)
        stacks[kind][layer] = model.centroids_.float().cpu().numpy()
        audit.append({
            "kind": kind,
            "layer": layer,
            "engine": model.engine_,
            "distances": float(model.result_.distances),
            "iterations": int(model.result_.iterations),
            "stop_reason": model.result_.stop_reason,
            "n_points": int(src.n_points),
        })
    meta = {
        "k": k,
        "init": init,
        "engine": engine,
        "chunk_size": chunk_size,
        "layers": audit,
        "distances_total": float(sum(a["distances"] for a in audit)),
    }
    return KVCodebook(stacks["k"], stacks["v"], meta)


def random_kv_codebook(
    cfg, params: dict, prompts, *, k: int, seed: int = 0,
    chunk_size: int = 2048, prompt_batch: int = 8,
) -> KVCodebook:
    """Equal-k baseline: per-layer codebooks of uniformly sampled dump rows
    (one reservoir pass per source, no clustering; the reference's draws)."""
    sources = kv_dump_sources(cfg, params, prompts, chunk_size=chunk_size,
                              prompt_batch=prompt_batch)
    stacks = _stacks(n_kv_layers(cfg), k, cfg.hd)
    for (kind, layer), src in sorted(sources.items()):
        if src.n_points < k:
            raise ValueError(f"dump has {src.n_points} rows < k={k}")
        stacks[kind][layer] = ck.reservoir_sample(src, k, _source_seed(seed, kind, layer))
    return KVCodebook(stacks["k"], stacks["v"], {"k": k, "engine": "random"})


# ------------------------------------------------------- quantize/dequantize
def quantize_rows(
    x, centroids, *, chunk_size: int = 4096, device: str | torch.device | None = None
) -> torch.Tensor:
    """Rows ``[n, hd]`` → code indices ``[n]`` in the codebook's code dtype,
    through ``ops.assign_top2_chunk`` on f32 rows, ``chunk_size`` rows a
    launch. A tensor is quantized where it lies; anything else on
    ``device`` (CUDA unless given)."""
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device or "cuda")
    x, c = _f32_on(x, dev), _f32_on(centroids, dev)
    dt = code_dtype_for(c.shape[0])
    out = [torch.zeros(0, dtype=dt, device=dev)]
    for start in range(0, x.shape[0], chunk_size):
        assign, _, _ = ops.assign_top2_chunk(x[start : start + chunk_size], c,
                                             chunk_size=chunk_size)
        out.append(assign.to(dt))
    return torch.cat(out)


def dequantize_rows(codes: torch.Tensor, centroids) -> torch.Tensor:
    """Code indices → reconstructed f32 rows (centroid gather)."""
    return _f32_on(centroids, codes.device)[codes.long()]


def quantize_cache(codebook: KVCodebook, cache: dict) -> dict:
    """A prefill cache → code-valued cache, on the cache's device.

    ``cache["k"]/["v"]`` ``[L, B, Sc, kv, hd]`` become ``k_codes/v_codes``
    ``[L, B, Sc, kv]`` in the codebook's code dtype; every other entry
    (``slot_pos``, …) passes through. This is the storage format the
    quantized decode loop carries between steps."""
    qcache = {key: val for key, val in cache.items() if key not in ("k", "v")}
    for kind, cname in (("k", "k_codes"), ("v", "v_codes")):
        stack = cache[kind]
        if stack.shape[0] != codebook.n_layers or stack.shape[-1] != codebook.dim:
            raise ValueError(
                f"cache[{kind!r}] shape {tuple(stack.shape)} does not match codebook "
                f"[L={codebook.n_layers}, ..., hd={codebook.dim}]"
            )
        cents = torch.from_numpy(codebook.centroids(kind)).to(stack.device)
        codes = torch.empty(stack.shape[:-1], dtype=codebook.code_dtype, device=stack.device)
        for layer in range(codebook.n_layers):
            rows = stack[layer].reshape(-1, codebook.dim)
            codes[layer] = quantize_rows(rows, cents[layer]).reshape(stack.shape[1:-1])
        qcache[cname] = codes
    return qcache


def dequantize_cache(codebook: KVCodebook, qcache: dict, dtype: torch.dtype | None = None) -> dict:
    """Inverse of :func:`quantize_cache`: codes → a raw-layout cache whose
    K/V are the per-layer centroid reconstructions (f32 unless ``dtype``)."""
    cache = {k: v for k, v in qcache.items() if k not in ("k_codes", "v_codes")}
    for kind, cname in (("k", "k_codes"), ("v", "v_codes")):
        codes = qcache[cname]
        cents = torch.from_numpy(codebook.centroids(kind)).to(codes.device)
        layers = torch.arange(codebook.n_layers, device=codes.device)[:, None]
        recon = cents[layers, codes.reshape(codebook.n_layers, -1).long()]
        cache[kind] = recon.reshape(*codes.shape, codebook.dim).to(dtype or torch.float32)
    return cache


def kv_cache_nbytes(cache: dict) -> int:
    """Bytes the K/V payload occupies between decode steps: raw tensors for a
    plain cache, codes and nothing else for a quantized one (the codebook
    is amortised across requests; ``KVCodebook.nbytes`` reports it)."""
    keys = [k for k in ("k", "v", "k_codes", "v_codes") if k in cache]
    if not keys:
        raise ValueError(f"no KV payload entries in cache keys {sorted(cache)}")
    return int(sum(cache[k].numel() * cache[k].element_size() for k in keys))


# ---------------------------------------------------------------- save/load
def save_codebook(
    directory: str | pathlib.Path, codebook: KVCodebook, *, step: int = 0
) -> pathlib.Path:
    """Persist via ``train.checkpoint`` (npz + manifest, atomic rename)."""
    state = {"codebook": {"k": codebook.k_centroids, "v": codebook.v_centroids}}
    extra = {
        "schema": _SCHEMA,
        "artifact": "kv_codebook",
        "n_layers": codebook.n_layers,
        "k": codebook.k,
        "dim": codebook.dim,
        "meta": codebook.meta,
    }
    return train_ckpt.save(directory, step, state, extra)


def load_codebook(directory: str | pathlib.Path, *, step: int | None = None) -> KVCodebook:
    """Load a saved codebook (bit-identical to what was saved)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = train_ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no codebook checkpoints under {directory}")
    manifest = json.loads((directory / f"step_{step:08d}" / "manifest.json").read_text())
    extra = manifest["extra"]
    if extra.get("schema") != _SCHEMA or extra.get("artifact") != "kv_codebook":
        raise ValueError(
            f"not a schema-{_SCHEMA} kv_codebook checkpoint: "
            f"schema={extra.get('schema')!r} artifact={extra.get('artifact')!r}"
        )
    shape = (extra["n_layers"], extra["k"], extra["dim"])
    template = {"codebook": {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}}
    state, extra = train_ckpt.restore(directory, step, template, device="cpu")
    return KVCodebook(state["codebook"]["k"], state["codebook"]["v"],
                      dict(extra.get("meta", {})))
