"""KV-cache dumps as :class:`~repro_torch.data.chunks.ChunkSource`s.
Counterpart of ``repro.vq.source``.

:class:`CacheDumpSource` harvests one layer's K (or V) vectors from
``transformer.prefill`` and presents them as the deterministic, repeatable
``float32 [<=chunk_size, hd]`` chunk stream the out-of-core shard sources
speak, so KV codebooks are fitted through ``repro_torch.BWKM``'s streaming
engine instead of from an in-core dump array.

Prompts are prefilled in fixed-size batches on the parameters' device
under ``torch.inference_mode()``, and each batch's ``[B, Sc, kv, hd]``
layer cache comes back to the host as float32 rows, re-chunked to the
fixed ``chunk_size`` across prefill-batch boundaries. The host rows are
memoised per prefill batch by default, so the streaming driver's passes pay
the forward once per source (and each source runs its own prefills, as the
reference's do).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import cache as cache_mod
from repro_torch.models import transformer

__all__ = ["CacheDumpSource", "n_kv_layers", "kv_dump_sources"]

_KINDS = ("k", "v")


def n_kv_layers(cfg: ArchConfig) -> int:
    """Number of layers with a self-attention KV cache stack."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"family {cfg.family!r} has no per-layer KV cache stack to dump "
            "(recurrent state is not vector-quantizable this way)"
        )
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        return g * (cfg.cross_attn_every - 1)
    return cfg.n_layers


def params_device(params: dict) -> torch.device:
    """The device the parameter tree lives on."""
    return params["embed"].device


class CacheDumpSource:
    """ChunkSource over one layer's prefill K or V vectors.

    ``prompts`` is a host ``[n_prompts, prompt_len]`` int array. Each chunk
    is ``float32 [<=chunk_size, hd]``; ``n_points = n_prompts · Sc · kv``
    where ``Sc`` is the cache sequence length (the SWA ring bounds it: the
    dump holds exactly the vectors a decode step would read).
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params: dict,
        prompts,
        *,
        layer: int,
        kind: str = "k",
        chunk_size: int = 4096,
        prompt_batch: int = 8,
        cache_host: bool = True,
    ):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        if cfg.family == "vlm":
            raise NotImplementedError(
                "CacheDumpSource prefills from tokens alone; vlm prefill "
                "needs image embeddings (harvest its cache externally and "
                "quantize with repro_torch.vq.quantize_cache instead)"
            )
        n_layers = n_kv_layers(cfg)
        if not 0 <= layer < n_layers:
            raise ValueError(f"layer {layer} out of range [0, {n_layers})")
        if isinstance(prompts, torch.Tensor):
            prompts = prompts.cpu().numpy()
        prompts = np.asarray(prompts)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be [n, prompt_len], got {prompts.shape}")
        self.cfg = cfg
        self.params = params
        self.layer = int(layer)
        self.kind = kind
        self._prompts = prompts
        self._chunk_size = int(chunk_size)
        if self._chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self._pb = max(1, min(int(prompt_batch), prompts.shape[0]))
        self._sc = cache_mod.cache_seq_len(cfg, prompts.shape[1])
        self._rows_per_prompt = self._sc * cfg.n_kv_heads
        self._cache_host = bool(cache_host)
        self._memo: dict[int, np.ndarray] = {}

    # ------------------------------------------------------- protocol props
    @property
    def n_points(self) -> int:
        return self._prompts.shape[0] * self._rows_per_prompt

    @property
    def dim(self) -> int:
        return self.cfg.hd

    @property
    def chunk_size(self) -> int:
        return self._chunk_size

    @property
    def n_chunks(self) -> int:
        return max(1, -(-self.n_points // self._chunk_size))

    @property
    def n_prompt_batches(self) -> int:
        return -(-self._prompts.shape[0] // self._pb)

    # ---------------------------------------------------------- harvesting
    def _batch_rows(self, bi: int) -> np.ndarray:
        """Rows ``[b·Sc·kv, hd]`` harvested from prefill batch ``bi``."""
        if bi in self._memo:
            return self._memo[bi]
        toks = self._prompts[bi * self._pb : (bi + 1) * self._pb]
        dev = params_device(self.params)
        with torch.inference_mode():
            _, cache = transformer.prefill(
                self.cfg, self.params, torch.tensor(toks, dtype=torch.int32, device=dev)
            )
            stack = cache[self.kind][self.layer]  # [b, Sc, kv, hd]
            rows = stack.float().cpu().numpy().reshape(-1, self.dim)
        if self._cache_host:
            self._memo[bi] = rows
        return rows

    def chunks(self) -> Iterator[np.ndarray]:
        cs = self._chunk_size
        pending: list[np.ndarray] = []
        pending_rows = 0
        for bi in range(self.n_prompt_batches):
            rows = self._batch_rows(bi)
            start = 0
            while start < rows.shape[0]:
                take = min(cs - pending_rows, rows.shape[0] - start)
                pending.append(rows[start : start + take])
                pending_rows += take
                start += take
                if pending_rows == cs:
                    yield pending[0] if len(pending) == 1 else np.concatenate(pending)
                    pending, pending_rows = [], 0
        if pending_rows:
            yield pending[0] if len(pending) == 1 else np.concatenate(pending)

    def chunk_at(self, index: int) -> np.ndarray:
        """Random access (streaming k-means|| candidate gather, cursor
        resume) without replaying earlier prefill batches."""
        index = int(index)
        if not 0 <= index < self.n_chunks:
            raise IndexError(f"chunk index {index} out of range [0, {self.n_chunks})")
        start = index * self._chunk_size
        stop = min(start + self._chunk_size, self.n_points)
        rows_per_batch = self._pb * self._rows_per_prompt
        parts: list[np.ndarray] = []
        for bi in range(start // rows_per_batch, self.n_prompt_batches):
            lo = bi * rows_per_batch
            if lo >= stop:
                break
            rows = self._batch_rows(bi)
            parts.append(rows[max(start - lo, 0) : stop - lo])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def kv_dump_sources(
    cfg: ArchConfig,
    params: dict,
    prompts,
    *,
    kinds: tuple[str, ...] = _KINDS,
    chunk_size: int = 4096,
    prompt_batch: int = 8,
    layers=None,
) -> dict[tuple[str, int], CacheDumpSource]:
    """One source per ``(kind, layer)``, over ``layers`` (default: every KV
    layer): the fitting plan of a :func:`repro_torch.vq.fit_kv_codebook`
    run. Sources share nothing; each keeps its own per-batch memo."""
    return {
        (kind, layer): CacheDumpSource(
            cfg, params, prompts, layer=layer, kind=kind,
            chunk_size=chunk_size, prompt_batch=prompt_batch,
        )
        for kind in kinds
        for layer in (range(n_kv_layers(cfg)) if layers is None else layers)
    }
