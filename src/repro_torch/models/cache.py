"""Decode-time caches: ring-buffered KV, bounded by the SWA window where the
arch has one. Counterpart of ``repro.models.cache`` for the dense, moe and
audio families; the ssm and hybrid states come with ``models/mamba2.py``
and the vlm's image KV with the vlm slice (ROADMAP A15), and
``cache_specs`` (the dry-run's zero-allocation stand-ins) with the dry-run
(ROADMAP A16).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device

__all__ = ["init_cache", "cache_seq_len"]

#: the families whose cache the port does not hold yet, and where it comes
_LATER = {
    "ssm": "the ssm family's state needs models/mamba2.py (ROADMAP A15, mamba2)",
    "hybrid": "the hybrid family's state needs models/mamba2.py (ROADMAP A15, mamba2)",
    "vlm": "the vlm family's cross-attention comes with the vlm slice (ROADMAP A15, vlm)",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run yet."""
    if cfg.family in _LATER:
        raise NotImplementedError(f"{cfg.name}: {_LATER[cfg.family]}")


def cache_seq_len(cfg: ArchConfig, seq_len: int) -> int:
    """SWA archs never need more than ``window`` cache slots (ring buffer)."""
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_cache(
    cfg: ArchConfig, batch: int, seq_len: int, *, device: str | torch.device = "cuda"
) -> dict[str, Any]:
    """``k``/``v`` ``[L, B, Sc, kv, hd]`` zeros in ``cfg.dtype`` and
    ``slot_pos [B, Sc]`` int32 at -1 (empty), on ``device``."""
    check_family(cfg)
    device = resolve_device(device)
    sc = cache_seq_len(cfg, seq_len)
    shape = (cfg.n_layers, batch, sc, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "slot_pos": torch.full((batch, sc), -1, dtype=torch.int32, device=device),
    }
