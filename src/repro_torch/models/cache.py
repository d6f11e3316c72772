"""Decode-time caches: ring-buffered KV (bounded by the SWA window where the
arch has one), constant-size SSM/conv states for Mamba/hybrid, per-invocation
KV for Zamba2's shared block, cached cross-attention KV for the VLM.
Counterpart of ``repro.models.cache``; :func:`cache_specs` is the dry
run's stand-in, the same tree on the meta device.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba2

__all__ = ["init_cache", "cache_seq_len", "cache_specs"]


def cache_seq_len(cfg: ArchConfig, seq_len: int) -> int:
    """SWA archs never need more than ``window`` cache slots (ring buffer)."""
    return min(seq_len, cfg.window) if cfg.window else seq_len


def _kv(l, b, s, kv, hd, dtype, device):
    return {
        "k": torch.zeros((l, b, s, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((l, b, s, kv, hd), dtype=dtype, device=device),
    }


def _mamba_state(cfg, l, b, device):
    dims = mamba2.mamba_dims(cfg)
    return {
        "conv": torch.zeros((l, b, cfg.ssm_conv - 1, dims["conv_dim"]), dtype=cfg.dtype,
                            device=device),
        "ssm": torch.zeros((l, b, dims["nheads"], cfg.ssm_headdim, dims["n"]),
                           dtype=torch.float32, device=device),
    }


def init_cache(
    cfg: ArchConfig, batch: int, seq_len: int, *, device: str | torch.device = "cuda"
) -> dict[str, Any]:
    """The reference's cache tree of zeros on ``device``, slot positions at
    -1 (empty):

    - dense, moe, audio: ``k``/``v [L, B, Sc, kv, hd]`` in ``cfg.dtype``,
      ``slot_pos [B, Sc]`` int32;
    - ssm: ``conv [L, B, W-1, conv_dim]`` in ``cfg.dtype``, ``ssm [L, B, H,
      P, N]`` f32;
    - hybrid: ``mamba`` (the groups' layers, as ssm), ``shared`` (``k``/``v
      [G, B, Sc, kv, hd]``), ``slot_pos`` and, with a tail, ``mamba_tail``;
    - vlm: the self-attention layers' ``k``/``v``, ``slot_pos``, and
      ``xk``/``xv [G, B, T_img, kv, hd]``.
    """
    device = resolve_device(device)
    b = batch
    sc = cache_seq_len(cfg, seq_len)
    kv, hd = cfg.n_kv_heads, cfg.hd
    if cfg.family == "ssm":
        return _mamba_state(cfg, cfg.n_layers, b, device)
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        per = cfg.shared_attn_every
        tail = cfg.n_layers - g * per
        cache: dict[str, Any] = {
            "mamba": _mamba_state(cfg, g * per, b, device),
            "shared": _kv(g, b, sc, kv, hd, cfg.dtype, device),
            "slot_pos": torch.full((b, sc), -1, dtype=torch.int32, device=device),
        }
        if tail:
            cache["mamba_tail"] = _mamba_state(cfg, tail, b, device)
        return cache
    n_self = cfg.n_layers
    if cfg.family == "vlm":
        # self-attention layers only; the cross layers cache image KV apart
        n_self = (cfg.n_layers // cfg.cross_attn_every) * (cfg.cross_attn_every - 1)
    cache = _kv(n_self, b, sc, kv, hd, cfg.dtype, device)
    cache["slot_pos"] = torch.full((b, sc), -1, dtype=torch.int32, device=device)
    if cfg.family == "vlm":
        gc = cfg.n_layers // cfg.cross_attn_every
        shape = (gc, b, cfg.n_image_tokens, kv, hd)
        cache["xk"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        cache["xv"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return cache


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> dict[str, Any]:
    """:func:`init_cache`'s tree on the meta device: its shapes and dtypes,
    no storage (the reference's ``jax.eval_shape`` stand-ins)."""
    return init_cache(cfg, batch, seq_len, device="meta")
