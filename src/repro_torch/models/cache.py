"""Decode-time caches: ring-buffered KV (bounded by the SWA window where the
arch has one), constant-size SSM/conv states for Mamba/hybrid, per-invocation
KV for Zamba2's shared block, cached cross-attention KV for the VLM.
Counterpart of ``repro.models.cache``; :func:`cache_specs` is the dry
run's stand-in, the same tree on the meta device.

On a mesh whose ``"model"`` dimension has M > 1 ranks a KV cache (every
family's but ssm's) holds this rank's ``Sc/M`` slots where M divides
``Sc`` (``distributed.params``' layout puts the slots over ``"model"``;
``transformer.decode`` combines the ranks' partial softmaxes), and all
``Sc`` of them on every rank where it does not (the reference's
``logical_to_spec`` drops the axis there; decode then attends over the
whole cache on each rank). A Mamba layer's ``ssm`` state holds the rank's
H/M heads where M divides H, its ``conv`` state stays whole, and a vlm's
image K/V stay whole. :func:`init_cache` then gives the rank's shapes;
:func:`cache_specs` the whole tree's, which
``distributed.params.cache_shardings`` lays out.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import tp
from repro_torch.models import mamba2

__all__ = ["init_cache", "cache_seq_len", "cache_slots", "cache_specs", "held_slots"]


def cache_seq_len(cfg: ArchConfig, seq_len: int) -> int:
    """SWA archs never need more than ``window`` cache slots (ring buffer)."""
    return min(seq_len, cfg.window) if cfg.window else seq_len


def _kv(l, b, s, kv, hd, dtype, device):
    return {
        "k": torch.zeros((l, b, s, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((l, b, s, kv, hd), dtype=dtype, device=device),
    }


def _mamba_state(cfg, l, b, device, local):
    dims = mamba2.mamba_dims(cfg)
    h = dims["nheads"]
    if local and tp.splits(cfg).ssm:
        h //= tp.model_size()
    return {
        "conv": torch.zeros((l, b, cfg.ssm_conv - 1, dims["conv_dim"]), dtype=cfg.dtype,
                            device=device),
        "ssm": torch.zeros((l, b, h, cfg.ssm_headdim, dims["n"]),
                           dtype=torch.float32, device=device),
    }


def held_slots(sc: int) -> int:
    """The slots of a cache of ``sc`` this model rank holds: ``sc/M`` where
    the M ranks of the model axis divide them, else all of them."""
    return sc // tp.model_size() if tp.divides(sc) else sc


def cache_slots(cfg: ArchConfig, held: int, seq_len: int | None = None) -> int:
    """The slots ``Sc`` of a KV cache over all model ranks, of which this
    rank holds ``held``; ``seq_len`` the session's length that sized it
    (:func:`init_cache`'s). Without ``seq_len`` the rank's count tells the
    layout only where M divides it (the rank's ``Sc/M``: a whole cache's
    ``Sc`` is one M does not divide); elsewhere it is a whole cache or
    1/M of one M times larger, and this raises rather than guess."""
    m = tp.model_size()
    if seq_len is not None:
        sc = cache_seq_len(cfg, seq_len)
        if held != held_slots(sc):
            raise ValueError(f"{cfg.name}: a cache of {held} slots a rank is not the rank's part "
                             f"of {sc} slots over {m} model ranks")
        return sc
    if held % m:
        raise ValueError(f"{cfg.name}: a cache of {held} slots a rank on {m} model ranks is "
                         f"whole or 1/{m} of {held * m}: give decode the session's max_seq_len")
    return held * m


def init_cache(
    cfg: ArchConfig, batch: int, seq_len: int, *, device: str | torch.device = "cuda",
    local: bool = True,
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

    On the model axis (``local``, the module docstring) ``Sc`` is the
    rank's (:func:`held_slots`) and ``ssm``'s H the rank's heads; ``batch``
    is the caller's rows throughout.
    """
    device = resolve_device(device)
    b = batch
    sc = cache_seq_len(cfg, seq_len)
    if local:
        sc = held_slots(sc)
    kv, hd = cfg.n_kv_heads, cfg.hd
    if cfg.family == "ssm":
        return _mamba_state(cfg, cfg.n_layers, b, device, local)
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        per = cfg.shared_attn_every
        tail = cfg.n_layers - g * per
        cache: dict[str, Any] = {
            "mamba": _mamba_state(cfg, g * per, b, device, local),
            "shared": _kv(g, b, sc, kv, hd, cfg.dtype, device),
            "slot_pos": torch.full((b, sc), -1, dtype=torch.int32, device=device),
        }
        if tail:
            cache["mamba_tail"] = _mamba_state(cfg, tail, b, device, local)
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
    """:func:`init_cache`'s whole tree on the meta device: its shapes and
    dtypes, no storage (the reference's ``jax.eval_shape`` stand-ins)."""
    return init_cache(cfg, batch, seq_len, device="meta", local=False)
