"""One decoder substrate for the dense, moe and audio families.
Counterpart of ``repro.models.transformer``, for inference.

  dense / audio — pre-norm GQA attention + SwiGLU (RoPE, optional
                  qk-norm/SWA)
  moe           — attention + MoE FFN (``moe.py``, single-device path)

The ssm and hybrid families (``models/mamba2.py``) and the vlm family come
with their slices (ROADMAP A15) and raise ``NotImplementedError`` here.

Parameters are the reference's tree: per-layer leaves stacked on a leading
``[L, ...]`` axis, in ``cfg.param_dtype``, cast to ``cfg.dtype`` at use
(``cast_params_before_use``). Layers run as a Python loop over the stack;
``scan_layers`` and ``remat`` have no effect.

Caches are functional for callers: :func:`prefill`, :func:`decode` and
:func:`dense_block_decode` return new caches and leave the ones they were
given as they were, as the reference's do. The generation loops
(``launch.serve.generate`` and ``repro_torch.vq``'s), which the reference
runs with the cache donated, step with :func:`_decode` writing the ring slot
in place, so a step copies no cache.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import random as rnd
from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.models import cache as cache_mod
from repro_torch.models import moe
from repro_torch.models.layers import (
    attention,
    decode_attention,
    matmul,
    rmsnorm,
    rope,
    rope_tables,
    swiglu,
)

__all__ = ["init_params", "forward", "prefill", "decode", "dense_block_decode"]


def _pos_ctx(cfg: ArchConfig, s: int, device):
    """(positions, shared rope tables) computed once per step."""
    pos = torch.arange(s, device=device)
    return pos, rope_tables(pos, cfg.hd, cfg.rope_theta)


# ------------------------------------------------------------------ init
def _init_block(cfg: ArchConfig, key: rnd.Key, device) -> dict:
    """One decoder layer for this config's family."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ka, kf = rnd.split(key, 2)
    std = 0.02
    pdt = cfg.param_dtype

    def normal(k, shape):
        return rnd.normal(k, shape, device=device, std=std).to(pdt)

    def ones(n):
        return torch.ones(n, dtype=pdt, device=device)

    ks = rnd.split(ka, 4)
    attn = {
        "wq": normal(ks[0], (d, h * hd)),
        "wk": normal(ks[1], (d, kv * hd)),
        "wv": normal(ks[2], (d, kv * hd)),
        "wo": normal(ks[3], (h * hd, d)),
    }
    if cfg.qk_norm:
        attn["q_norm"] = ones(hd)
        attn["k_norm"] = ones(hd)
    block: dict[str, Any] = {"ln1": ones(d), "attn": attn, "ln2": ones(d)}
    if cfg.family == "moe":
        block["moe"] = moe.init_moe_params(cfg, kf, device=device)
    else:
        km = rnd.split(kf, 3)
        block["mlp"] = {
            "w1": normal(km[0], (d, cfg.d_ff)),
            "w3": normal(km[1], (d, cfg.d_ff)),
            "w2": normal(km[2], (cfg.d_ff, d)),
        }
    return block


def _stacked_like(tree: dict, n: int) -> dict:
    return {k: _stacked_like(v, n) if isinstance(v, dict)
            else torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def _fill(stack: dict, tree: dict, i: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill(stack[k], v, i)
        else:
            stack[k][i] = v


def layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views) of a stacked ``[L, ...]`` tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def init_params(cfg: ArchConfig, key: rnd.Key, *, device: str | torch.device = "cuda") -> dict[str, Any]:
    """The reference's parameter tree with N(0, 0.02²) weights and unit
    norms, drawn on ``device`` one layer at a time into the stacks."""
    cache_mod.check_family(cfg)
    device = resolve_device(device)
    ke, kh, kl, _ = rnd.split(key, 4)
    std = 0.02
    pdt = cfg.param_dtype
    vp = cfg.vocab_padded
    params: dict[str, Any] = {
        "embed": rnd.normal(ke, (vp, cfg.d_model), device=device, std=std).to(pdt),
        "out_head": rnd.normal(kh, (cfg.d_model, vp), device=device, std=std).to(pdt),
        "final_norm": torch.ones(cfg.d_model, dtype=pdt, device=device),
    }
    layer_keys = rnd.split(kl, cfg.n_layers)
    stack = None
    for i, lk in enumerate(layer_keys):
        block = _init_block(cfg, lk, device)
        if stack is None:
            stack = _stacked_like(block, cfg.n_layers)
        _fill(stack, block, i)
        del block
    params["layers"] = stack
    return params


# ------------------------------------------------------------------ blocks
def _wt(cfg, w, dtype):
    return w.to(dtype) if cfg.cast_params_before_use else w


def _should_expand_gqa(cfg: ArchConfig) -> bool:
    """Never without a model axis, which the port does not have."""
    if cfg.expand_gqa != "auto":
        return bool(cfg.expand_gqa)
    return False


def _attn_full(cfg: ArchConfig, p: dict, x, pos_ctx, *, return_kv=False):
    """Full-sequence attention sub-block. x [B, S, D]."""
    positions, tables = pos_ctx
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(x, _wt(cfg, p["wq"], x.dtype)).reshape(b, s, h, hd)
    k = matmul(x, _wt(cfg, p["wk"], x.dtype)).reshape(b, s, kv, hd)
    v = matmul(x, _wt(cfg, p["wv"], x.dtype)).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta, tables)
    k = rope(k, positions, cfg.rope_theta, tables)
    kv_out = (k, v)
    if _should_expand_gqa(cfg):
        g = h // kv
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    o = attention(q, k, v, window=cfg.window, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    out = matmul(o.reshape(b, s, h * hd), _wt(cfg, p["wo"], x.dtype))
    return (out, kv_out) if return_kv else out


def _attn_decode_(cfg: ArchConfig, p: dict, x, k_cache, v_cache, slot_pos, pos: int):
    """Single-token attention sub-block, x [B, D]: writes the new token's
    K/V into ``k_cache``/``v_cache`` [B, Sc, kv, hd] at ``pos % Sc`` in
    place, then attends."""
    b, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sc = k_cache.shape[1]
    q = matmul(x, _wt(cfg, p["wq"], x.dtype)).reshape(b, 1, h, hd)
    k = matmul(x, _wt(cfg, p["wk"], x.dtype)).reshape(b, 1, kv, hd)
    v = matmul(x, _wt(cfg, p["wv"], x.dtype)).reshape(b, 1, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    posv = torch.tensor([pos], device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    slot = pos % sc
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = decode_attention(q[:, 0], k_cache, v_cache, slot_pos, pos, window=cfg.window)
    return matmul(o.reshape(b, h * hd), _wt(cfg, p["wo"], x.dtype))


def _mlp(cfg, p, x):
    return swiglu(x, _wt(cfg, p["w1"], x.dtype), _wt(cfg, p["w3"], x.dtype),
                  _wt(cfg, p["w2"], x.dtype))


def _ffn(cfg: ArchConfig, block: dict, x):
    """Post-attention FFN (dense or MoE). Returns (out, aux_loss)."""
    h = rmsnorm(x, block["ln2"])
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, block["moe"], h)
    return _mlp(cfg, block["mlp"], h), torch.zeros((), dtype=torch.float32, device=x.device)


def _decoder_block_full(cfg, block, x, pos_ctx, *, return_kv=False):
    o = _attn_full(cfg, block["attn"], rmsnorm(x, block["ln1"]), pos_ctx, return_kv=return_kv)
    o, kvs = o if return_kv else (o, None)
    x = x + o
    f, aux = _ffn(cfg, block, x)
    return shard(x + f, "batch", "seq", None), kvs, aux


def _embed(cfg, params, tokens):
    """Rows of the embedding in ``cfg.dtype`` (gathered, then cast: the
    same values as the reference's cast-then-gather)."""
    return _wt(cfg, params["embed"][tokens.long()], cfg.dtype)


def _head(cfg, params, x):
    """f32 logits ``[..., vocab_padded]``, padding columns at −1e30."""
    x = rmsnorm(x, params["final_norm"])
    logits = x.float() @ _wt(cfg, params["out_head"], x.dtype).float()
    if cfg.vocab_padded > cfg.vocab:  # mask the padding columns
        cols = torch.arange(cfg.vocab_padded, device=x.device)
        logits = logits.masked_fill(cols >= cfg.vocab, -1e30)
    return logits


# ------------------------------------------------------------------ forward
def forward(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,
    image_embeds: torch.Tensor | None = None,
    *,
    collect_cache: bool = False,
    head_last_only: bool = False,
):
    """Full-sequence forward. Returns (logits [B,S,V] f32, aux_loss,
    kv_stacks): ``kv_stacks`` is ``(k, v)``, each ``[L, B, S, kv, hd]``,
    with ``collect_cache``, else ``None``.

    ``head_last_only`` computes the unembedding for the final position only
    (prefill never needs [B, S, V] logits)."""
    cache_mod.check_family(cfg)
    b, s = tokens.shape
    pos_ctx = _pos_ctx(cfg, s, tokens.device)
    x = _embed(cfg, params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    kvs = None
    if collect_cache:
        shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd)
        kvs = (torch.empty(shape, dtype=x.dtype, device=x.device),
               torch.empty(shape, dtype=x.dtype, device=x.device))
    for i in range(cfg.n_layers):
        x, kv_l, a = _decoder_block_full(cfg, layer(params["layers"], i), x, pos_ctx,
                                         return_kv=collect_cache)
        aux_total = aux_total + a
        if collect_cache:
            kvs[0][i], kvs[1][i] = kv_l
    if head_last_only:
        x = x[:, -1:]
    return _head(cfg, params, x), aux_total, kvs


# ------------------------------------------------------------------ prefill
def prefill(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,
    image_embeds: torch.Tensor | None = None,
    *,
    max_seq_len: int | None = None,
):
    """Prefill: returns (last-token logits [B,V], cache).

    ``max_seq_len`` sizes the cache for the whole serving session (prompt +
    decode headroom); it defaults to the prompt length. The last
    ``min(s, Sc)`` prompt positions go to their ring slots."""
    cache_mod.check_family(cfg)
    b, s = tokens.shape
    max_seq_len = max_seq_len or s
    logits, _, (k_stack, v_stack) = forward(
        cfg, params, tokens, image_embeds, collect_cache=True, head_last_only=True
    )
    sc = cache_mod.cache_seq_len(cfg, max_seq_len)
    dev = tokens.device
    if sc == s:
        # the collected stacks are the cache
        slot_pos = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
        return logits[:, 0], {"k": k_stack, "v": v_stack, "slot_pos": slot_pos.contiguous()}
    cache = cache_mod.init_cache(cfg, b, max_seq_len, device=dev)
    tail = min(s, sc)
    positions = torch.arange(s - tail, s, device=dev)
    slots = positions % sc
    cache["k"][:, :, slots] = k_stack[:, :, s - tail:]
    cache["v"][:, :, slots] = v_stack[:, :, s - tail:]
    cache["slot_pos"][:, slots] = positions.to(torch.int32)[None, :]
    return logits[:, 0], cache


# ------------------------------------------------------------------ decode
def _block_decode_(cfg: ArchConfig, blk: dict, x, kc, vc, slot_pos, pos: int):
    """:func:`dense_block_decode` writing the new K/V into ``kc``/``vc`` in
    place; returns the layer's output."""
    x = x + _attn_decode_(cfg, blk["attn"], rmsnorm(x, blk["ln1"]), kc, vc, slot_pos, pos)
    if cfg.family == "moe":
        f, _ = moe.moe_ffn(cfg, blk["moe"], rmsnorm(x, blk["ln2"])[:, None, :])
        f = f[:, 0]
    else:
        f = _mlp(cfg, blk["mlp"], rmsnorm(x, blk["ln2"]))
    return x + f


def dense_block_decode(cfg: ArchConfig, blk: dict, x, kc, vc, slot_pos, pos):
    """One dense/moe decoder layer for a single token: attention over the
    ring-buffer KV cache ``kc``/``vc`` [B, Sc, kv, hd] + FFN. Returns
    ``(x, kc, vc)`` with the new token's K/V written at ``pos % Sc`` into
    copies; the caches given stay as they were.

    The public form of :func:`_block_decode_`, the seam that :func:`decode`
    and the quantized decode (``repro_torch.vq.decode``) share: both run
    that block, over raw and over dequantized caches, so raw and quantized
    serving cannot drift apart structurally."""
    kc, vc = kc.clone(), vc.clone()
    x = _block_decode_(cfg, blk, x, kc, vc, slot_pos, int(pos))
    return x, kc, vc


def _decode(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, pos: int):
    """One decode step writing the token's K/V and slot position into
    ``cache``'s own tensors; returns the logits. The generation loops'
    step (the reference donates the cache there)."""
    cache_mod.check_family(cfg)
    x = _embed(cfg, params, token)  # [B, D]
    sc = cache["slot_pos"].shape[1]
    slot_pos = cache["slot_pos"]
    slot_pos[:, pos % sc] = pos  # the token sees itself
    k_all, v_all = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        x = _block_decode_(cfg, layer(params["layers"], i), x, k_all[i], v_all[i], slot_pos, pos)
    return _head(cfg, params, x)


def decode(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, pos):
    """One decode step. token [B], pos an int or a 0-d tensor →
    (logits [B,V], new cache); ``cache`` stays as it was."""
    new = {key: val.clone() if key in ("k", "v", "slot_pos") else val
           for key, val in cache.items()}
    return _decode(cfg, params, new, token, int(pos)), new
