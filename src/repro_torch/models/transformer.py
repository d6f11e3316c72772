"""One decoder substrate for the ten assigned architectures. Counterpart of
``repro.models.transformer``.

Families:
  dense / audio — pre-norm GQA attention + SwiGLU (RoPE, optional
                  qk-norm/SWA)
  moe           — attention + MoE FFN (``moe.py``, single-device path)
  ssm           — Mamba2/SSD stack (``mamba2.py``; attention-free)
  hybrid        — Mamba2 backbone + one *shared* attention+MLP block invoked
                  every N layers on concat(h, embeddings) (Zamba2)
  vlm           — dense backbone + gated cross-attention image layers every
                  N layers; image embeddings come precomputed (stub frontend)

Parameters are the reference's tree: per-layer leaves stacked on leading
axes (``[L, ...]``; the vlm's ``self_layers`` and the hybrid's
``mamba_groups`` ``[G, per, ...]``), in ``cfg.param_dtype``, cast to
``cfg.dtype`` at use (``cast_params_before_use``). Layers run as a Python
loop over the stacks (``scan_layers`` has no effect). :func:`forward` takes
each layer's parameters as views of one ``unbind`` of each stack, so its
backward stacks a leaf's gradient once. With ``cfg.remat`` and gradients
enabled, every layer body (a decoder block, a Mamba layer, the hybrid's
shared block, the vlm's cross block) runs under
``torch.utils.checkpoint`` and is recomputed in the backward, the
reference's per-layer ``jax.checkpoint``; under ``no_grad`` or
``inference_mode`` nothing is checkpointed.

Caches are functional for callers: :func:`prefill`, :func:`decode` and
:func:`dense_block_decode` return new caches and leave the ones they were
given as they were, nested trees included, as the reference's do. The
generation loops (``launch.serve.generate`` and ``repro_torch.vq``'s), which
the reference runs with the cache donated, step with :func:`_decode` writing
ring slots and recurrent states in place, so a step copies no cache.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as rnd
from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.models import cache as cache_mod
from repro_torch.models import mamba2, moe
from repro_torch.models.layers import (
    attention,
    cross_attention,
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
    return pos, rope_tables(pos, cfg.hd, cfg.rope_theta) if cfg.n_heads else None


# ------------------------------------------------------------------ init
def _init_attn(cfg: ArchConfig, key: rnd.Key, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ks = rnd.split(key, 4)
    pdt = cfg.param_dtype

    def normal(k, shape):
        return rnd.normal(k, shape, device=device, std=0.02).to(pdt)

    p = {
        "wq": normal(ks[0], (d, h * hd)),
        "wk": normal(ks[1], (d, kv * hd)),
        "wv": normal(ks[2], (d, kv * hd)),
        "wo": normal(ks[3], (h * hd, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=pdt, device=device)
        p["k_norm"] = torch.ones(hd, dtype=pdt, device=device)
    return p


def _init_mlp(cfg: ArchConfig, key: rnd.Key, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    ks = rnd.split(key, 3)

    def normal(k, shape):
        return rnd.normal(k, shape, device=device, std=0.02).to(cfg.param_dtype)

    return {"w1": normal(ks[0], (d, f)), "w3": normal(ks[1], (d, f)), "w2": normal(ks[2], (f, d))}


def _init_block(cfg: ArchConfig, key: rnd.Key, device) -> dict:
    """One standard decoder layer for this config's family."""
    ka, kf = rnd.split(key, 2)
    pdt = cfg.param_dtype
    block: dict[str, Any] = {"ln1": torch.ones(cfg.d_model, dtype=pdt, device=device)}
    if cfg.family == "ssm":
        block["mamba"] = mamba2.init_mamba_params(cfg, ka, device=device)
        return block
    block["attn"] = _init_attn(cfg, ka, device)
    block["ln2"] = torch.ones(cfg.d_model, dtype=pdt, device=device)
    if cfg.family == "moe":
        block["moe"] = moe.init_moe_params(cfg, kf, device=device)
    else:
        block["mlp"] = _init_mlp(cfg, kf, device)
    return block


def _init_cross_block(cfg: ArchConfig, key: rnd.Key, device) -> dict:
    """A gated cross-attention layer; both gates start at 0 (tanh(0) = 0)."""
    ka, kf = rnd.split(key, 2)
    pdt = cfg.param_dtype
    return {
        "ln1": torch.ones(cfg.d_model, dtype=pdt, device=device),
        "ln2": torch.ones(cfg.d_model, dtype=pdt, device=device),
        "attn": _init_attn(cfg, ka, device),
        "mlp": _init_mlp(cfg, kf, device),
        "gate_attn": torch.zeros((), dtype=pdt, device=device),
        "gate_mlp": torch.zeros((), dtype=pdt, device=device),
    }


def _stacked_like(tree: dict, lead: tuple[int, ...]) -> dict:
    return {k: _stacked_like(v, lead) if isinstance(v, dict)
            else torch.empty((*lead, *v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def _fill(stack: dict, tree: dict, i) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill(stack[k], v, i)
        else:
            stack[k][i] = v


def _stack(init_fn, keys, lead: tuple[int, ...]) -> dict:
    """``init_fn(key)`` for each key, drawn one layer at a time into stacks
    with leading axes ``lead`` (row-major over the keys)."""
    stack = None
    for i, k in enumerate(keys):
        block = init_fn(k)
        if stack is None:
            stack = _stacked_like(block, lead)
        _fill(stack, block, _unravel(i, lead))
        del block
    return stack


def _unravel(i: int, lead: tuple[int, ...]) -> tuple[int, ...]:
    """Flat index ``i`` as a row-major index into ``lead``."""
    out = []
    for n in reversed(lead):
        out.append(i % n)
        i //= n
    return tuple(reversed(out))


def layer(stack: dict, i) -> dict:
    """Layer ``i``'s parameters (views) of a stacked ``[L, ...]`` tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def _unstack(stack: dict, n: int) -> list[dict]:
    """The ``n`` per-layer trees of a stacked ``[n, ...]`` tree, as views:
    one ``unbind`` a leaf, whose backward stacks the layers' gradients once
    (indexing layer by layer would add a zero-filled ``[n, ...]`` gradient
    for every layer)."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in stack.items():
        for tree, part in zip(out, _unstack(v, n) if isinstance(v, dict) else v.unbind(0),
                              strict=True):
            tree[k] = part
    return out


def init_params(cfg: ArchConfig, key: rnd.Key, *, device: str | torch.device = "cuda") -> dict[str, Any]:
    """The reference's parameter tree with N(0, 0.02²) weights, unit norms
    and the reference's other constants, drawn on ``device`` one layer at a
    time into the stacks."""
    device = resolve_device(device)
    ke, kh, kl, ks = rnd.split(key, 4)
    std = 0.02
    pdt = cfg.param_dtype
    vp = cfg.vocab_padded
    params: dict[str, Any] = {
        "embed": rnd.normal(ke, (vp, cfg.d_model), device=device, std=std).to(pdt),
        "out_head": rnd.normal(kh, (cfg.d_model, vp), device=device, std=std).to(pdt),
        "final_norm": torch.ones(cfg.d_model, dtype=pdt, device=device),
    }
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        per = cfg.cross_attn_every - 1  # self layers per group
        params["self_layers"] = _stack(lambda k: _init_block(cfg, k, device),
                                       rnd.split(kl, g * per), (g, per))
        params["cross_layers"] = _stack(lambda k: _init_cross_block(cfg, k, device),
                                        rnd.split(ks, g), (g,))
    elif cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        per = cfg.shared_attn_every
        tail = cfg.n_layers - g * per
        ssm_cfg = cfg.replace(family="ssm")
        params["mamba_groups"] = _stack(lambda k: _init_block(ssm_cfg, k, device),
                                        rnd.split(kl, g * per), (g, per))
        if tail:
            params["mamba_tail"] = _stack(lambda k: _init_block(ssm_cfg, k, device),
                                          rnd.split(rnd.fold_in(kl, 1), tail), (tail,))
        # the shared block: attn+mlp over concat(h, embeddings) -> d_model
        kp, kb = rnd.split(ks, 2)
        params["shared_in"] = rnd.normal(kp, (2 * cfg.d_model, cfg.d_model), device=device,
                                         std=std).to(pdt)
        params["shared_block"] = _init_block(cfg.replace(family="dense"), kb, device)
    else:
        params["layers"] = _stack(lambda k: _init_block(cfg, k, device),
                                  rnd.split(kl, cfg.n_layers), (cfg.n_layers,))
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
    k, v = _expand_kv(cfg, k, v)
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
    if cfg.family == "ssm":
        x = x + mamba2.mamba_forward(cfg, block["mamba"], rmsnorm(x, block["ln1"]))
        return shard(x, "batch", "seq", None), None, 0.0
    o = _attn_full(cfg, block["attn"], rmsnorm(x, block["ln1"]), pos_ctx, return_kv=return_kv)
    o, kvs = o if return_kv else (o, None)
    x = x + o
    f, aux = _ffn(cfg, block, x)
    return shard(x + f, "batch", "seq", None), kvs, aux


def _cross_block_full(cfg, block, x, image_kv):
    """Gated cross-attention layer over the image K/V (GQA layout)."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    p = block["attn"]
    hidden = rmsnorm(x, block["ln1"])
    q = matmul(hidden, _wt(cfg, p["wq"], x.dtype)).reshape(b, s, h, hd)
    ik, iv = _expand_kv(cfg, *image_kv)
    o = matmul(cross_attention(q, ik, iv).reshape(b, s, h * hd), _wt(cfg, p["wo"], x.dtype))
    x = x + torch.tanh(block["gate_attn"]).to(x.dtype) * o
    f = _mlp(cfg, block["mlp"], rmsnorm(x, block["ln2"]))
    x = x + torch.tanh(block["gate_mlp"]).to(x.dtype) * f
    return shard(x, "batch", "seq", None)


def _image_kv(cfg, block, image_embeds):
    """Project the (stubbed) image embeddings to this cross layer's K/V, in
    the GQA (cache) layout: ``[B, T_img, kv, hd]`` each."""
    b, t, _ = image_embeds.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    p = block["attn"]
    ik = matmul(image_embeds, _wt(cfg, p["wk"], image_embeds.dtype)).reshape(b, t, kv, hd)
    iv = matmul(image_embeds, _wt(cfg, p["wv"], image_embeds.dtype)).reshape(b, t, kv, hd)
    return ik, iv


def _expand_kv(cfg, k, v):
    if _should_expand_gqa(cfg):
        g = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return k, v


def _shared_block_full(cfg, params, x, x0, pos_ctx, *, return_kv=False):
    """Zamba2's shared attention block on concat(h, embeddings)."""
    block = params["shared_block"]
    cat = torch.cat([x, x0], dim=-1)
    h = matmul(cat, _wt(cfg, params["shared_in"], x.dtype))
    o = _attn_full(cfg, block["attn"], rmsnorm(h, block["ln1"]), pos_ctx, return_kv=return_kv)
    o, kvs = o if return_kv else (o, None)
    h = h + o
    h = h + _mlp(cfg, block["mlp"], rmsnorm(h, block["ln2"]))
    return shard(x + h, "batch", "seq", None), kvs


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


def _kv_stacks(lead, b, s, cfg, dtype, device):
    shape = (*lead, b, s, cfg.n_kv_heads, cfg.hd)
    return (torch.empty(shape, dtype=dtype, device=device),
            torch.empty(shape, dtype=dtype, device=device))


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
    kv_stacks). With ``collect_cache``, ``kv_stacks`` is the reference's:
    ``(k, v)`` each ``[L, B, S, kv, hd]`` (hybrid: the shared block's, ``[G,
    ...]``), or for a vlm ``((k, v) [G, per, ...], (ik, iv) [G, B, T_img,
    kv, hd])``; otherwise ``None``. A vlm needs ``image_embeds [B, T_img,
    D]``.

    ``head_last_only`` computes the unembedding for the final position only
    (prefill never needs [B, S, V] logits)."""
    b, s = tokens.shape
    pos_ctx = _pos_ctx(cfg, s, tokens.device)
    x = _embed(cfg, params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    kvs = None
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args, **kw):
        """``fn(*args, **kw)``, checkpointed under ``remat``."""
        if remat:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
        return fn(*args, **kw)

    if cfg.family == "vlm":
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: a vlm forward needs image_embeds [B, T_img, D]")
        g = cfg.n_layers // cfg.cross_attn_every
        per = cfg.cross_attn_every - 1
        if collect_cache:
            t = image_embeds.shape[1]
            self_kv = _kv_stacks((g, per), b, s, cfg, x.dtype, x.device)
            image_kv = _kv_stacks((g,), b, t, cfg, image_embeds.dtype, x.device)
            kvs = (self_kv, image_kv)

        def cross(cb, x):
            return _cross_block_full(cfg, cb, x, _image_kv(cfg, cb, image_embeds))

        cross_layers = _unstack(params["cross_layers"], g)
        for gi, self_stack in enumerate(_unstack(params["self_layers"], g)):
            for i, blk in enumerate(_unstack(self_stack, per)):
                x, kv_i, a = run(_decoder_block_full, cfg, blk, x, pos_ctx,
                                 return_kv=collect_cache)
                aux_total = aux_total + a
                if collect_cache:
                    self_kv[0][gi, i], self_kv[1][gi, i] = kv_i
            if collect_cache:
                ikv = _image_kv(cfg, cross_layers[gi], image_embeds)
                x = _cross_block_full(cfg, cross_layers[gi], x, ikv)
                image_kv[0][gi], image_kv[1][gi] = ikv
            else:
                x = run(cross, cross_layers[gi], x)
    elif cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        per = cfg.shared_attn_every
        ssm_cfg = cfg.replace(family="ssm")
        x0 = x
        if collect_cache:
            kvs = _kv_stacks((g,), b, s, cfg, x.dtype, x.device)
        for gi, group in enumerate(_unstack(params["mamba_groups"], g)):
            x, kv_g = run(_shared_block_full, cfg, params, x, x0, pos_ctx,
                          return_kv=collect_cache)
            if collect_cache:
                kvs[0][gi], kvs[1][gi] = kv_g
            for blk in _unstack(group, per):
                x, _, _ = run(_decoder_block_full, ssm_cfg, blk, x, pos_ctx)
        if "mamba_tail" in params:
            for blk in _unstack(params["mamba_tail"], cfg.n_layers - g * per):
                x, _, _ = run(_decoder_block_full, ssm_cfg, blk, x, pos_ctx)
    else:
        collect = collect_cache and cfg.family != "ssm"
        if collect:
            kvs = _kv_stacks((cfg.n_layers,), b, s, cfg, x.dtype, x.device)
        for i, blk in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, kv_l, a = run(_decoder_block_full, cfg, blk, x, pos_ctx, return_kv=collect)
            aux_total = aux_total + a
            if collect:
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
    ``min(s, Sc)`` prompt positions go to their ring slots; ssm and hybrid
    layers leave their final conv and SSM states."""
    b, s = tokens.shape
    max_seq_len = max_seq_len or s
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_recurrent(cfg, params, tokens, max_seq_len)
    logits, _, kvs = forward(
        cfg, params, tokens, image_embeds, collect_cache=True, head_last_only=True
    )
    image = {}
    if cfg.family == "vlm":
        (k_all, v_all), (ik, iv) = kvs  # [G, per, B, S, kv, hd]
        image = {"xk": ik, "xv": iv}
        k_stack = k_all.reshape(-1, *k_all.shape[2:])
        v_stack = v_all.reshape(-1, *v_all.shape[2:])
    else:
        k_stack, v_stack = kvs
    sc = cache_mod.cache_seq_len(cfg, max_seq_len)
    dev = tokens.device
    if sc == s:
        # the collected stacks are the cache
        slot_pos = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
        return logits[:, 0], {"k": k_stack, "v": v_stack, "slot_pos": slot_pos.contiguous(),
                              **image}
    cache = cache_mod.init_cache(cfg, b, max_seq_len, device=dev)
    cache.update(image)
    _place(cache, k_stack, v_stack, s, sc)
    return logits[:, 0], cache


def _place(cache, k_stack, v_stack, s, sc):
    """The last ``min(s, Sc)`` positions of ``[L, B, S, kv, hd]`` stacks to
    their ring slots of ``cache["k"]/["v"] [L, B, Sc, kv, hd]``, and their
    positions to ``cache["slot_pos"]``."""
    dev = k_stack.device
    tail = min(s, sc)
    positions = torch.arange(s - tail, s, device=dev)
    slots = positions % sc
    cache["k"][:, :, slots] = k_stack[:, :, s - tail:]
    cache["v"][:, :, slots] = v_stack[:, :, s - tail:]
    cache["slot_pos"][:, slots] = positions.to(torch.int32)[None, :]


def _mamba_prefill(cfg, blk, x, conv, ssm):
    """One ssm layer over the prompt, its final states written into
    ``conv``/``ssm`` (the layer's cache rows); returns the layer's output."""
    out, (c, st) = mamba2.mamba_forward(cfg, blk["mamba"], rmsnorm(x, blk["ln1"]),
                                        return_state=True)
    conv.copy_(c)
    ssm.copy_(st)
    return x + out


def _prefill_recurrent(cfg: ArchConfig, params: dict, tokens: torch.Tensor, max_seq_len: int):
    """ssm/hybrid prefill: the full-sequence forward, collecting final
    states (and the hybrid's shared-block K/V)."""
    b, s = tokens.shape
    pos_ctx = _pos_ctx(cfg, s, tokens.device)
    x = _embed(cfg, params, tokens)
    cache = cache_mod.init_cache(cfg, b, max_seq_len, device=tokens.device)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _mamba_prefill(cfg, layer(params["layers"], i), x, cache["conv"][i],
                               cache["ssm"][i])
        return _head(cfg, params, x[:, -1]), cache

    g = cfg.n_layers // cfg.shared_attn_every
    per = cfg.shared_attn_every
    sc = cache_mod.cache_seq_len(cfg, max_seq_len)
    x0 = x
    k_g, v_g = _kv_stacks((g,), b, s, cfg, x.dtype, x.device)
    mcache = cache["mamba"]
    for gi in range(g):
        x, (k_g[gi], v_g[gi]) = _shared_block_full(cfg, params, x, x0, pos_ctx, return_kv=True)
        group = layer(params["mamba_groups"], gi)
        for i in range(per):
            l = gi * per + i
            x = _mamba_prefill(cfg, layer(group, i), x, mcache["conv"][l], mcache["ssm"][l])
    if "mamba_tail" in params:
        tcache = cache["mamba_tail"]
        for i in range(cfg.n_layers - g * per):
            x = _mamba_prefill(cfg, layer(params["mamba_tail"], i), x, tcache["conv"][i],
                               tcache["ssm"][i])
    shared = dict(cache["shared"], slot_pos=cache["slot_pos"])
    _place(shared, k_g, v_g, s, sc)
    return _head(cfg, params, x[:, -1]), cache


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


def _mamba_block_decode_(cfg, blk, x, conv, ssm):
    """One ssm layer for a single token, its states updated in place in
    ``conv``/``ssm``; returns the layer's output."""
    out, (c, st) = mamba2.mamba_decode(cfg, blk["mamba"], rmsnorm(x, blk["ln1"]), conv, ssm)
    conv.copy_(c)
    ssm.copy_(st)
    return x + out


def _cross_block_decode(cfg, blk, x, xk, xv):
    """The gated cross layer for a single token over the cached image K/V."""
    p = blk["attn"]
    h = rmsnorm(x, blk["ln1"])
    q = matmul(h, _wt(cfg, p["wq"], x.dtype)).reshape(x.shape[0], 1, cfg.n_heads, cfg.hd)
    o = cross_attention(q, xk, xv)[:, 0].reshape(x.shape[0], -1)
    x = x + torch.tanh(blk["gate_attn"]).to(x.dtype) * matmul(o, _wt(cfg, p["wo"], x.dtype))
    f = _mlp(cfg, blk["mlp"], rmsnorm(x, blk["ln2"]))
    return x + torch.tanh(blk["gate_mlp"]).to(x.dtype) * f


def _decode(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, pos: int):
    """One decode step writing the token's K/V, slot position and recurrent
    states into ``cache``'s own tensors; returns the logits. The generation
    loops' step (the reference donates the cache there)."""
    x = _embed(cfg, params, token)  # [B, D]
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _mamba_block_decode_(cfg, layer(params["layers"], i), x, cache["conv"][i],
                                     cache["ssm"][i])
        return _head(cfg, params, x)
    sc = cache["slot_pos"].shape[1]
    slot_pos = cache["slot_pos"]
    slot_pos[:, pos % sc] = pos  # the token sees itself
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        per = cfg.shared_attn_every
        x0 = x
        blk = params["shared_block"]
        mcache, shared = cache["mamba"], cache["shared"]
        for gi in range(g):
            # the shared block (single token)
            h = matmul(torch.cat([x, x0], dim=-1), _wt(cfg, params["shared_in"], x.dtype))
            h = h + _attn_decode_(cfg, blk["attn"], rmsnorm(h, blk["ln1"]), shared["k"][gi],
                                  shared["v"][gi], slot_pos, pos)
            h = h + _mlp(cfg, blk["mlp"], rmsnorm(h, blk["ln2"]))
            x = x + h
            group = layer(params["mamba_groups"], gi)
            for i in range(per):
                l = gi * per + i
                x = _mamba_block_decode_(cfg, layer(group, i), x, mcache["conv"][l],
                                         mcache["ssm"][l])
        if "mamba_tail" in params:
            tcache = cache["mamba_tail"]
            for i in range(cfg.n_layers - g * per):
                x = _mamba_block_decode_(cfg, layer(params["mamba_tail"], i), x,
                                         tcache["conv"][i], tcache["ssm"][i])
        return _head(cfg, params, x)
    k_all, v_all = cache["k"], cache["v"]
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        per = cfg.cross_attn_every - 1
        for gi in range(g):
            self_stack = layer(params["self_layers"], gi)
            for i in range(per):
                l = gi * per + i
                x = _block_decode_(cfg, layer(self_stack, i), x, k_all[l], v_all[l], slot_pos,
                                   pos)
            x = _cross_block_decode(cfg, layer(params["cross_layers"], gi), x, cache["xk"][gi],
                                    cache["xv"][gi])
        return _head(cfg, params, x)
    for i in range(cfg.n_layers):
        x = _block_decode_(cfg, layer(params["layers"], i), x, k_all[i], v_all[i], slot_pos, pos)
    return _head(cfg, params, x)


def _clone_tree(tree: dict) -> dict:
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def decode(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, pos):
    """One decode step. token [B], pos an int or a 0-d tensor →
    (logits [B,V], new cache); ``cache`` stays as it was."""
    new = _clone_tree(cache)
    return _decode(cfg, params, new, token, int(pos)), new
