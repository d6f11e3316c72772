"""One decoder substrate for the ten assigned architectures. Counterpart of
``repro.models.transformer``.

Families:
  dense / audio — pre-norm GQA attention + SwiGLU (RoPE, optional
                  qk-norm/SWA)
  moe           — attention + MoE FFN (``moe.py``)
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

Under a mesh of W > 1 ranks, :func:`forward`, :func:`prefill` and
:func:`decode` given ``param_shardings`` (``distributed.params``' placement
tree) take ``params`` as this rank's shards (``distributed.fsdp``) and the
rank's rows: each layer's weights are gathered where the layer runs
(inside ``cfg.remat``'s checkpoint, so the backward gathers them again),
the embedding and the head where they are used, the hybrid's shared block
once a pass. A MoE layer sizes its capacity from the rank's tokens and its
``aux`` is the rank's; the train step averages the loss, aux included,
over the ranks (the reference's ``"ep"`` island at one model rank).

On a mesh whose ``"model"`` dimension has M > 1 ranks the dense and moe
families run the reference's model axis, Megatron-style
(``distributed.tp``); the other families raise ``NotImplementedError``
(ROADMAP A19). Between blocks the residual stream is ``[B/Dp, S/M, D]`` a
rank where M divides S > 1, else whole on the model ranks (the reference's
``shard(x, "batch", "seq", None)``). Attention and the MLP gather the
sequence before their column-parallel products (``wq``/``wk``/``wv``,
``w1``/``w3``: H/M heads, F/M columns a rank) and add the row-parallel
``wo``/``w2`` partials over the ranks in f32, each rank keeping its part of
the sequence. GQA is expanded as the reference's ``_should_expand_gqa``
decides (``n_kv_heads`` not dividing M): ``wk``/``wv`` are gathered whole
and each rank takes its heads' repeats. The embedding is vocab-parallel
(each rank looks up the ids in its rows, the ranks' rows added), the head
too: :func:`forward` returns the rank's ``Vp/M`` columns of the logits and
``train_step.cross_entropy`` reduces its row max, sum and label logit over
the ranks. A KV cache holds ``Sc/M`` slots a rank (``cache.init_cache``);
decode writes the new token's K/V into its slot on the rank that owns it,
and each rank's partial softmax over its slots is combined over the ranks
in rank order (flash decoding). The MoE runs the reference's ``ep``,
``ep_split`` or ``tp`` island (``moe.moe_ffn``).

Caches are functional for callers: :func:`prefill`, :func:`decode` and
:func:`dense_block_decode` return new caches and leave the ones they were
given as they were, nested trees included, as the reference's do. The
generation loops (``launch.serve.generate`` and ``repro_torch.vq``'s), which
the reference runs with the cache donated, step with :func:`_decode` writing
ring slots and recurrent states in place, so a step copies no cache.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as rnd
from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import fsdp, tp
from repro_torch.distributed.sharding import current_mesh, shard, use_mesh
from repro_torch.models import cache as cache_mod
from repro_torch.models import mamba2, moe
from repro_torch.models.layers import (
    attention,
    cross_attention,
    decode_attention,
    decode_attention_partial,
    decode_combine,
    matmul,
    rmsnorm,
    rope,
    rope_tables,
    swiglu,
)

__all__ = ["init_params", "forward", "prefill", "decode", "dense_block_decode"]


class _Par(NamedTuple):
    """The model axis of a step: its ``m`` ranks, and whether the residual
    stream is split on the sequence over them."""

    m: int
    seq: bool


#: the families on the model axis; the others wait for ROADMAP A19
_MODEL_AXIS_FAMILIES = ("dense", "moe")


def _check_family(cfg: ArchConfig) -> None:
    if tp.active() and cfg.family not in _MODEL_AXIS_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family does not run on a mesh whose 'model' "
            f"dimension has {tp.model_size()} ranks yet (ROADMAP A19); use a 'data' mesh")


def _par(cfg: ArchConfig, ps, s: int) -> _Par | None:
    """The model axis of a step over ``s`` positions (``None`` without
    placements or a model axis). Raises where the config does not split
    over it."""
    _check_family(cfg)
    if ps is None or not tp.active():
        return None
    m = tp.model_size()
    sizes = {"heads": cfg.n_heads, "vocab_padded": cfg.vocab_padded}
    if not _should_expand_gqa(cfg):
        sizes["n_kv_heads"] = cfg.n_kv_heads
    if cfg.family == "dense":
        sizes["d_ff"] = cfg.d_ff
    else:
        f = cfg.moe_d_ff or cfg.d_ff
        if moe.moe_mode(cfg.n_experts, m) != "ep":
            sizes["moe_d_ff"] = f
        if cfg.n_shared_experts:
            sizes["shared d_ff"] = cfg.n_shared_experts * f
    bad = {k: v for k, v in sizes.items() if v % m}
    if bad:
        raise ValueError(f"{cfg.name}: {bad} do not split over the {m} ranks of 'model'")
    return _Par(m, s % m == 0 and s > 1)


def _pos_ctx(cfg: ArchConfig, s: int, device, par: _Par | None = None):
    """(positions, shared rope tables, the model axis) computed once per
    step."""
    pos = torch.arange(s, device=device)
    return pos, rope_tables(pos, cfg.hd, cfg.rope_theta) if cfg.n_heads else None, par


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
    """The reference's rule: on a model axis of M > 1 ranks, where M
    divides the heads and not the KV heads."""
    if cfg.expand_gqa != "auto":
        return bool(cfg.expand_gqa)
    m = tp.model_size()
    if m <= 1:
        return False
    return cfg.n_kv_heads % m != 0 and cfg.n_heads % m == 0


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the operands' values, accumulated and returned in f32:
    a row-parallel partial, added over the model ranks before it is
    rounded to the activations' dtype."""
    return a.float() @ b.float()


def _to_residual(partial: torch.Tensor, par: _Par, dtype) -> torch.Tensor:
    """Row-parallel partials ``[B, S, D]`` (or ``[B, D]``) added over the
    model ranks into the residual stream's layout, in ``dtype``."""
    if par.seq:
        return tp.scatter_sum(partial, 1, dtype)
    return tp.all_sum(partial, dtype)


def _kv_weights(cfg, p, dtype, expand: bool):
    """``wk``/``wv`` for use: whole (gathered over the model ranks where
    they are split) when GQA is expanded, else the rank's KV heads."""
    wk, wv = _wt(cfg, p["wk"], dtype), _wt(cfg, p["wv"], dtype)
    if expand and wk.shape[-1] != cfg.n_kv_heads * cfg.hd:
        wk, wv = tp.gather_seq(wk, 1), tp.gather_seq(wv, 1)
    return wk, wv


def _rank_heads(cfg, k, v):
    """The expanded K/V heads of this rank's query heads, from every KV
    head ``[B, S, kv, hd]``."""
    hl = cfg.n_heads // tp.model_size()
    g = cfg.n_heads // cfg.n_kv_heads
    lo = tp.model_rank() * hl
    return (k.repeat_interleave(g, dim=2)[:, :, lo:lo + hl],
            v.repeat_interleave(g, dim=2)[:, :, lo:lo + hl])


def _attn_full_tp(cfg: ArchConfig, p: dict, x, pos_ctx, *, return_kv=False):
    """:func:`_attn_full` on the model axis: ``x`` the rank's part of the
    residual stream (normed); returns the rank's part of the output and,
    with ``return_kv``, every KV head's K/V over the whole sequence."""
    positions, tables, par = pos_ctx
    h = tp.gather_seq(x) if par.seq else x
    b, s, _ = h.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    hl = cfg.n_heads // par.m
    expand = _should_expand_gqa(cfg)
    wk, wv = _kv_weights(cfg, p, h.dtype, expand)
    kl = kv if expand else kv // par.m
    q = matmul(h, _wt(cfg, p["wq"], h.dtype)).reshape(b, s, hl, hd)
    k = matmul(h, wk).reshape(b, s, kl, hd)
    v = matmul(h, wv).reshape(b, s, kl, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta, tables)
    k = rope(k, positions, cfg.rope_theta, tables)
    kv_out = None
    if return_kv:
        kv_out = (k, v) if expand else (tp.gather_seq(k, 2), tp.gather_seq(v, 2))
    if expand:
        k, v = _rank_heads(cfg, k, v)
    o = attention(q, k, v, window=cfg.window, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    out = _to_residual(_matmul_f32(o.reshape(b, s, hl * hd), _wt(cfg, p["wo"], h.dtype)), par,
                       x.dtype)
    return (out, kv_out) if return_kv else out


def _mlp_tp(cfg, p, x, par: _Par):
    """The SwiGLU MLP on the model axis: ``x`` the rank's part of the
    residual stream (normed)."""
    h = tp.gather_seq(x) if par.seq else x
    a = torch.nn.functional.silu(matmul(h, _wt(cfg, p["w1"], h.dtype))) * matmul(
        h, _wt(cfg, p["w3"], h.dtype))
    return _to_residual(_matmul_f32(a, _wt(cfg, p["w2"], h.dtype)), par, x.dtype)


def _attn_full(cfg: ArchConfig, p: dict, x, pos_ctx, *, return_kv=False):
    """Full-sequence attention sub-block. x [B, S, D]."""
    positions, tables, par = pos_ctx
    if par is not None:
        return _attn_full_tp(cfg, p, x, pos_ctx, return_kv=return_kv)
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


def _ffn(cfg: ArchConfig, block: dict, x, par: _Par | None = None):
    """Post-attention FFN (dense or MoE). Returns (out, aux_loss)."""
    h = rmsnorm(x, block["ln2"])
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, block["moe"], h, par)
    f = _mlp(cfg, block["mlp"], h) if par is None else _mlp_tp(cfg, block["mlp"], h, par)
    return f, torch.zeros((), dtype=torch.float32, device=x.device)


def _decoder_block_full(cfg, block, x, pos_ctx, *, return_kv=False):
    if cfg.family == "ssm":
        x = x + mamba2.mamba_forward(cfg, block["mamba"], rmsnorm(x, block["ln1"]))
        return shard(x, "batch", "seq", None), None, 0.0
    o = _attn_full(cfg, block["attn"], rmsnorm(x, block["ln1"]), pos_ctx, return_kv=return_kv)
    o, kvs = o if return_kv else (o, None)
    x = x + o
    f, aux = _ffn(cfg, block, x, pos_ctx[2])
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


def _embed(cfg, params, tokens, ps=None, par: _Par | None = None):
    """Rows of the embedding in ``cfg.dtype`` (gathered, then cast: the
    same values as the reference's cast-then-gather). Sharded, the rows
    come through ``fsdp.lookup`` as stored, so the gradient adds in that
    dtype too. On the model axis each rank looks the ids up in its
    ``Vp/M`` rows (zero rows for the others' ids) and the ranks' rows are
    added (exact: one non-zero term), into the residual stream's layout."""
    if ps is None:
        return _wt(cfg, params["embed"][tokens.long()], cfg.dtype)
    if par is None:
        return _wt(cfg, fsdp.lookup(cfg, params["embed"], ps["embed"], tokens), cfg.dtype)
    table = params["embed"]
    rows = table.shape[0]
    local = tokens.long() - tp.model_rank() * rows
    inside = (local >= 0) & (local < rows)
    found = fsdp.lookup(cfg, table, ps["embed"], torch.where(inside, local, 0))
    found = found * inside[..., None].to(found.dtype)
    return _wt(cfg, _to_residual(found, par, found.dtype), cfg.dtype)


def _last_position(x: torch.Tensor, par: _Par | None) -> torch.Tensor:
    """``x[:, -1:]`` of the residual stream, whole: on a sequence split
    over the model ranks, the last rank's, added over the ranks."""
    if par is None or not par.seq:
        return x[:, -1:]
    last = x[:, -1:] * float(tp.model_rank() == par.m - 1)
    return tp.all_sum(last)


def _head(cfg, params, x, ps=None, par: _Par | None = None):
    """f32 logits ``[..., vocab_padded]``, padding columns at −1e30. On the
    model axis, this rank's ``Vp/M`` columns of every position's logits
    (``x`` the rank's part of the sequence where ``par.seq``)."""
    params = _use_keys(cfg, params, ps, ("final_norm", "out_head"))
    x = rmsnorm(x, params["final_norm"])
    if par is not None and par.seq:
        x = tp.gather_seq(x)
    w = _wt(cfg, params["out_head"], x.dtype)
    logits = x.float() @ w.float()
    if cfg.vocab_padded > cfg.vocab:  # mask the padding columns
        cols = torch.arange(w.shape[-1], device=x.device)
        if par is not None:
            cols = cols + tp.model_rank() * w.shape[-1]
        logits = logits.masked_fill(cols >= cfg.vocab, -1e30)
    return logits


def _kv_stacks(lead, b, s, cfg, dtype, device):
    shape = (*lead, b, s, cfg.n_kv_heads, cfg.hd)
    return (torch.empty(shape, dtype=dtype, device=device),
            torch.empty(shape, dtype=dtype, device=device))


# ------------------------------------------------------------------ FSDP
def _shardings(params: dict, param_shardings):
    """The placement tree the seams gather by: ``None`` on whole
    parameters, and on a mesh of one rank, where a shard is its leaf.
    Raises outside a mesh and on a tree that does not match ``params``."""
    if param_shardings is None:
        return None
    if current_mesh() is None:
        raise ValueError("param_shardings lays parameters out on a mesh: call inside "
                         "sharding.use_mesh(mesh)")
    fsdp.check_places(params, param_shardings)
    return param_shardings if fsdp.active() else None


def _use(cfg, tree: dict, places):
    """``tree`` for use: gathered from this rank's shards under ``places``,
    itself on whole parameters (``places`` None)."""
    return tree if places is None else fsdp.gather_tree(cfg, tree, places)


def _at_use(fn, places):
    """``fn(cfg, block, ...)`` that first gathers ``block`` under
    ``places``: passed to ``run``, the gather is inside the checkpoint. It
    runs on the current mesh wherever it is called: the backward recomputes
    a checkpointed block on the autograd engine's thread, and a CUDA
    backward's thread does not see the caller's (thread-local) mesh."""
    if places is None:
        return fn
    mesh = current_mesh()

    def gathered(cfg, block, *args, **kw):
        with use_mesh(mesh):
            return fn(cfg, fsdp.gather_tree(cfg, block, places), *args, **kw)

    return gathered


def _layer_places(ps, key: str, lead: int = 1):
    """One layer's placements of the stack under ``key`` (``None``
    without placements or such a stack)."""
    return None if ps is None or key not in ps else fsdp.layer_places(ps[key], lead)


def _use_keys(cfg, params: dict, ps, keys: tuple[str, ...]) -> dict:
    """:func:`_use` of ``params``' entries ``keys``."""
    return _use(cfg, {k: params[k] for k in keys}, None if ps is None else {k: ps[k] for k in keys})


#: the hybrid's shared block and its input projection, gathered once a pass
_SHARED = ("shared_in", "shared_block")


# ------------------------------------------------------------------ forward
def forward(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,
    image_embeds: torch.Tensor | None = None,
    *,
    collect_cache: bool = False,
    head_last_only: bool = False,
    param_shardings=None,
    _sink=None,
):
    """Full-sequence forward. Returns (logits [B,S,V] f32, aux_loss,
    kv_stacks). With ``collect_cache``, ``kv_stacks`` is the reference's:
    ``(k, v)`` each ``[L, B, S, kv, hd]`` (hybrid: the shared block's, ``[G,
    ...]``), or for a vlm ``((k, v) [G, per, ...], (ik, iv) [G, B, T_img,
    kv, hd])``; otherwise ``None``. A vlm needs ``image_embeds [B, T_img,
    D]``.

    ``head_last_only`` computes the unembedding for the final position only
    (prefill never needs [B, S, V] logits). With ``param_shardings``,
    ``params`` are this rank's shards (the module docstring); on the model
    axis the logits are the rank's vocabulary columns. ``_sink(i, k, v)``
    (dense and moe) takes each layer's K/V, every KV head over the whole
    sequence, in place of ``kv_stacks``."""
    ps = _shardings(params, param_shardings)
    b, s = tokens.shape
    par = _par(cfg, ps, s)
    pos_ctx = _pos_ctx(cfg, s, tokens.device, par)
    x = _embed(cfg, params, tokens, ps, par)
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

        self_block = _at_use(_decoder_block_full, _layer_places(ps, "self_layers", 2))
        cross_places = _layer_places(ps, "cross_layers")

        def cross_full(cfg, cb, x):
            return _cross_block_full(cfg, cb, x, _image_kv(cfg, cb, image_embeds))

        cross = _at_use(cross_full, cross_places)

        cross_layers = _unstack(params["cross_layers"], g)
        for gi, self_stack in enumerate(_unstack(params["self_layers"], g)):
            for i, blk in enumerate(_unstack(self_stack, per)):
                x, kv_i, a = run(self_block, cfg, blk, x, pos_ctx, return_kv=collect_cache)
                aux_total = aux_total + a
                if collect_cache:
                    self_kv[0][gi, i], self_kv[1][gi, i] = kv_i
            if collect_cache:
                cb = _use(cfg, cross_layers[gi], cross_places)
                ikv = _image_kv(cfg, cb, image_embeds)
                x = _cross_block_full(cfg, cb, x, ikv)
                image_kv[0][gi], image_kv[1][gi] = ikv
            else:
                x = run(cross, cfg, cross_layers[gi], x)
    elif cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        per = cfg.shared_attn_every
        ssm_cfg = cfg.replace(family="ssm")
        x0 = x
        if collect_cache:
            kvs = _kv_stacks((g,), b, s, cfg, x.dtype, x.device)
        shared = _use_keys(cfg, params, ps, _SHARED)
        group_block = _at_use(_decoder_block_full, _layer_places(ps, "mamba_groups", 2))
        for gi, group in enumerate(_unstack(params["mamba_groups"], g)):
            x, kv_g = run(_shared_block_full, cfg, shared, x, x0, pos_ctx,
                          return_kv=collect_cache)
            if collect_cache:
                kvs[0][gi], kvs[1][gi] = kv_g
            for blk in _unstack(group, per):
                x, _, _ = run(group_block, ssm_cfg, blk, x, pos_ctx)
        if "mamba_tail" in params:
            tail_block = _at_use(_decoder_block_full, _layer_places(ps, "mamba_tail"))
            for blk in _unstack(params["mamba_tail"], cfg.n_layers - g * per):
                x, _, _ = run(tail_block, ssm_cfg, blk, x, pos_ctx)
    else:
        collect = (collect_cache or _sink is not None) and cfg.family != "ssm"
        if collect and _sink is None:
            kvs = _kv_stacks((cfg.n_layers,), b, s, cfg, x.dtype, x.device)
        block = _at_use(_decoder_block_full, _layer_places(ps, "layers"))
        for i, blk in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x, kv_l, a = run(block, cfg, blk, x, pos_ctx, return_kv=collect)
            aux_total = aux_total + a
            if collect and _sink is not None:
                _sink(i, *kv_l)
            elif collect:
                kvs[0][i], kvs[1][i] = kv_l
    if head_last_only:
        x = _last_position(x, par)
        par = par and par._replace(seq=False)
    return _head(cfg, params, x, ps, par), aux_total, kvs


# ------------------------------------------------------------------ prefill
def prefill(
    cfg: ArchConfig,
    params: dict,
    tokens: torch.Tensor,
    image_embeds: torch.Tensor | None = None,
    *,
    max_seq_len: int | None = None,
    param_shardings=None,
):
    """Prefill: returns (last-token logits [B,V], cache).

    ``max_seq_len`` sizes the cache for the whole serving session (prompt +
    decode headroom); it defaults to the prompt length. The last
    ``min(s, Sc)`` prompt positions go to their ring slots; ssm and hybrid
    layers leave their final conv and SSM states. With ``param_shardings``,
    ``params`` are this rank's shards and ``tokens`` its rows; the cache
    holds those rows (``distributed.params.cache_shardings``' layout)."""
    b, s = tokens.shape
    max_seq_len = max_seq_len or s
    if cfg.family in ("ssm", "hybrid"):
        _check_family(cfg)
        return _prefill_recurrent(cfg, params, tokens, max_seq_len,
                                  _shardings(params, param_shardings))
    if _par(cfg, _shardings(params, param_shardings), s) is not None:
        return _prefill_model_axis(cfg, params, tokens, max_seq_len, param_shardings)
    logits, _, kvs = forward(cfg, params, tokens, image_embeds, collect_cache=True,
                             head_last_only=True, param_shardings=param_shardings)
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


def _prefill_model_axis(cfg, params, tokens, max_seq_len, param_shardings):
    """Prefill on the model axis: each layer's K/V go straight to the
    cache's slots this rank holds (``Sc/M`` of them), the logits are the
    rank's vocabulary columns."""
    b, s = tokens.shape
    cache = cache_mod.init_cache(cfg, b, max_seq_len, device=tokens.device)
    held = cache["slot_pos"].shape[1]
    sc = held * tp.model_size()
    positions = torch.arange(s - min(s, sc), s)  # on the host: the meta device has no mask
    slots = positions % sc - tp.model_rank() * held
    mine = (slots >= 0) & (slots < held)
    positions, slots = positions[mine].to(tokens.device), slots[mine].to(tokens.device)

    def sink(i, k, v):
        cache["k"][i][:, slots] = k[:, positions]
        cache["v"][i][:, slots] = v[:, positions]

    logits, _, _ = forward(cfg, params, tokens, head_last_only=True,
                           param_shardings=param_shardings, _sink=sink)
    cache["slot_pos"][:, slots] = positions.to(torch.int32)[None, :]
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


def _prefill_recurrent(cfg: ArchConfig, params: dict, tokens: torch.Tensor, max_seq_len: int,
                       ps=None):
    """ssm/hybrid prefill: the full-sequence forward, collecting final
    states (and the hybrid's shared-block K/V)."""
    b, s = tokens.shape
    pos_ctx = _pos_ctx(cfg, s, tokens.device)
    x = _embed(cfg, params, tokens, ps)
    cache = cache_mod.init_cache(cfg, b, max_seq_len, device=tokens.device)
    if cfg.family == "ssm":
        lp = _layer_places(ps, "layers")
        for i in range(cfg.n_layers):
            x = _mamba_prefill(cfg, _use(cfg, layer(params["layers"], i), lp), x,
                               cache["conv"][i], cache["ssm"][i])
        return _head(cfg, params, x[:, -1], ps), cache

    g = cfg.n_layers // cfg.shared_attn_every
    per = cfg.shared_attn_every
    sc = cache_mod.cache_seq_len(cfg, max_seq_len)
    x0 = x
    k_g, v_g = _kv_stacks((g,), b, s, cfg, x.dtype, x.device)
    mcache = cache["mamba"]
    shared = _use_keys(cfg, params, ps, _SHARED)
    gp, tail_p = _layer_places(ps, "mamba_groups", 2), _layer_places(ps, "mamba_tail")
    for gi in range(g):
        x, (k_g[gi], v_g[gi]) = _shared_block_full(cfg, shared, x, x0, pos_ctx, return_kv=True)
        group = layer(params["mamba_groups"], gi)
        for i in range(per):
            l = gi * per + i
            x = _mamba_prefill(cfg, _use(cfg, layer(group, i), gp), x, mcache["conv"][l],
                               mcache["ssm"][l])
    if "mamba_tail" in params:
        tcache = cache["mamba_tail"]
        for i in range(cfg.n_layers - g * per):
            x = _mamba_prefill(cfg, _use(cfg, layer(params["mamba_tail"], i), tail_p), x,
                               tcache["conv"][i], tcache["ssm"][i])
    kv = dict(cache["shared"], slot_pos=cache["slot_pos"])
    _place(kv, k_g, v_g, s, sc)
    return _head(cfg, params, x[:, -1], ps), cache


# ------------------------------------------------------------------ decode
def _attn_decode_tp_(cfg: ArchConfig, p: dict, x, k_cache, v_cache, slot_pos, pos: int,
                     par: _Par):
    """:func:`_attn_decode_` on the model axis, over the rank's ``Sc/M``
    slots: the new token's K/V (every KV head) go into its slot on the rank
    that holds it, each rank's partial softmax over its slots is combined
    over the ranks, and the rank's heads go through ``wo``."""
    b, d = x.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    hl = cfg.n_heads // par.m
    expand = _should_expand_gqa(cfg)
    wk, wv = _kv_weights(cfg, p, x.dtype, expand)
    kl = kv if expand else kv // par.m
    q = matmul(x, _wt(cfg, p["wq"], x.dtype)).reshape(b, 1, hl, hd)
    k = matmul(x, wk).reshape(b, 1, kl, hd)
    v = matmul(x, wv).reshape(b, 1, kl, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    posv = torch.tensor([pos], device=x.device)
    q = tp.gather_seq(rope(q, posv, cfg.rope_theta), 2)
    k = rope(k, posv, cfg.rope_theta)
    if not expand:
        k, v = tp.gather_seq(k, 2), tp.gather_seq(v, 2)
    held = k_cache.shape[1]
    slot = pos % (held * par.m) - tp.model_rank() * held
    if 0 <= slot < held:
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
    part = decode_attention_partial(q[:, 0], k_cache, v_cache, slot_pos, pos, window=cfg.window)
    o = decode_combine(tp.gather_seq(part[None], 0)).to(x.dtype)  # [B, H, hd]
    lo = tp.model_rank() * hl
    partial = _matmul_f32(o[:, lo:lo + hl].reshape(b, hl * hd), _wt(cfg, p["wo"], x.dtype))
    return tp.all_sum(partial, x.dtype)


def _block_decode_(cfg: ArchConfig, blk: dict, x, kc, vc, slot_pos, pos: int,
                   par: _Par | None = None):
    """:func:`dense_block_decode` writing the new K/V into ``kc``/``vc`` in
    place; returns the layer's output."""
    h = rmsnorm(x, blk["ln1"])
    if par is None:
        x = x + _attn_decode_(cfg, blk["attn"], h, kc, vc, slot_pos, pos)
    else:
        x = x + _attn_decode_tp_(cfg, blk["attn"], h, kc, vc, slot_pos, pos, par)
    if cfg.family == "moe":
        f, _ = moe.moe_ffn(cfg, blk["moe"], rmsnorm(x, blk["ln2"])[:, None, :], par)
        f = f[:, 0]
    elif par is None:
        f = _mlp(cfg, blk["mlp"], rmsnorm(x, blk["ln2"]))
    else:
        f = _mlp_tp(cfg, blk["mlp"], rmsnorm(x, blk["ln2"]), par)
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


def _decode(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, pos: int, ps=None):
    """One decode step writing the token's K/V, slot position and recurrent
    states into ``cache``'s own tensors; returns the logits. The generation
    loops' step (the reference donates the cache there). ``ps``: the
    placements of ``params``' shards (``_shardings``), or ``None``."""
    par = _par(cfg, ps, 1)
    x = _embed(cfg, params, token, ps, par)  # [B, D]
    if cfg.family == "ssm":
        lp = _layer_places(ps, "layers")
        for i in range(cfg.n_layers):
            x = _mamba_block_decode_(cfg, _use(cfg, layer(params["layers"], i), lp), x,
                                     cache["conv"][i], cache["ssm"][i])
        return _head(cfg, params, x, ps)
    sc = cache["slot_pos"].shape[1]
    slot_pos = cache["slot_pos"]
    if par is None:
        slot_pos[:, pos % sc] = pos  # the token sees itself
    elif 0 <= pos % (sc * par.m) - tp.model_rank() * sc < sc:  # on the rank holding its slot
        slot_pos[:, pos % (sc * par.m) - tp.model_rank() * sc] = pos
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        per = cfg.shared_attn_every
        x0 = x
        sp = _use_keys(cfg, params, ps, _SHARED)
        blk = sp["shared_block"]
        gp, tail_p = _layer_places(ps, "mamba_groups", 2), _layer_places(ps, "mamba_tail")
        mcache, shared = cache["mamba"], cache["shared"]
        for gi in range(g):
            # the shared block (single token)
            h = matmul(torch.cat([x, x0], dim=-1), _wt(cfg, sp["shared_in"], x.dtype))
            h = h + _attn_decode_(cfg, blk["attn"], rmsnorm(h, blk["ln1"]), shared["k"][gi],
                                  shared["v"][gi], slot_pos, pos)
            h = h + _mlp(cfg, blk["mlp"], rmsnorm(h, blk["ln2"]))
            x = x + h
            group = layer(params["mamba_groups"], gi)
            for i in range(per):
                l = gi * per + i
                x = _mamba_block_decode_(cfg, _use(cfg, layer(group, i), gp), x,
                                         mcache["conv"][l], mcache["ssm"][l])
        if "mamba_tail" in params:
            tcache = cache["mamba_tail"]
            for i in range(cfg.n_layers - g * per):
                x = _mamba_block_decode_(cfg, _use(cfg, layer(params["mamba_tail"], i), tail_p), x,
                                         tcache["conv"][i], tcache["ssm"][i])
        return _head(cfg, params, x, ps)
    k_all, v_all = cache["k"], cache["v"]
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        per = cfg.cross_attn_every - 1
        sp, cp = _layer_places(ps, "self_layers", 2), _layer_places(ps, "cross_layers")
        for gi in range(g):
            self_stack = layer(params["self_layers"], gi)
            for i in range(per):
                l = gi * per + i
                x = _block_decode_(cfg, _use(cfg, layer(self_stack, i), sp), x, k_all[l],
                                   v_all[l], slot_pos, pos)
            x = _cross_block_decode(cfg, _use(cfg, layer(params["cross_layers"], gi), cp), x,
                                    cache["xk"][gi], cache["xv"][gi])
        return _head(cfg, params, x, ps)
    lp = _layer_places(ps, "layers")
    for i in range(cfg.n_layers):
        x = _block_decode_(cfg, _use(cfg, layer(params["layers"], i), lp), x, k_all[i], v_all[i],
                           slot_pos, pos, par)
    return _head(cfg, params, x, ps, par)


def _clone_tree(tree: dict) -> dict:
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def decode(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, pos, *,
           param_shardings=None):
    """One decode step. token [B], pos an int or a 0-d tensor →
    (logits [B,V], new cache); ``cache`` stays as it was. With
    ``param_shardings``, ``params`` are this rank's shards, and ``cache``
    and ``token`` its rows (on the model axis, the cache its ``Sc/M`` slots
    and the logits its vocabulary columns)."""
    ps = _shardings(params, param_shardings)
    new = _clone_tree(cache)
    return _decode(cfg, params, new, token, int(pos), ps), new
