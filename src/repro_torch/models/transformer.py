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

On a mesh whose ``"model"`` dimension has M > 1 ranks every family runs
the reference's model axis, Megatron-style (``distributed.tp``). Between
blocks the residual stream is ``[B/Dp, S/M, D]`` a rank where M divides
S > 1, else whole on the model ranks (the reference's ``shard(x, "batch",
"seq", None)``). Attention and the MLP gather the sequence before their
column-parallel products (``wq``/``wk``/``wv``, ``w1``/``w3``: H/M heads,
F/M columns a rank) and add the row-parallel ``wo``/``w2`` partials over
the ranks in f32, each rank keeping its part of the sequence. Where KV
heads do not divide M (the reference's ``_should_expand_gqa``)
``wk``/``wv`` are gathered whole and each rank takes its heads' repeats.
Where M does not divide a dimension (the heads, ``d_ff``, a Mamba layer's
heads), the reference's ``logical_to_spec`` drops the axis and keeps the
dimension whole: the block runs whole on every rank, its weights gathered
where they are stored split along another width (musicgen-medium's
``wq``: 1,536 columns over 16 ranks, 1.5 heads a rank), and its output is
whole, with no partials to add. A Mamba layer (``mamba2``) splits its
heads, its gated norm adding the rows' sums of squares over the ranks and
``out_proj`` row-parallel; the hybrid's shared block projects
``concat(h, x0)`` with ``shared_in`` gathered whole once a pass, then runs
as a dense block; the vlm's cross layers split their query heads over the
image K/V (GQA expanded as in self-attention) with ``wo`` row-parallel.
The embedding is vocab-parallel (each rank looks up the ids in its rows,
the ranks' rows added), the head too: :func:`forward` returns the rank's
``Vp/M`` columns of the logits and ``train_step.cross_entropy`` reduces
its row max, sum and label logit over the ranks. A KV cache holds ``Sc/M``
slots a rank where M divides ``Sc``, else all of them on every rank
(``cache.init_cache``); decode writes the new token's K/V into its slot on
the rank that holds it and combines the ranks' partial softmaxes over
their slots in rank order (flash decoding), or attends over a whole cache
on every rank. A vlm's image K/V stay whole. The MoE runs the reference's
``ep``, ``ep_split`` or ``tp`` island (``moe.moe_ffn``).

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
    """The model axis of a step: its ``m`` ranks, whether the residual
    stream is split on the sequence over them, and which of the config's
    widths split over them (``tp.Splits``: a width that does not runs
    whole on every rank)."""

    m: int
    seq: bool
    heads: bool
    kv: bool
    ff: bool
    ssm: bool
    shared_ff: bool


def _par(cfg: ArchConfig, ps, s: int) -> _Par | None:
    """The model axis of a step over ``s`` positions (``None`` without
    placements or a model axis). Raises where a width must split and does
    not: the routed experts' ``moe_d_ff`` in the ``ep_split`` and ``tp``
    islands (the reference's ``shard_map`` takes it split there, and fails
    too), and the padded vocabulary, which the port's vocab-parallel
    embedding and head take split (a multiple of 256: any M dividing 256
    splits it)."""
    if ps is None or not tp.active():
        return None
    m = tp.model_size()
    sizes = {"vocab_padded": cfg.vocab_padded}
    if cfg.family == "moe" and moe.moe_mode(cfg.n_experts, m) != "ep":
        sizes["moe_d_ff"] = cfg.moe_d_ff or cfg.d_ff
    bad = {k: v for k, v in sizes.items() if v % m}
    if bad:
        raise ValueError(f"{cfg.name}: {bad} do not split over the {m} ranks of 'model'")
    return _Par(m, s > 1 and tp.divides(s), *tp.splits(cfg))


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


def _whole_to_residual(out: torch.Tensor, par: _Par) -> torch.Tensor:
    """A product computed whole on every model rank, into the residual
    stream's layout: the rank's part of the sequence where it splits."""
    return tp._part(out, 1) if par.seq else out


def _kv_weights(cfg, p, dtype, expand: bool):
    """``wk``/``wv`` for use: whole (gathered over the model ranks where
    they are split) when GQA is expanded, else the rank's KV heads."""
    wk, wv = _wt(cfg, p["wk"], dtype), _wt(cfg, p["wv"], dtype)
    if expand:
        size = cfg.n_kv_heads * cfg.hd
        wk, wv = tp.whole(wk, 1, size), tp.whole(wv, 1, size)
    return wk, wv


def _whole_attn(cfg, p, dtype, keys=("wq", "wk", "wv", "wo")) -> dict:
    """An attention block's weights ``keys`` whole for use where its heads
    do not split over the model ranks: each gathered where it is stored
    split (its width may divide where its heads do not)."""
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    where = {"wq": (1, hq), "wk": (1, hkv), "wv": (1, hkv), "wo": (0, hq)}
    return dict(p, **{k: tp.whole(_wt(cfg, p[k], dtype), *where[k]) for k in keys})


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
    if not par.heads:  # every head on every rank, the output whole
        out = _attn_full(cfg, _whole_attn(cfg, p, h.dtype), h, (positions, tables, None),
                         return_kv=return_kv)
        o, kv_out = out if return_kv else (out, None)
        o = _whole_to_residual(o, par)
        return (o, kv_out) if return_kv else o
    b, s, _ = h.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    hl = cfg.n_heads // par.m
    # every KV head's K/V on each rank, which takes its heads' repeats, where
    # the KV heads do not split (``cfg.expand_gqa`` moves the reference's
    # layout only: each rank's heads see the same K/V either way)
    expand = not par.kv
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
    residual stream (normed). Whole on every rank where M does not divide
    ``d_ff`` (the weights are stored whole then)."""
    h = tp.gather_seq(x) if par.seq else x
    if not par.ff:
        return _whole_to_residual(_mlp(cfg, p, h), par)
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


def _mlp_on(cfg, p, x, par: _Par | None):
    """The SwiGLU MLP, on the model axis where ``par`` is given."""
    return _mlp(cfg, p, x) if par is None else _mlp_tp(cfg, p, x, par)


def _ffn(cfg: ArchConfig, block: dict, x, par: _Par | None = None):
    """Post-attention FFN (dense or MoE). Returns (out, aux_loss)."""
    h = rmsnorm(x, block["ln2"])
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, block["moe"], h, par)
    return _mlp_on(cfg, block["mlp"], h, par), torch.zeros((), dtype=torch.float32,
                                                           device=x.device)


def _mamba_out(cfg, out, par: _Par, dtype):
    """A Mamba layer's output on the model axis into the residual stream's
    layout: the ranks' f32 partials added where its heads split, else the
    whole output."""
    if par.ssm:
        return _to_residual(out, par, dtype)
    return _whole_to_residual(out, par)


def _mamba_full(cfg, p, h, par: _Par | None, *, return_state=False):
    """A Mamba layer over the normed residual stream ``h`` (on the model
    axis the rank's part: the mixer scans the sequence gathered whole).
    Returns its output and, with ``return_state``, its final states."""
    if par is None:
        return mamba2.mamba_forward(cfg, p, h, return_state=return_state)
    out = mamba2.mamba_forward(cfg, p, tp.gather_seq(h) if par.seq else h,
                               return_state=return_state, model_axis=True)
    if return_state:
        return _mamba_out(cfg, out[0], par, h.dtype), out[1]
    return _mamba_out(cfg, out, par, h.dtype)


def _decoder_block_full(cfg, block, x, pos_ctx, *, return_kv=False):
    if cfg.family == "ssm":
        x = x + _mamba_full(cfg, block["mamba"], rmsnorm(x, block["ln1"]), pos_ctx[2])
        return shard(x, "batch", "seq", None), None, 0.0
    o = _attn_full(cfg, block["attn"], rmsnorm(x, block["ln1"]), pos_ctx, return_kv=return_kv)
    o, kvs = o if return_kv else (o, None)
    x = x + o
    f, aux = _ffn(cfg, block, x, pos_ctx[2])
    return shard(x + f, "batch", "seq", None), kvs, aux


def _cross_block_full(cfg, block, x, image_kv, par: _Par | None = None):
    """Gated cross-attention layer over the image K/V (GQA layout)."""
    if par is not None:
        return _cross_block_tp(cfg, block, x, image_kv, par)
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


def _cross_block_tp(cfg, block, x, image_kv, par: _Par):
    """:func:`_cross_block_full` on the model axis: ``x`` the rank's part of
    the residual stream, ``image_kv`` the rank's KV heads (every KV head
    where they do not split, and the cache's in decode). The query heads split over the ranks with
    ``wo`` row-parallel, or run whole where M does not divide them."""
    p = block["attn"]
    hidden = rmsnorm(x, block["ln1"])
    hidden = tp.gather_seq(hidden) if par.seq else hidden
    b, s, _ = hidden.shape
    ik, iv = image_kv
    if not par.heads:
        w = _whole_attn(cfg, p, x.dtype, ("wq", "wo"))
        q = matmul(hidden, w["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
        o = _whole_to_residual(matmul(cross_attention(q, ik, iv).reshape(b, s, -1), w["wo"]), par)
    else:
        hl = cfg.n_heads // par.m
        q = matmul(hidden, _wt(cfg, p["wq"], x.dtype)).reshape(b, s, hl, cfg.hd)
        if ik.shape[2] == cfg.n_kv_heads:  # every KV head (the cache's): the rank's heads' repeats
            ik, iv = _rank_heads(cfg, ik, iv)
        o = cross_attention(q, ik, iv).reshape(b, s, hl * cfg.hd)
        o = _to_residual(_matmul_f32(o, _wt(cfg, p["wo"], x.dtype)), par, x.dtype)
    x = x + torch.tanh(block["gate_attn"]).to(x.dtype) * o
    f = _mlp_tp(cfg, block["mlp"], rmsnorm(x, block["ln2"]), par)
    return x + torch.tanh(block["gate_mlp"]).to(x.dtype) * f


def _image_kv(cfg, block, image_embeds, par: _Par | None = None):
    """Project the (stubbed) image embeddings to this cross layer's K/V, in
    the GQA (cache) layout: ``[B, T_img, kv, hd]`` each. On the model axis,
    the rank's KV heads where its query heads and the KV heads split, else
    every KV head (the weights gathered whole)."""
    b, t, _ = image_embeds.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    p = block["attn"]
    dtype = image_embeds.dtype
    if par is None:
        wk, wv = _wt(cfg, p["wk"], dtype), _wt(cfg, p["wv"], dtype)
    elif not par.heads:
        w = _whole_attn(cfg, p, dtype, ("wk", "wv"))
        wk, wv = w["wk"], w["wv"]
    else:
        wk, wv = _kv_weights(cfg, p, dtype, not par.kv)
    ik = matmul(image_embeds, wk).reshape(b, t, -1, hd)
    iv = matmul(image_embeds, wv).reshape(b, t, -1, hd)
    return ik, iv


def _expand_kv(cfg, k, v):
    if _should_expand_gqa(cfg):
        g = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return k, v


def _shared_block_full(cfg, params, x, x0, pos_ctx, *, return_kv=False):
    """Zamba2's shared attention block on concat(h, embeddings). On the
    model axis ``x``, ``x0`` and the block's stream are the rank's part of
    the sequence, ``params["shared_in"]`` whole (:func:`_shared`)."""
    block = params["shared_block"]
    cat = torch.cat([x, x0], dim=-1)
    h = matmul(cat, _wt(cfg, params["shared_in"], x.dtype))
    o = _attn_full(cfg, block["attn"], rmsnorm(h, block["ln1"]), pos_ctx, return_kv=return_kv)
    o, kvs = o if return_kv else (o, None)
    h = h + o
    h = h + _mlp_on(cfg, block["mlp"], rmsnorm(h, block["ln2"]), pos_ctx[2])
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
    ``places`` (``None``: takes it as it is): passed to ``run``, the gather
    is inside the checkpoint. It runs on the current mesh wherever it is
    called: the backward recomputes a checkpointed block on the autograd
    engine's thread, and a CUDA backward's thread does not see the
    caller's (thread-local) mesh, which the block's gathers and the model
    axis's collectives need."""
    mesh = current_mesh()
    if mesh is None:
        return fn

    def gathered(cfg, block, *args, **kw):
        with use_mesh(mesh):
            return fn(cfg, block if places is None else fsdp.gather_tree(cfg, block, places),
                      *args, **kw)

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


def _shared(cfg, params: dict, ps, par: _Par | None) -> dict:
    """The hybrid's shared block and input projection for use, gathered
    once a pass: over the batch axes, and on the model axis ``shared_in``
    whole (its columns are stored split over the model ranks)."""
    sp = _use_keys(cfg, params, ps, _SHARED)
    if par is not None:
        sp["shared_in"] = tp.whole(_wt(cfg, sp["shared_in"], cfg.dtype), 1, cfg.d_model)
    return sp


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
    (dense, moe and audio, and a vlm's self layers, ``i`` counted over
    them) takes each attention layer's K/V, every KV head over the whole
    sequence, in place of ``kv_stacks``; a vlm's cross layer ``g`` gives
    its image K/V, every KV head, to ``_sink(("image", g), ik, iv)``."""
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
        collect = collect_cache or _sink is not None
        if collect and _sink is None:
            t = image_embeds.shape[1]
            self_kv = _kv_stacks((g, per), b, s, cfg, x.dtype, x.device)
            image_kv = _kv_stacks((g,), b, t, cfg, image_embeds.dtype, x.device)
            kvs = (self_kv, image_kv)

        self_block = _at_use(_decoder_block_full, _layer_places(ps, "self_layers", 2))
        cross_places = _layer_places(ps, "cross_layers")

        def cross_full(cfg, cb, x):
            return _cross_block_full(cfg, cb, x, _image_kv(cfg, cb, image_embeds, par), par)

        cross = _at_use(cross_full, cross_places)

        cross_layers = _unstack(params["cross_layers"], g)
        for gi, self_stack in enumerate(_unstack(params["self_layers"], g)):
            for i, blk in enumerate(_unstack(self_stack, per)):
                x, kv_i, a = run(self_block, cfg, blk, x, pos_ctx, return_kv=collect)
                aux_total = aux_total + a
                if _sink is not None:
                    _sink(gi * per + i, *kv_i)
                elif collect:
                    self_kv[0][gi, i], self_kv[1][gi, i] = kv_i
            if collect:
                cb = _use(cfg, cross_layers[gi], cross_places)
                ikv = _image_kv(cfg, cb, image_embeds, par)
                x = _cross_block_full(cfg, cb, x, ikv, par)
                if _sink is not None:  # every KV head: gathered where they are the rank's
                    _sink(("image", gi), *(tp.whole(t, 2, cfg.n_kv_heads) for t in ikv))
                else:
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
        shared = _shared(cfg, params, ps, par)
        shared_block = _at_use(_shared_block_full, None)
        group_block = _at_use(_decoder_block_full, _layer_places(ps, "mamba_groups", 2))
        for gi, group in enumerate(_unstack(params["mamba_groups"], g)):
            x, kv_g = run(shared_block, cfg, shared, x, x0, pos_ctx, return_kv=collect_cache)
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
    ps = _shardings(params, param_shardings)
    par = _par(cfg, ps, s)
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_recurrent(cfg, params, tokens, max_seq_len, ps, par)
    if par is not None:
        return _prefill_model_axis(cfg, params, tokens, image_embeds, max_seq_len,
                                   param_shardings)
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


def _held_positions(sc: int, s: int, device):
    """``(positions, slots)``: the last ``min(s, sc)`` prompt positions
    whose ring slots (of ``sc``) this model rank holds
    (``cache.held_slots``), and those slots in its part of the cache."""
    held = cache_mod.held_slots(sc)
    positions = torch.arange(s - min(s, sc), s)  # on the host: the meta device has no mask
    slots = positions % sc - (tp.model_rank() * held if held < sc else 0)
    mine = (slots >= 0) & (slots < held)
    return positions[mine].to(device), slots[mine].to(device)


def _prefill_model_axis(cfg, params, tokens, image_embeds, max_seq_len, param_shardings):
    """Prefill on the model axis: each attention layer's K/V go straight to
    the cache's slots this rank holds, a vlm's image K/V whole; the logits
    are the rank's vocabulary columns."""
    b, s = tokens.shape
    cache = cache_mod.init_cache(cfg, b, max_seq_len, device=tokens.device)
    positions, slots = _held_positions(cache_mod.cache_seq_len(cfg, max_seq_len), s,
                                       tokens.device)

    def sink(i, k, v):
        if isinstance(i, tuple):  # a vlm cross layer's image K/V
            cache["xk"][i[1]], cache["xv"][i[1]] = k, v
            return
        cache["k"][i][:, slots] = k[:, positions]
        cache["v"][i][:, slots] = v[:, positions]

    logits, _, _ = forward(cfg, params, tokens, image_embeds, head_last_only=True,
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


def _mamba_prefill(cfg, blk, x, conv, ssm, par: _Par | None = None):
    """One ssm layer over the prompt, its final states written into
    ``conv``/``ssm`` (the layer's cache rows); returns the layer's output."""
    out, (c, st) = _mamba_full(cfg, blk["mamba"], rmsnorm(x, blk["ln1"]), par, return_state=True)
    conv.copy_(c)
    ssm.copy_(st)
    return x + out


def _last_logits(cfg, params, x, ps, par: _Par | None):
    """The last position's logits ``[B, Vp]`` of the residual stream ``x``
    (on the model axis, the rank's vocabulary columns)."""
    if par is None:
        return _head(cfg, params, x[:, -1], ps)
    return _head(cfg, params, _last_position(x, par)[:, 0], ps, par._replace(seq=False))


def _prefill_recurrent(cfg: ArchConfig, params: dict, tokens: torch.Tensor, max_seq_len: int,
                       ps=None, par: _Par | None = None):
    """ssm/hybrid prefill: the full-sequence forward, collecting final
    states (and the hybrid's shared-block K/V: on the model axis straight
    into the slots this rank holds)."""
    b, s = tokens.shape
    pos_ctx = _pos_ctx(cfg, s, tokens.device, par)
    x = _embed(cfg, params, tokens, ps, par)
    cache = cache_mod.init_cache(cfg, b, max_seq_len, device=tokens.device)
    if cfg.family == "ssm":
        lp = _layer_places(ps, "layers")
        for i in range(cfg.n_layers):
            x = _mamba_prefill(cfg, _use(cfg, layer(params["layers"], i), lp), x,
                               cache["conv"][i], cache["ssm"][i], par)
        return _last_logits(cfg, params, x, ps, par), cache

    g = cfg.n_layers // cfg.shared_attn_every
    per = cfg.shared_attn_every
    sc = cache_mod.cache_seq_len(cfg, max_seq_len)
    x0 = x
    if par is None:
        k_g, v_g = _kv_stacks((g,), b, s, cfg, x.dtype, x.device)
    else:
        positions, slots = _held_positions(sc, s, tokens.device)
    mcache = cache["mamba"]
    shared = _shared(cfg, params, ps, par)
    gp, tail_p = _layer_places(ps, "mamba_groups", 2), _layer_places(ps, "mamba_tail")
    for gi in range(g):
        x, (k, v) = _shared_block_full(cfg, shared, x, x0, pos_ctx, return_kv=True)
        if par is None:
            k_g[gi], v_g[gi] = k, v
        else:
            cache["shared"]["k"][gi][:, slots] = k[:, positions]
            cache["shared"]["v"][gi][:, slots] = v[:, positions]
        group = layer(params["mamba_groups"], gi)
        for i in range(per):
            l = gi * per + i
            x = _mamba_prefill(cfg, _use(cfg, layer(group, i), gp), x, mcache["conv"][l],
                               mcache["ssm"][l], par)
    if "mamba_tail" in params:
        tcache = cache["mamba_tail"]
        for i in range(cfg.n_layers - g * per):
            x = _mamba_prefill(cfg, _use(cfg, layer(params["mamba_tail"], i), tail_p), x,
                               tcache["conv"][i], tcache["ssm"][i], par)
    if par is None:
        kv = dict(cache["shared"], slot_pos=cache["slot_pos"])
        _place(kv, k_g, v_g, s, sc)
    else:
        cache["slot_pos"][:, slots] = positions.to(torch.int32)[None, :]
    return _last_logits(cfg, params, x, ps, par), cache


# ------------------------------------------------------------------ decode
def _attn_decode_tp_(cfg: ArchConfig, p: dict, x, k_cache, v_cache, slot_pos, pos: int,
                     par: _Par, slot: int | None, whole_cache: bool):
    """:func:`_attn_decode_` on the model axis. The new token's K/V (every
    KV head) go into ``slot`` of the rank's cache (``None`` where another
    rank holds it). Over a cache split on its slots each rank's partial
    softmax over its slots is combined over the ranks; over a whole cache
    each rank attends to all of it. The rank's heads go through ``wo``, the
    partials added over the ranks, or every head where M does not divide
    them (the weights gathered whole, the output whole)."""
    b, d = x.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    heads = par.heads
    if heads:
        hl = cfg.n_heads // par.m
        expand = not par.kv
        wq = _wt(cfg, p["wq"], x.dtype)
        wk, wv = _kv_weights(cfg, p, x.dtype, expand)
        kl = kv if expand else kv // par.m
    else:
        w = _whole_attn(cfg, p, x.dtype)
        wq, wk, wv = w["wq"], w["wk"], w["wv"]
        hl, kl = cfg.n_heads, kv
    q = matmul(x, wq).reshape(b, 1, hl, hd)
    k = matmul(x, wk).reshape(b, 1, kl, hd)
    v = matmul(x, wv).reshape(b, 1, kl, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    posv = torch.tensor([pos], device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    if heads:
        q = tp.gather_seq(q, 2)
        if not expand:
            k, v = tp.gather_seq(k, 2), tp.gather_seq(v, 2)
    if slot is not None:
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
    if whole_cache:
        o = decode_attention(q[:, 0], k_cache, v_cache, slot_pos, pos, window=cfg.window)
    else:
        part = decode_attention_partial(q[:, 0], k_cache, v_cache, slot_pos, pos,
                                        window=cfg.window)
        o = decode_combine(tp.gather_seq(part[None], 0)).to(x.dtype)  # [B, H, hd]
    if not heads:
        return matmul(o.reshape(b, cfg.n_heads * hd), w["wo"])
    lo = tp.model_rank() * hl
    partial = _matmul_f32(o[:, lo:lo + hl].reshape(b, hl * hd), _wt(cfg, p["wo"], x.dtype))
    return tp.all_sum(partial, x.dtype)


def _attn_decode_on(cfg, p, x, kc, vc, slot_pos, pos: int, par: _Par | None, at):
    """The single-token attention sub-block, on the model axis where
    ``par`` is given (``at``: the rank's slot for the token and whether its
    cache is whole)."""
    if par is None:
        return _attn_decode_(cfg, p, x, kc, vc, slot_pos, pos)
    return _attn_decode_tp_(cfg, p, x, kc, vc, slot_pos, pos, par, *at)


def _block_decode_(cfg: ArchConfig, blk: dict, x, kc, vc, slot_pos, pos: int,
                   par: _Par | None = None, at=None):
    """:func:`dense_block_decode` writing the new K/V into ``kc``/``vc`` in
    place; returns the layer's output."""
    x = x + _attn_decode_on(cfg, blk["attn"], rmsnorm(x, blk["ln1"]), kc, vc, slot_pos, pos, par,
                            at)
    if cfg.family == "moe":
        f, _ = moe.moe_ffn(cfg, blk["moe"], rmsnorm(x, blk["ln2"])[:, None, :], par)
        f = f[:, 0]
    else:
        f = _mlp_on(cfg, blk["mlp"], rmsnorm(x, blk["ln2"]), par)
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


def _mamba_block_decode_(cfg, blk, x, conv, ssm, par: _Par | None = None):
    """One ssm layer for a single token, its states updated in place in
    ``conv``/``ssm``; returns the layer's output."""
    h = rmsnorm(x, blk["ln1"])
    if par is None:
        out, (c, st) = mamba2.mamba_decode(cfg, blk["mamba"], h, conv, ssm)
    else:
        out, (c, st) = mamba2.mamba_decode(cfg, blk["mamba"], h, conv, ssm, model_axis=True)
        out = _mamba_out(cfg, out, par, x.dtype)
    conv.copy_(c)
    ssm.copy_(st)
    return x + out


def _cross_block_decode(cfg, blk, x, xk, xv, par: _Par | None = None):
    """The gated cross layer for a single token over the cached image K/V."""
    if par is not None:
        return _cross_block_tp(cfg, blk, x[:, None], (xk, xv), par)[:, 0]
    p = blk["attn"]
    h = rmsnorm(x, blk["ln1"])
    q = matmul(h, _wt(cfg, p["wq"], x.dtype)).reshape(x.shape[0], 1, cfg.n_heads, cfg.hd)
    o = cross_attention(q, xk, xv)[:, 0].reshape(x.shape[0], -1)
    x = x + torch.tanh(blk["gate_attn"]).to(x.dtype) * matmul(o, _wt(cfg, p["wo"], x.dtype))
    f = _mlp(cfg, blk["mlp"], rmsnorm(x, blk["ln2"]))
    return x + torch.tanh(blk["gate_mlp"]).to(x.dtype) * f


def _decode(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, pos: int, ps=None,
            max_seq_len: int | None = None):
    """One decode step writing the token's K/V, slot position and recurrent
    states into ``cache``'s own tensors; returns the logits. The generation
    loops' step (the reference donates the cache there). ``ps``: the
    placements of ``params``' shards (``_shardings``), or ``None``;
    ``max_seq_len``: :func:`decode`'s."""
    par = _par(cfg, ps, 1)
    x = _embed(cfg, params, token, ps, par)  # [B, D]
    if cfg.family == "ssm":
        lp = _layer_places(ps, "layers")
        for i in range(cfg.n_layers):
            x = _mamba_block_decode_(cfg, _use(cfg, layer(params["layers"], i), lp), x,
                                     cache["conv"][i], cache["ssm"][i], par)
        return _head(cfg, params, x, ps, par)
    held = cache["slot_pos"].shape[1]
    slot_pos = cache["slot_pos"]
    at = None
    if par is None:
        slot_pos[:, pos % held] = pos  # the token sees itself
    else:  # on the rank holding its slot
        sc = cache_mod.cache_slots(cfg, held, max_seq_len)
        whole = held == sc
        slot = pos % sc - (0 if whole else tp.model_rank() * held)
        at = (slot if 0 <= slot < held else None, whole)
        if at[0] is not None:
            slot_pos[:, slot] = pos
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.shared_attn_every
        per = cfg.shared_attn_every
        x0 = x
        sp = _shared(cfg, params, ps, par)
        blk = sp["shared_block"]
        gp, tail_p = _layer_places(ps, "mamba_groups", 2), _layer_places(ps, "mamba_tail")
        mcache, shared = cache["mamba"], cache["shared"]
        for gi in range(g):
            # the shared block (single token)
            h = matmul(torch.cat([x, x0], dim=-1), _wt(cfg, sp["shared_in"], x.dtype))
            h = h + _attn_decode_on(cfg, blk["attn"], rmsnorm(h, blk["ln1"]), shared["k"][gi],
                                    shared["v"][gi], slot_pos, pos, par, at)
            h = h + _mlp_on(cfg, blk["mlp"], rmsnorm(h, blk["ln2"]), par)
            x = x + h
            group = layer(params["mamba_groups"], gi)
            for i in range(per):
                l = gi * per + i
                x = _mamba_block_decode_(cfg, _use(cfg, layer(group, i), gp), x,
                                         mcache["conv"][l], mcache["ssm"][l], par)
        if "mamba_tail" in params:
            tcache = cache["mamba_tail"]
            for i in range(cfg.n_layers - g * per):
                x = _mamba_block_decode_(cfg, _use(cfg, layer(params["mamba_tail"], i), tail_p), x,
                                         tcache["conv"][i], tcache["ssm"][i], par)
        return _head(cfg, params, x, ps, par)
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
                                   v_all[l], slot_pos, pos, par, at)
            x = _cross_block_decode(cfg, _use(cfg, layer(params["cross_layers"], gi), cp), x,
                                    cache["xk"][gi], cache["xv"][gi], par)
        return _head(cfg, params, x, ps, par)
    lp = _layer_places(ps, "layers")
    for i in range(cfg.n_layers):
        x = _block_decode_(cfg, _use(cfg, layer(params["layers"], i), lp), x, k_all[i], v_all[i],
                           slot_pos, pos, par, at)
    return _head(cfg, params, x, ps, par)


def _clone_tree(tree: dict) -> dict:
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def decode(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, pos, *,
           param_shardings=None, max_seq_len: int | None = None):
    """One decode step. token [B], pos an int or a 0-d tensor →
    (logits [B,V], new cache); ``cache`` stays as it was. With
    ``param_shardings``, ``params`` are this rank's shards, and ``cache``
    and ``token`` its rows (on the model axis, the cache its slots and the
    logits its vocabulary columns).

    ``max_seq_len`` is the session's length that sized the cache
    (``prefill``'s, ``init_cache``'s). On the model axis a cache of ``Sc``
    slots is held ``Sc/M`` a rank where M divides ``Sc`` and whole on
    every rank where it does not; where M does not divide a rank's count of
    slots, that count cannot tell the two apart, and decode raises unless
    ``max_seq_len`` is given (``cache.cache_slots``)."""
    ps = _shardings(params, param_shardings)
    new = _clone_tree(cache)
    return _decode(cfg, params, new, token, int(pos), ps, max_seq_len), new
