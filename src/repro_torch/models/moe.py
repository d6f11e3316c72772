"""Mixture-of-Experts FFN with capacity-bounded dispatch (GShard-style).
Counterpart of ``repro.models.moe``.

Tokens are sorted by expert (stable), packed into a capacity-bounded
``[E, C, D]`` buffer, run through every expert's SwiGLU, and gathered back
per token, gated. Tokens over capacity are dropped (the GShard convention);
the router is top-k over the softmax with renormalised probabilities, plus
the load-balance aux loss. Without a model axis ``moe_ffn`` takes the local
path (the reference's ``mesh is None`` branch). On a ``"data"`` mesh the
reference runs its ``"ep"`` island at one model rank, which is that path
on the rank's tokens (capacity sized from them) with the expert weights
gathered and ``aux`` averaged over the ranks: under the port's FSDP step
the layer gets the rank's rows and its gathered weights (``transformer``),
and the step averages the loss, ``aux`` included, over the ranks
(``train.train_step``).

On a model axis of M > 1 ranks ``moe_ffn`` runs the reference's islands
(``moe.py:137-228, 249-368`` there) as plain functions with the
collectives of ``distributed.tp``, chosen by :func:`moe_mode`:

* ``ep`` (M divides E): each rank holds E/M experts; it routes its own
  tokens (``B/Dp × S/M``, capacity sized from them), sends each expert's
  capacity buffer to its owner and gets the outputs back (two
  all-to-alls);
* ``ep_split`` (E divides M, M > E): each expert is held by r = M/E
  ranks, each taking 1/r of every rank's capacity (rounded up to a
  multiple of r); the weights are stored split on F and exchanged so each
  owner holds its expert whole;
* ``tp`` (otherwise): the sequence is gathered, every rank routes the same
  tokens through every expert's F/M columns, and the partial outputs are
  added over the ranks.

Tokens dropped by a rank's capacity are dropped as in the reference; the
rank's ``aux`` enters the loss weighted 1/M, so the step's loss holds the
mean over all ranks (the reference's ``pmean``).

Order, as the reference has it: ``jax.lax.top_k`` puts the lower index
first on ties, so the router takes a stable descending sort; the dispatch
sorts expert ids stably. The combine uses no atomics: each token has
exactly ``top_k`` entries (dropped ones gated to 0), gathered back by the
inverse of a stable sort on the token id and added one after another in
the order the reference's ``segment_sum`` adds them, so a rerun is bit
for bit the same on any device.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.configs import ArchConfig
from repro_torch.distributed import tp

__all__ = ["init_moe_params", "moe_ffn", "replace_router"]


def init_moe_params(cfg: ArchConfig, key: rnd.Key, *, device: str | torch.device = "cuda") -> dict[str, Any]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    ks = rnd.split(key, 5)
    std = 0.02
    pdt = cfg.param_dtype

    def normal(k, shape, dtype=pdt):
        return rnd.normal(k, shape, device=device, std=std).to(dtype)

    params = {
        "router": normal(ks[0], (d, e), torch.float32),
        "w1": normal(ks[1], (e, d, f)),
        "w3": normal(ks[2], (e, d, f)),
        "w2": normal(ks[3], (e, f, d)),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        k1, k2, k3 = rnd.split(ks[4], 3)
        params["shared"] = {
            "w1": normal(k1, (d, fs)),
            "w3": normal(k2, (d, fs)),
            "w2": normal(k3, (fs, d)),
        }
    return params


def replace_router(moe_params: dict[str, Any], router_w) -> dict[str, Any]:
    """Copy of the MoE param dict with the router swapped in.

    Takes a per-layer ``[d, E]`` matrix (broadcast over the leading axis
    when the params are a stacked ``[L, d, E]``) or a full-shape
    replacement; refuses shape mismatches and non-finite values, since a NaN
    router column would flatten the softmax over every expert."""
    old = moe_params["router"]
    if not isinstance(router_w, torch.Tensor):
        router_w = np.asarray(router_w)
    w = torch.as_tensor(router_w).to(dtype=old.dtype, device=old.device)
    if w.shape != old.shape:
        if old.ndim == w.ndim + 1 and w.shape == old.shape[1:]:
            w = w[None].expand(old.shape).clone()
        else:
            raise ValueError(
                f"router shape {tuple(w.shape)} incompatible with existing {tuple(old.shape)}"
            )
    if not bool(torch.isfinite(w).all()):
        raise ValueError("router contains non-finite values")
    return {**moe_params, "router": w}


def _counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """``bincount(ids, minlength=e)`` as an integer ``scatter_add_``: the
    same int64 counts, and an op the meta device has."""
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def _dispatch(x_flat, probs, topk_idx, e, cap):
    """Pack top-k (token, expert) pairs into a capacity-bounded [E, C, D] buffer.

    Returns (buffer, sorted_tok, sorted_e, slot, keep, gate_sorted)."""
    t, k = topk_idx.shape
    dev = x_flat.device
    ids = topk_idx.reshape(-1)  # [T*k]
    src = torch.arange(t, device=dev).repeat_interleave(k)
    gate = probs.reshape(-1)
    order = torch.sort(ids, stable=True).indices
    sorted_e = ids[order]
    sorted_tok = src[order]
    gate_sorted = gate[order]
    counts = _counts(sorted_e, e)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = slot < cap
    slot_safe = torch.where(keep, slot, cap)  # cap = out of range ⇒ dropped
    buf = torch.zeros((e, cap + 1, x_flat.shape[-1]), dtype=x_flat.dtype, device=dev)
    buf[sorted_e, slot_safe] = x_flat[sorted_tok]
    return buf[:, :cap], sorted_tok, sorted_e, slot_safe, keep, gate_sorted


def _combine(out_buf, sorted_tok, sorted_e, slot, keep, gate_sorted, t):
    """Inverse of _dispatch: gather expert outputs back per token, gated,
    each token's entries added in sorted order (no atomics)."""
    rows = out_buf[sorted_e, torch.clamp(slot, max=out_buf.shape[1] - 1)]
    rows = rows * (gate_sorted * keep)[:, None].to(rows.dtype)
    per_tok = rows[torch.sort(sorted_tok, stable=True).indices].reshape(t, -1, rows.shape[-1])
    out = per_tok[:, 0]
    for j in range(1, per_tok.shape[1]):
        out = out + per_tok[:, j]
    return out


def _router(x_flat, router_w, top_k):
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch/GShard): E * sum(frac_tokens * frac_prob)
    e = probs.shape[-1]
    me = probs.mean(0)
    ce = _counts(top_i.reshape(-1), e).float() / max(top_i.numel(), 1)
    aux = e * torch.sum(me * ce)
    return top_p, top_i, aux


def _swiglu_experts(tokens, w1, w3, w2):
    h = F.silu(torch.einsum("ecd,edf->ecf", tokens, w1)) * torch.einsum("ecd,edf->ecf", tokens, w3)
    return torch.einsum("ecf,efd->ecd", h, w2)


def moe_mode(n_experts: int, n_model: int) -> str:
    """"ep" (experts sharded over model), "ep_split" (each expert owned by
    n_model/E shards, capacity split) or "tp" (F sliced over model)."""
    if n_experts % n_model == 0 and n_experts >= n_model:
        return "ep"
    if n_model % n_experts == 0 and n_model > n_experts:
        return "ep_split"
    return "tp"


def _capacity(cfg, t_loc, e):
    return max(1, math.ceil(t_loc * cfg.top_k / e * cfg.capacity_factor))


def _moe_local(cfg, router_w, w1, w3, w2, x_flat, e):
    """The single-shard path."""
    t = x_flat.shape[0]
    cap = _capacity(cfg, t, e)
    top_p, top_i, aux = _router(x_flat, router_w, cfg.top_k)
    buf, *meta = _dispatch(x_flat, top_p, top_i, e, cap)
    out_buf = _swiglu_experts(buf, w1, w3, w2)
    return _combine(out_buf, *meta, t), aux


def _moe_ep(cfg, router_w, w1, w3, w2, x_flat, e, m):
    """The ``ep`` island: ``w*`` the rank's E/M experts."""
    t, d = x_flat.shape
    e_loc = e // m
    cap = _capacity(cfg, t, e)
    top_p, top_i, aux = _router(x_flat, router_w, cfg.top_k)
    buf, *meta = _dispatch(x_flat, top_p, top_i, e, cap)
    recv = tp.all_to_all(buf.reshape(m, e_loc, cap, d))  # [src, e_loc, C, D]
    tokens = recv.transpose(0, 1).reshape(e_loc, m * cap, d)
    out = _swiglu_experts(tokens, w1, w3, w2).reshape(e_loc, m, cap, d).transpose(0, 1)
    back = tp.all_to_all(out)  # [owner, e_loc, C, D]: this rank's tokens
    return _combine(back.reshape(e, cap, d), *meta, t), aux


def _moe_ep_split(cfg, router_w, w1, w3, w2, x_flat, e, m):
    """The ``ep_split`` island: ``w*`` every expert's F/M slice; rank ``j``
    owns expert ``j // r``."""
    t, d = x_flat.shape
    r = m // e
    cap = -(-_capacity(cfg, t, e) // r) * r
    top_p, top_i, aux = _router(x_flat, router_w, cfg.top_k)
    buf, *meta = _dispatch(x_flat, top_p, top_i, e, cap)
    tokens = tp.all_to_all(buf.reshape(m, cap // r, d)).reshape(m * (cap // r), d)
    dest = torch.arange(m, device=x_flat.device) // r

    def whole(w, f_axis):
        """The owned expert's weight with every rank's F slice, in rank order."""
        got = tp.all_to_all(w[dest])  # [src, ..., F/M, ...]
        return torch.cat(got.unbind(0), dim=f_axis)

    h = F.silu(tokens @ whole(w1, 1)) * (tokens @ whole(w3, 1))
    out = (h @ whole(w2, 0)).reshape(m, cap // r, d)
    return _combine(tp.all_to_all(out).reshape(e, cap, d), *meta, t), aux


def _moe_tp(cfg, router_w, w1, w3, w2, x_flat, e):
    """The ``tp`` island: ``w*`` every expert's F/M slice; the partial
    outputs added over the ranks in f32."""
    t, d = x_flat.shape
    cap = _capacity(cfg, t, e)
    top_p, top_i, aux = _router(x_flat, router_w, cfg.top_k)
    buf, *meta = _dispatch(x_flat, top_p, top_i, e, cap)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w1)) * torch.einsum("ecd,edf->ecf", buf, w3)
    partial = torch.einsum("ecf,efd->ecd", h.float(), w2.float())
    return _combine(tp.all_sum(partial, x_flat.dtype), *meta, t), aux


def _moe_model_axis(cfg, params, x, w1, w3, w2, par):
    """The MoE FFN (shared experts included) on the model axis: ``x`` the
    rank's part of the residual stream; returns the rank's part of the
    output and its ``aux``."""
    b, s, d = x.shape
    e = cfg.n_experts
    mode = moe_mode(e, par.m)
    whole = x
    if par.seq and (mode == "tp" or cfg.n_shared_experts):
        whole = tp.gather_seq(x)
    if mode == "ep":
        y, aux = _moe_ep(cfg, params["router"], w1, w3, w2, x.reshape(-1, d), e, par.m)
    elif mode == "ep_split":
        y, aux = _moe_ep_split(cfg, params["router"], w1, w3, w2, x.reshape(-1, d), e, par.m)
    else:
        y, aux = _moe_tp(cfg, params["router"], w1, w3, w2, whole.reshape(-1, d), e)
        if par.seq:
            y = y.reshape(b, -1, d).narrow(1, tp.model_rank() * s, s)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        sp = params["shared"]
        a = F.silu(whole @ sp["w1"].to(x.dtype)) * (whole @ sp["w3"].to(x.dtype))
        if not par.shared_ff:  # stored whole, run whole on every rank
            shared = a @ sp["w2"].to(x.dtype)
            y = y + (tp._part(shared, 1) if par.seq else shared)
        else:
            partial = a.float() @ sp["w2"].to(x.dtype).float()
            y = y + (tp.scatter_sum(partial, 1, x.dtype) if par.seq
                     else tp.all_sum(partial, x.dtype))
    return y, aux


def moe_ffn(cfg: ArchConfig, params: dict, x: torch.Tensor, par=None) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over ``x [B, S, D]``. Returns (output, aux_loss). ``par``
    (``transformer``'s model axis) runs the island of :func:`moe_mode` on
    the rank's part of the residual stream."""
    from repro_torch.models.layers import swiglu

    b, s, d = x.shape
    dtype = x.dtype

    def wt(w):
        return w.to(dtype) if cfg.cast_params_before_use else w

    if par is not None:
        return _moe_model_axis(cfg, params, x, wt(params["w1"]), wt(params["w3"]),
                               wt(params["w2"]), par)
    y, aux = _moe_local(cfg, params["router"], wt(params["w1"]), wt(params["w3"]),
                        wt(params["w2"]), x.reshape(-1, d), cfg.n_experts)
    out = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        sp = params["shared"]
        out = out + swiglu(x, sp["w1"].to(dtype), sp["w3"].to(dtype), sp["w2"].to(dtype))
    return out, aux
