"""Mixture-of-Experts FFN with capacity-bounded dispatch (GShard-style).
Counterpart of ``repro.models.moe``, single-device path.

Tokens are sorted by expert (stable), packed into a capacity-bounded
``[E, C, D]`` buffer, run through every expert's SwiGLU, and gathered back
per token, gated. Tokens over capacity are dropped (the GShard convention);
the router is top-k over the softmax with renormalised probabilities, plus
the load-balance aux loss. The reference's expert- and tensor-parallel
islands need a model axis, which the port leaves out by design, so
``moe_ffn`` always takes the local path (the reference's ``mesh is None``
branch). On a ``"data"`` mesh the reference runs its ``"ep"`` island at one
model rank, which is that path on the rank's tokens (capacity sized from
them) with the expert weights gathered and ``aux`` averaged over the ranks:
under the port's FSDP step the layer gets the rank's rows and its gathered
weights (``transformer``), and the step averages the loss, ``aux``
included, over the ranks (``train.train_step``).

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
    n_model/E shards) or "tp" (F sliced over model). The port has no model
    axis (n_model = 1), so it runs none of them: ``moe_ffn`` is local."""
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


def moe_ffn(cfg: ArchConfig, params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over ``x [B, S, D]``. Returns (output, aux_loss)."""
    from repro_torch.models.layers import swiglu

    b, s, d = x.shape
    dtype = x.dtype

    def wt(w):
        return w.to(dtype) if cfg.cast_params_before_use else w

    y, aux = _moe_local(cfg, params["router"], wt(params["w1"]), wt(params["w3"]),
                        wt(params["w2"]), x.reshape(-1, d), cfg.n_experts)
    out = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        sp = params["shared"]
        out = out + swiglu(x, sp["w1"].to(dtype), sp["w3"].to(dtype), sp["w2"].to(dtype))
    return out, aux
