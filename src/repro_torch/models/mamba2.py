"""Mamba2 (SSD: state-space duality, arXiv:2405.21060) block. Counterpart of
``repro.models.mamba2``; the backward is autograd's through the chunk loop.

Chunked SSD ("minimal ssd"): within a chunk of ``cfg.ssm_chunk`` tokens the
dual quadratic form runs as batched matmuls; across chunks a Python loop
carries the ``[B, H, P, N]`` f32 state. Single-token decode is the O(1)
recurrent update on the cached state.

Layout: d_inner = expand·d_model, H = d_inner / headdim heads, one B/C
group. The in-projection gives (z, x, B, C, dt); a width-``ssm_conv`` causal
depthwise conv runs over (x, B, C); the gate z feeds a gated RMSNorm before
the out-projection. The casts are the reference's: dt, A, B, C, the state
and x inside the chunk are f32; y returns to the compute dtype before the
gated norm; the conv state stays in the compute dtype. The conv's taps are
summed in f32 and rounded once, the same arithmetic in both paths (the
reference leaves that accumulation to its compiler's fusion).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import matmul, rmsnorm

__all__ = ["init_mamba_params", "mamba_forward", "mamba_decode", "mamba_dims"]


def mamba_dims(cfg: ArchConfig) -> dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n  # (x, B, C) share the conv
    return dict(
        d_inner=d_inner,
        nheads=nheads,
        n=n,
        conv_dim=conv_dim,
        in_dim=2 * d_inner + 2 * n + nheads,  # z, x, B, C, dt
    )


def init_mamba_params(cfg: ArchConfig, key: rnd.Key, *, device: str | torch.device = "cuda") -> dict[str, Any]:
    """The reference's block: projections and conv at N(0, 0.02²), zero conv
    bias, ``a_log`` and ``dt_bias``, unit ``d_skip`` and norm, in
    ``cfg.param_dtype`` on ``device``."""
    device = resolve_device(device)
    dims = mamba_dims(cfg)
    k1, k2, k3 = rnd.split(key, 3)
    d = cfg.d_model
    std = 0.02
    pdt = cfg.param_dtype

    def normal(k, shape):
        return rnd.normal(k, shape, device=device, std=std).to(pdt)

    def full(n, value):
        return torch.full((n,), value, dtype=pdt, device=device)

    return {
        "in_proj": normal(k1, (d, dims["in_dim"])),
        "conv_w": normal(k2, (cfg.ssm_conv, dims["conv_dim"])),
        "conv_b": full(dims["conv_dim"], 0.0),
        "a_log": full(dims["nheads"], 0.0),
        "dt_bias": full(dims["nheads"], 0.0),
        "d_skip": full(dims["nheads"], 1.0),
        "norm_w": full(dims["d_inner"], 1.0),
        "out_proj": normal(k3, (dims["d_inner"], d)),
    }


def _split_proj(proj, dims):
    d_inner = dims["d_inner"]
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner : d_inner + dims["conv_dim"]]
    dt = proj[..., d_inner + dims["conv_dim"] :]
    return z, xbc, dt


def _split_xbc(xbc, dims):
    d_inner, n = dims["d_inner"], dims["n"]
    return xbc[..., :d_inner], xbc[..., d_inner : d_inner + n], xbc[..., d_inner + n :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) at every x; torch's
    ``F.softplus`` returns x itself past its threshold of 20."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _conv(taps, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``silu(Σ_i taps[i]·w[i] + b)`` in the taps' dtype, summed in f32 in
    tap order and rounded once: the same arithmetic for the sequence's conv
    and a decode step's, so that in bf16 a prefill continued by decode
    steps computes what the full-sequence forward computes (rounding each
    tap in bf16 made the two paths' logits differ by percents)."""
    acc = taps[0].float() * w[0].float()
    for i in range(1, w.shape[0]):
        acc = acc + taps[i].float() * w[i].float()
    return F.silu(acc + b.float()).to(taps[0].dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence. xbc [B, S, C], w [W, C]."""
    wsz, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, wsz - 1, 0))
    return _conv([pad[:, i : i + s] for i in range(wsz)], w, b)


def _chunk_step(state, xc, dtc, dac, bc, cc, d_skip):
    """One chunk of the SSD scan, all f32. state [B, H, P, N]; xc [B, q, H, P];
    dtc, dac [B, q, H]; bc, cc [B, q, N]. Returns (new state, y [B, q, H, P]).

    The reference's four-operand einsums are written as explicit products so
    that no [B, q, q, H, P] intermediate can arise: the [B, q, q, H] weights
    ``C·Bᵀ ⊙ L ⊙ dt`` first, then one batched matmul with x over s (per
    batch and head); the chunk state as ``(decay ⊙ dt ⊙ x)ᵀ · B`` over s."""
    b, q, h, p = xc.shape
    n = bc.shape[-1]
    cum = torch.cumsum(dac, dim=1)  # [B, q, H]
    # intra-chunk dual form: L[t, s] = exp(cum_t - cum_s) for s <= t; above
    # the diagonal the exponent is masked to -inf before exp(), which there
    # may overflow to inf: a select after exp() would give the right values
    # but a NaN gradient (0 · inf) once a chunk's decay passes 88
    seg = cum[:, :, None, :] - cum[:, None, :, :]  # [B, t, s, H]
    tri = torch.ones(q, q, dtype=torch.bool, device=xc.device).tril()
    l_mat = torch.exp(seg.masked_fill(~tri[None, :, :, None], float("-inf")))
    cb = torch.bmm(cc, bc.transpose(1, 2))  # [B, t, s]
    wts = cb[..., None] * l_mat * dtc[:, None, :, :]  # [B, t, s, H]
    y = torch.matmul(wts.permute(0, 3, 1, 2), xc.permute(0, 2, 1, 3))  # [B, H, t, P]
    y = y.permute(0, 2, 1, 3)
    # the carried state's contribution: (C · stateᵀ) ⊙ exp(cum)
    cs = torch.matmul(cc, state.reshape(b, h * p, n).transpose(1, 2)).reshape(b, q, h, p)
    y = y + cs * torch.exp(cum)[..., None]
    # chunk state update
    decay = torch.exp(cum[:, -1:, :] - cum)  # [B, q, H]
    u = (decay * dtc)[..., None] * xc  # [B, s, H, P]
    new_state = torch.matmul(u.reshape(b, q, h * p).transpose(1, 2), bc).reshape(b, h, p, n)
    state = state * torch.exp(cum[:, -1])[:, :, None, None] + new_state
    y = y + xc * d_skip[None, None, :, None]
    return state, y


def mamba_forward(cfg: ArchConfig, p: dict, x: torch.Tensor, *, return_state: bool = False):
    """Full-sequence SSD. x [B, S, D] → [B, S, D] (and, with
    ``return_state``, the final ``(conv [B, W-1, conv_dim], ssm [B, H, P, N])``
    state). S must be a whole number of ``cfg.ssm_chunk`` chunks."""
    dims = mamba_dims(cfg)
    b, s, _ = x.shape
    h, pd, n = dims["nheads"], cfg.ssm_headdim, dims["n"]
    q = cfg.ssm_chunk
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk {q}")

    proj = matmul(x, p["in_proj"].to(x.dtype))
    z, xbc, dt = _split_proj(proj, dims)
    xbc = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xs, bmat, cmat = _split_xbc(xbc, dims)

    xs = xs.reshape(b, s, h, pd)
    dt = _softplus(dt.float() + p["dt_bias"].float())  # [B, S, H]
    a = -torch.exp(p["a_log"].float())  # [H]
    da = dt * a  # [B, S, H]
    bmat = bmat.float()  # [B, S, N] (one group)
    cmat = cmat.float()
    d_skip = p["d_skip"].float()

    state = torch.zeros((b, h, pd, n), dtype=torch.float32, device=x.device)
    ys = torch.empty((b, s, h, pd), dtype=torch.float32, device=x.device)
    for i in range(s // q):
        c = slice(i * q, (i + 1) * q)
        state, ys[:, c] = _chunk_step(state, xs[:, c].float(), dt[:, c], da[:, c], bmat[:, c],
                                      cmat[:, c], d_skip)
    y = ys.reshape(b, s, dims["d_inner"]).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"])  # gated norm
    out = matmul(y, p["out_proj"].to(x.dtype))
    if not return_state:
        return out
    return out, (_conv_tail(cfg, x, p), state)


def _conv_tail(cfg, x, p):
    """The last W-1 *pre-conv* (x, B, C) features, recomputed from the
    normed inputs: the window a decode step continues."""
    dims = mamba_dims(cfg)
    proj = matmul(x[:, -(cfg.ssm_conv - 1) :, :], p["in_proj"].to(x.dtype))
    _, xbc, _ = _split_proj(proj, dims)
    return xbc.contiguous()  # [B, W-1, conv_dim]


def mamba_decode(
    cfg: ArchConfig, p: dict, x: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor
):
    """One-token recurrent step. x [B, D]; returns (y [B, D], (new conv
    state, new ssm state)); the states given stay as they were."""
    dims = mamba_dims(cfg)
    b = x.shape[0]
    h, pd = dims["nheads"], cfg.ssm_headdim

    proj = matmul(x, p["in_proj"].to(x.dtype))
    z, xbc, dt = _split_proj(proj, dims)

    # causal conv over (stored W-1 tail, current)
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # [B, W, C]
    w = p["conv_w"].to(x.dtype)
    conv_out = _conv([window[:, i] for i in range(w.shape[0])], w, p["conv_b"].to(x.dtype))
    xs, bvec, cvec = _split_xbc(conv_out, dims)
    xs = xs.reshape(b, h, pd).float()

    dt = _softplus(dt.float() + p["dt_bias"].float())  # [B, H]
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a)  # [B, H]
    bvec = bvec.float()
    cvec = cvec.float()

    new_state = ssm_state * da[:, :, None, None] + (dt[..., None] * xs)[..., None] * bvec[:, None, None, :]
    y = torch.matmul(new_state, cvec[:, None, :, None])[..., 0]  # [B, H, P]
    y = y + xs * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, dims["d_inner"]).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"])
    out = matmul(y, p["out_proj"].to(x.dtype))
    return out, (window[:, 1:, :], new_state)
