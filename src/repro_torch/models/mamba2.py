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

On a mesh whose ``"model"`` dimension has M > 1 ranks (``model_axis``, the
transformer's model axis) the layer's heads split over the ranks where M
divides H (``tp.splits``), as the reference's layouts put them
(``in_proj`` ``("batch", "tensor")``, ``out_proj`` ``("tensor", "batch")``,
the ``ssm`` cache's H axis): ``in_proj``, split contiguously over
``[z | x | B | C | dt]`` and so not along heads, is gathered whole and each
rank takes the columns of its H/M heads' z, x and dt, with B and C whole
(one group); the depthwise conv runs over its own channels and the SSD over
its own heads (both exact: per channel, per head); the gated RMSNorm adds
each row's f32 sum of squares over the ranks before the scale; and
``out_proj`` is row-parallel, returning the rank's f32 partial for the
caller to add over the ranks. The conv state stays whole and equal on every
rank: a decode step computes the whole new (x, B, C) row on each rank (no
collective), a prefill the whole tail. Where M does not divide H the layer
runs whole on every rank, its split weights gathered (the reference's
``logical_to_spec`` drops the axis there).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import random as rnd
from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import tp
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


def _gated_norm(g: torch.Tensor, w: torch.Tensor, d_inner: int) -> torch.Tensor:
    """The gated RMSNorm of the rank's ``g = y·silu(z)`` columns: each row's
    f32 sum of squares added over the model ranks, then ``rmsnorm``'s
    arithmetic over all ``d_inner`` columns."""
    x = g.float()
    ss = tp.all_sum((x * x).sum(-1, keepdim=True))
    return (x * torch.rsqrt(ss / d_inner + 1e-6) * w.float()).to(g.dtype)


class _View(NamedTuple):
    """A layer's parameters for use (:func:`_view`)."""

    p: dict  # the parameters the layer's heads use, ``in_proj`` aside
    dims: dict  # their widths
    in_proj: torch.Tensor  # the whole in_proj, in the compute dtype
    cols: tuple | None  # the rank's slices of the whole projection: z, x, (B, C), dt
    conv: tuple | None  # the rank's slices of the whole (x, B, C) channels


def _view(cfg: ArchConfig, p: dict, dtype, model_axis: bool) -> _View:
    """The layer for use. On the model axis ``p`` holds the rank's model
    shards: ``in_proj`` is gathered whole, and where the heads split each
    rank keeps its heads' parameters and the slices of the projection and
    the conv channels they use (``cols``/``conv``); where they do not,
    ``out_proj`` is gathered whole too and the layer runs whole."""
    dims = mamba_dims(cfg)
    if not model_axis:
        return _View(p, dims, p["in_proj"].to(dtype), None, None)
    d_inner, n, h, hd = dims["d_inner"], dims["n"], dims["nheads"], cfg.ssm_headdim
    w_in = tp.whole(p["in_proj"].to(dtype), 1, dims["in_dim"])
    if not tp.splits(cfg).ssm:
        return _View(dict(p, out_proj=tp.whole(p["out_proj"].to(dtype), 0, d_inner)), dims, w_in,
                     None, None)
    hl = h // tp.model_size()
    dl, r = hl * hd, tp.model_rank()
    heads = slice(r * hl, (r + 1) * hl)
    chans = slice(r * dl, (r + 1) * dl)
    cols = (chans,  # z
            slice(d_inner + r * dl, d_inner + (r + 1) * dl),  # x
            slice(2 * d_inner, 2 * d_inner + 2 * n),  # B, C
            slice(2 * d_inner + 2 * n + r * hl, 2 * d_inner + 2 * n + (r + 1) * hl))  # dt
    conv = (chans, slice(d_inner, d_inner + 2 * n))
    local = {
        "conv_w": torch.cat([p["conv_w"][:, c] for c in conv], dim=1),
        "conv_b": torch.cat([p["conv_b"][c] for c in conv]),
        "a_log": p["a_log"][heads], "dt_bias": p["dt_bias"][heads], "d_skip": p["d_skip"][heads],
        "norm_w": p["norm_w"][chans], "out_proj": p["out_proj"],
    }
    dl_dims = dict(d_inner=dl, nheads=hl, n=n, conv_dim=dl + 2 * n, in_dim=2 * dl + 2 * n + hl)
    return _View(local, dl_dims, w_in, cols, conv)


def _norm_out(cfg: ArchConfig, v: _View, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated norm of ``y·silu(z)`` and ``out_proj``: where the heads
    split, the norm over all ranks' columns and the rank's f32 partial."""
    if v.cols is None:
        return matmul(rmsnorm(y * F.silu(z), v.p["norm_w"]), v.p["out_proj"].to(y.dtype))
    g = _gated_norm(y * F.silu(z), v.p["norm_w"], mamba_dims(cfg)["d_inner"])
    return g.float() @ v.p["out_proj"].to(y.dtype).float()


def _mixer(cfg: ArchConfig, v: _View, x: torch.Tensor, proj: torch.Tensor):
    """The SSD mixer over a whole sequence from its projection ``proj``
    ``[B, S, in_dim]`` (``v.dims``' layout); returns ``(y [B, S, d_inner]``
    before the gated norm, the gate z, the final ``[B, H, P, N]`` state)."""
    p, dims = v.p, v.dims
    b, s, _ = x.shape
    h, pd, n = dims["nheads"], cfg.ssm_headdim, dims["n"]
    q = cfg.ssm_chunk
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk {q}")
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
    return ys.reshape(b, s, dims["d_inner"]).to(x.dtype), z, state


def mamba_forward(cfg: ArchConfig, p: dict, x: torch.Tensor, *, return_state: bool = False,
                  model_axis: bool = False):
    """Full-sequence SSD. x [B, S, D] → [B, S, D] (and, with
    ``return_state``, the final ``(conv [B, W-1, conv_dim], ssm [B, H, P, N])``
    state). S must be a whole number of ``cfg.ssm_chunk`` chunks.

    With ``model_axis`` (``p`` the rank's model shards, ``x`` the whole
    sequence) the output is, where the heads split, the rank's f32 partial of
    ``out_proj`` and the state its ``[B, H/M, P, N]`` heads' (the conv
    state whole); elsewhere the whole layer's (the module docstring)."""
    v = _view(cfg, p, x.dtype, model_axis)
    w = v.in_proj if v.cols is None else torch.cat([v.in_proj[:, c] for c in v.cols], dim=1)
    y, z, state = _mixer(cfg, v, x, matmul(x, w))
    out = _norm_out(cfg, v, y, z)
    if not return_state:
        return out
    return out, (_conv_tail(cfg, x, v.in_proj), state)


def _conv_tail(cfg, x, in_proj):
    """The last W-1 *pre-conv* (x, B, C) features, recomputed from the
    normed inputs with the whole ``in_proj``: the window a decode step
    continues."""
    dims = mamba_dims(cfg)
    proj = matmul(x[:, -(cfg.ssm_conv - 1) :, :], in_proj.to(x.dtype))
    _, xbc, _ = _split_proj(proj, dims)
    return xbc.contiguous()  # [B, W-1, conv_dim]


def mamba_decode(
    cfg: ArchConfig, p: dict, x: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
    *, model_axis: bool = False,
):
    """One-token recurrent step. x [B, D]; returns (y [B, D], (new conv
    state, new ssm state)); the states given stay as they were. With
    ``model_axis``, as :func:`mamba_forward`'s: ``ssm_state`` the rank's
    heads' where they split, ``y`` then the rank's f32 partial; the whole
    new (x, B, C) row is computed on every rank for the conv state, and the
    rank's heads take their columns of it."""
    v = _view(cfg, p, x.dtype, model_axis)
    dims = v.dims
    b = x.shape[0]
    h, pd = dims["nheads"], cfg.ssm_headdim

    proj = matmul(x, v.in_proj)  # [B, in_dim]: the whole row
    z, xbc, dt = _split_proj(proj, mamba_dims(cfg))
    # causal conv over (stored W-1 tail, current)
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # [B, W, C]
    taps = window
    if v.cols is not None:  # the rank's heads' columns
        z, dt = proj[:, v.cols[0]], proj[:, v.cols[3]]
        taps = torch.cat([window[..., c] for c in v.conv], dim=-1)
    w = v.p["conv_w"].to(x.dtype)
    conv_out = _conv([taps[:, i] for i in range(w.shape[0])], w, v.p["conv_b"].to(x.dtype))
    xs, bvec, cvec = _split_xbc(conv_out, dims)
    xs = xs.reshape(b, h, pd).float()

    dt = _softplus(dt.float() + v.p["dt_bias"].float())  # [B, H]
    a = -torch.exp(v.p["a_log"].float())
    da = torch.exp(dt * a)  # [B, H]
    bvec = bvec.float()
    cvec = cvec.float()

    new_state = ssm_state * da[:, :, None, None] + (dt[..., None] * xs)[..., None] * bvec[:, None, None, :]
    y = torch.matmul(new_state, cvec[:, None, :, None])[..., 0]  # [B, H, P]
    y = y + xs * v.p["d_skip"].float()[None, :, None]
    y = y.reshape(b, dims["d_inner"]).to(x.dtype)
    return _norm_out(cfg, v, y, z), (window[:, 1:, :], new_state)
