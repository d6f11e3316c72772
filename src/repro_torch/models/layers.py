"""Shared transformer layers: RMSNorm, RoPE, GQA attention (block-causal
chunked, masked-full, decode), unmasked cross-attention, SwiGLU MLP.
Counterpart of ``repro.models.layers``.

Plain PyTorch in the reference's operation order: products that the
reference accumulates in f32 (``preferred_element_type``) take f32-cast
operands here, softmax runs in f32 over logits masked to ``_NEG``, and the
rope tables are f32. ``block_causal`` runs the reference's chunked online
softmax as Python loops over the visible chunk pairs, as the autograd
function :class:`_Flash`: its backward is the reference's ``_flash_bwd``,
recomputing each visible tile from the saved row max and row sum, so the
residuals are O(S) a head rather than every tile's probabilities.
``masked_full`` (also taken when ``s <= chunk``) computes every pair and
masks, and differentiates by plain autograd, as the reference's does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard

__all__ = [
    "rmsnorm",
    "rope",
    "swiglu",
    "attention",
    "decode_attention",
    "cross_attention",
]

_NEG = -1e30


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul`` is."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """(cos, sin) ``[..., S, hd/2]`` in f32, computed once per step and
    shared by every layer."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    tables: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Rotary embedding. ``x [..., S, H, hd]``, ``positions [S] or [B, S]``."""
    hd = x.shape[-1]
    half = hd // 2
    cos, sin = tables if tables is not None else rope_tables(positions, hd, theta)
    cos = cos[..., None, :]  # [..., S, 1, half]
    sin = sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    h = F.silu(matmul(x, w1)) * matmul(x, w3)
    h = shard(h, "batch", *(None,) * (h.ndim - 2), "tensor")
    return matmul(h, w2)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, c, KV, G, hd] × k [B, s, KV, hd] → f32 [B, KV, G, c, s]."""
    return torch.einsum("bckgh,bskh->bkgcs", (q * scale).float(), k.float())


def _weighted_v(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B, KV, G, c, s] × v [B, s, KV, hd] → [B, c, KV, G, hd] in p's dtype."""
    return torch.einsum("bkgcs,bskh->bckgh", p, v.to(p.dtype))


def _chunk_mask(i, j, chunk, window, device):
    qpos = i * chunk + torch.arange(chunk, device=device)
    kpos = j * chunk + torch.arange(chunk, device=device)
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def _visible(i, j, window, chunk):
    """Whether kv chunk j is (partially) visible from q chunk i."""
    if j > i:
        return False
    return window is None or (i - j - 1) * chunk < window


def _flash_fwd(q, k, v, window, chunk):
    """Block-causal online-softmax forward over q [B, S, KV, G, hd];
    returns (out f32 [B, S, KV, G, hd], the row max m and row sum l, f32
    [B, KV, G, S, 1])."""
    b, s, kv, g, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    outs, ms, ls = [], [], []
    for i in range(s // chunk):
        qi = q[:, i * chunk:(i + 1) * chunk]
        m = torch.full((b, kv, g, chunk, 1), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kv, g, chunk, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, chunk, kv, g, hd), dtype=torch.float32, device=q.device)
        for j in range(i + 1):
            if not _visible(i, j, window, chunk):
                continue
            kj = k[:, j * chunk:(j + 1) * chunk]
            vj = v[:, j * chunk:(j + 1) * chunk]
            logits = _scores(qi, kj, scale)  # [B, KV, G, c, c]
            mask = _chunk_mask(i, j, chunk, window, q.device)
            logits = torch.where(mask[None, None, None], logits, _NEG)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha.permute(0, 3, 1, 2, 4) + _weighted_v(p, vj)
            m = m_new
        outs.append(acc / l.permute(0, 3, 1, 2, 4))
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=1), torch.cat(ms, dim=3), torch.cat(ls, dim=3)


def _flash_bwd(q, k, v, out, m, l, dout, window, chunk):
    """The flash backward: each visible tile's probabilities recomputed
    from the saved row statistics, ``p = exp(logits − m) / l``; with
    ``delta = rowsum(dout · out)``, ``ds = p · (dp − delta)``. Accumulates
    in f32 over the reference's tile order and returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    b, s, kv, g, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    nc = s // chunk
    dout = dout.float()
    # delta_i = rowsum(dout * out)  [B, KV, G, S, 1]
    delta = torch.sum(dout * out, dim=-1).permute(0, 2, 3, 1)[..., None]
    dq = [torch.zeros((b, chunk, kv, g, hd), dtype=torch.float32, device=q.device)
          for _ in range(nc)]
    dk = [torch.zeros((b, chunk, kv, hd), dtype=torch.float32, device=q.device)
          for _ in range(nc)]
    dv = [torch.zeros((b, chunk, kv, hd), dtype=torch.float32, device=q.device)
          for _ in range(nc)]
    for i in range(nc):
        rows = slice(i * chunk, (i + 1) * chunk)
        qi, doi = q[:, rows], dout[:, rows]
        mi, li, di = m[:, :, :, rows], l[:, :, :, rows], delta[:, :, :, rows]
        for j in range(i + 1):
            if not _visible(i, j, window, chunk):
                continue
            kj = k[:, j * chunk:(j + 1) * chunk]
            vj = v[:, j * chunk:(j + 1) * chunk]
            logits = _scores(qi, kj, scale)
            mask = _chunk_mask(i, j, chunk, window, q.device)
            logits = torch.where(mask[None, None, None], logits, _NEG)
            p = torch.exp(logits - mi) / li  # [B, KV, G, c, c]
            # dv_j += pᵀ · dout_i (over the q rows and G)
            dv[j] = dv[j] + torch.einsum("bkgqs,bqkgh->bskh", p, doi)
            dp = torch.einsum("bqkgh,bskh->bkgqs", doi, vj.float())
            ds = p * (dp - di)  # [B, KV, G, c, c]
            dq[i] = dq[i] + torch.einsum("bkgqs,bskh->bqkgh", ds, kj.float()) * scale
            dk[j] = dk[j] + torch.einsum("bkgqs,bqkgh->bskh", ds, qi.float()) * scale
    return (torch.cat(dq, dim=1).to(q.dtype), torch.cat(dk, dim=1).to(k.dtype),
            torch.cat(dv, dim=1).to(v.dtype))


class _Flash(torch.autograd.Function):
    """Block-causal attention over q [B, S, KV, G, hd], k, v [B, S, KV, hd]
    with the flash backward; ``window`` and ``chunk`` take no gradient.
    Saves (q, k, v, out, m, l): O(S) a head beside the inputs."""

    @staticmethod
    def forward(ctx, q, k, v, window, chunk):
        out, m, l = _flash_fwd(q, k, v, window, chunk)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.window, ctx.chunk = window, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, dout, ctx.window, ctx.chunk)
        return dq, dk, dv, None, None


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int | None = None,
    impl: str = "block_causal",
    chunk: int = 2048,
) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention.

    q [B, S, H, hd]; k, v [B, S, KV, hd]. Returns [B, S, H, hd].

    ``block_causal`` differentiates through :class:`_Flash`'s backward;
    ``masked_full`` by plain autograd."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, kv, g, hd)

    if impl == "masked_full" or s <= chunk:
        pos = torch.arange(s, device=q.device)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[:, None] - pos[None, :] < window
        logits = _scores(qg, k, scale)  # [B, KV, G, S, S]
        logits = torch.where(mask[None, None, None], logits, _NEG)
        p = torch.softmax(logits, dim=-1)
        return _weighted_v(p, v).reshape(b, s, h, hd).to(q.dtype)

    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the attention chunk {chunk}")
    out = _Flash.apply(qg, k, v, window, chunk)
    return out.to(q.dtype).reshape(b, s, h, hd)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    slot_pos: torch.Tensor,
    pos,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q [B, H, hd]; caches [B, Sc, KV, hd]; slot_pos [B, Sc] the token
    position stored in each slot (-1 = empty); ``pos`` an int or a 0-d
    tensor. A slot is attendable iff its position is in (pos − window, pos].
    """
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, 1, kv, g, hd)
    logits = _scores(qg, k_cache, scale)[:, :, :, 0]  # [B, KV, G, Sc]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= slot_pos > pos - window
    logits = torch.where(valid[:, None, None, :], logits, _NEG)
    p = torch.softmax(logits, dim=-1)  # [B, KV, G, Sc]
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(p.dtype))
    return out.reshape(b, h, hd).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention of text queries over (stubbed) image tokens.

    q [B, S, H, hd]; k, v [B, T_img, KV, hd]. Returns [B, S, H, hd]; the
    scores and softmax in f32."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, kv, g, hd)
    logits = _scores(qg, k, scale)  # [B, KV, G, S, T]
    p = torch.softmax(logits, dim=-1)
    return _weighted_v(p, v).reshape(b, s, h, hd).to(q.dtype)
