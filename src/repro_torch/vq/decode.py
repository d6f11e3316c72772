"""Decode over a code-valued KV cache: store codes, dequantize on read.
Counterpart of ``repro.vq.decode``.

The quantized decode step runs the same per-layer block as
``transformer.decode``. Per layer and step:

  1. **dequantize on attention read**: the layer's ``[B, Sc, kv]`` codes
     gather through the ``[K, hd]`` centroid stack (in ``cfg.dtype``) into
     the raw ``[B, Sc, kv, hd]`` layout the block attends over;
  2. the block computes the new token's K/V, writes them (exact, not
     quantized) into the ring slot, and attends: the current token always
     sees its own exact K/V;
  3. **re-quantize the written slot only**: one ``ops.assign_top2`` (B1 on
     CUDA) over the ``B·kv`` new f32 vectors against the f32 codebook
     stores their codes; everything carried between steps is codes.

Only families with a plain self-attention KV stack (dense / moe / audio)
are supported. :func:`decode_quantized` leaves the cache it is given as it
was; :func:`generate_quantized` and :func:`teacher_forced_nll`, whose
reference loops donate the cache, step in place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.vq.codebook import KVCodebook, quantize_cache
from repro_torch.vq.source import params_device

__all__ = ["decode_quantized", "generate_quantized", "teacher_forced_nll"]


def _check_family(cfg):
    if cfg.family in ("ssm", "hybrid", "vlm"):
        raise NotImplementedError(
            f"quantized decode supports plain KV-cache families (dense/moe/audio), "
            f"not {cfg.family!r}"
        )


def _decode_quantized_(cfg, params, kcb, vcb, qcache, token, pos: int):
    """One step over codes, writing the slot's codes and position into
    ``qcache``'s own tensors; returns the logits."""
    b = token.shape[0]
    x = tf._embed(cfg, params, token)
    sc = qcache["slot_pos"].shape[1]
    slot = pos % sc
    slot_pos = qcache["slot_pos"]
    slot_pos[:, slot] = pos  # the token sees itself
    kcb_t, vcb_t = kcb.to(cfg.dtype), vcb.to(cfg.dtype)
    k_codes, v_codes = qcache["k_codes"], qcache["v_codes"]
    for i in range(cfg.n_layers):
        kc = kcb_t[i][k_codes[i].long()]
        vc = vcb_t[i][v_codes[i].long()]
        x = tf._block_decode_(cfg, tf.layer(params["layers"], i), x, kc, vc, slot_pos, pos)
        for codes, cache, cb in ((k_codes, kc, kcb), (v_codes, vc, vcb)):
            new = cache[:, slot].reshape(-1, cb.shape[-1]).float()
            code, _, _ = ops.assign_top2(new, cb[i].float())
            codes[i, :, slot] = code.reshape(b, -1).to(codes.dtype)
    return tf._head(cfg, params, x)


def decode_quantized(cfg, params: dict, kcb: torch.Tensor, vcb: torch.Tensor,
                     qcache: dict, token: torch.Tensor, pos):
    """One decode step over codes. ``kcb``/``vcb`` are ``[L, K, hd]`` f32
    centroid stacks on the cache's device; ``qcache`` holds
    ``k_codes``/``v_codes`` ``[L, B, Sc, kv]`` and ``slot_pos``; ``pos`` an
    int or a 0-d tensor. Returns ``(logits [B, V], new qcache)``;
    ``qcache`` stays as it was."""
    _check_family(cfg)
    new = {key: val.clone() if key in ("k_codes", "v_codes", "slot_pos") else val
           for key, val in qcache.items()}
    return _decode_quantized_(cfg, params, kcb, vcb, new, token, int(pos)), new


def _quantized_step_fn(cfg, params, codebook: KVCodebook):
    dev = params_device(params)
    kcb = torch.from_numpy(codebook.k_centroids).to(dev)
    vcb = torch.from_numpy(codebook.v_centroids).to(dev)
    return lambda qc, t, pos: _decode_quantized_(cfg, params, kcb, vcb, qc, t, pos)


def _tokens(prompts, params) -> torch.Tensor:
    return torch.as_tensor(prompts, dtype=torch.int32, device=params_device(params))


@torch.inference_mode()
def generate_quantized(cfg, params: dict, codebook: KVCodebook, prompts, gen_len: int):
    """Greedy generation with the code-valued cache, the quantized twin of
    ``launch.serve.generate``: prefill raw, quantize once, then every
    decode step carries codes. Returns int32 ``[B, gen_len]``."""
    _check_family(cfg)
    prompts = _tokens(prompts, params)
    b, p = prompts.shape
    last_logits, cache = tf.prefill(cfg, params, prompts, max_seq_len=p + gen_len)
    qcache = quantize_cache(codebook, cache)
    del cache
    step = _quantized_step_fn(cfg, params, codebook)
    token = torch.argmax(last_logits, dim=-1).to(torch.int32)
    out = [token]
    for i in range(gen_len - 1):
        token = torch.argmax(step(qcache, token, p + i), dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)


@torch.inference_mode()
def teacher_forced_nll(cfg, params: dict, tokens, *, prompt_len: int,
                       codebook: KVCodebook | None = None) -> float:
    """Mean next-token NLL over positions ``prompt_len .. T-1``, teacher
    forced through the decode path (``exp`` of it is the perplexity).

    With ``codebook=None`` the raw ring-buffer cache serves (the fp
    baseline); with a codebook, the prefill cache is quantized once and
    every later step reads and writes codes. All variants see the same
    tokens, so the cache representation is the only difference."""
    tokens = _tokens(tokens, params)
    b, t = tokens.shape
    if not 0 < prompt_len < t:
        raise ValueError(f"prompt_len must be in (0, {t}), got {prompt_len}")
    last_logits, cache = tf.prefill(cfg, params, tokens[:, :prompt_len], max_seq_len=t)
    if codebook is None:
        def step(c, tok, pos):
            return tf._decode(cfg, params, c, tok, pos)
    else:
        cache = quantize_cache(codebook, cache)
        step = _quantized_step_fn(cfg, params, codebook)
    logits = last_logits
    nll = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(prompt_len, t):
        target = tokens[:, i]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = nll - logp.gather(1, target[:, None].long()).sum()
        if i < t - 1:
            logits = step(cache, target, i)
    return float(nll) / (b * (t - prompt_len))
