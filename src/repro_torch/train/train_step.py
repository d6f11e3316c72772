"""Train step: next-token cross-entropy and AdamW. Counterpart of
``repro.train.train_step``.

The loss is the reference's: f32 logits, the padding columns at or past
``vocab`` masked to −1e30 out of the logsumexp, the label logit taken as a
masked sum over the vocabulary, plus ``0.01·aux`` (the MoE load-balance
term). Gradients come from autograd through ``models.transformer.forward``
(the flash backward of ``models.layers._Flash``, the Mamba2 SSD and the
MoE dispatch), with ``cfg.remat``'s per-layer checkpoints.

:func:`make_train_step`'s step updates the parameters and the optimizer
state in place and returns them (the reference's step donates both); the
parameters need not require gradients, the step takes them through
detached aliases of their storage.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import random as rnd
from repro_torch.configs import ArchConfig
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt

__all__ = ["cross_entropy", "loss_fn", "make_train_step", "init_train_state"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """Mean next-token CE. logits [B, S, Vp] (f32), labels [B, S] int.

    Columns ``>= vocab`` (the 256-padding) are masked out of the
    logsumexp; the label logit is ``sum(logits · onehot)``."""
    logits = logits.float()
    vp = logits.shape[-1]
    col = torch.arange(vp, device=logits.device)
    if vocab is not None and vocab < vp:
        logits = torch.where(col < vocab, logits, -1e30)
    shifted = logits[:, :-1]
    targets = labels[:, 1:].long()
    lse = torch.logsumexp(shifted, dim=-1)
    onehot = targets[..., None] == col
    label_logit = torch.sum(torch.where(onehot, shifted, 0.0), dim=-1)
    return torch.mean(lse - label_logit)


def loss_fn(cfg: ArchConfig, params, tokens, labels, image_embeds=None):
    """``(ce + 0.01·aux, {"ce", "aux"})`` of ``forward``'s logits."""
    logits, aux, _ = transformer.forward(cfg, params, tokens, image_embeds)
    ce = cross_entropy(logits, labels, vocab=cfg.vocab)
    loss = ce + 0.01 * aux  # MoE load-balance coefficient (GShard-style)
    return loss, {"ce": ce, "aux": aux}


def init_train_state(cfg: ArchConfig, key: rnd.Key, *, device: str | torch.device = "cuda"):
    """``(params, adamw_init(params))`` from ``transformer.init_params``."""
    params = transformer.init_params(cfg, key, device=device)
    return params, opt.adamw_init(params)


def make_train_step(cfg: ArchConfig, opt_cfg: opt.AdamWConfig | None = None, param_shardings=None):
    """``train_step(params, opt_state, tokens, labels, image_embeds=None)
    -> (params, opt_state, metrics)``.

    With ``cfg.grad_accum > 1`` the batch splits into that many
    micro-batches (the vlm's ``image_embeds`` with it); their gradients are
    summed in f32 in micro-batch order and divided by the count, and so is
    the loss. ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d
    tensors.

    ``param_shardings`` pins the reference's gradient accumulator to the
    parameters' FSDP × TP layout; the port's mesh has only the ``"data"``
    dimension, so the only layout is the replicated one and the argument
    must be ``None``."""
    if param_shardings is not None:
        raise ValueError(
            "make_train_step(param_shardings=...) pins gradients to an FSDP × tensor layout; "
            "the port's mesh has only the 'data' dimension (no model axis), so parameters and "
            "gradients are replicated and param_shardings must be None"
        )
    opt_cfg = opt_cfg or opt.AdamWConfig()
    accum = max(1, cfg.grad_accum)

    def grad_of(params, tokens, labels, image_embeds):
        live = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
        img = image_embeds if cfg.family == "vlm" else None
        loss, _ = loss_fn(cfg, live, tokens, labels, img)
        grads = torch.autograd.grad(loss, list(opt.leaves(live)), allow_unused=True)
        flat = iter(g if g is not None else torch.zeros_like(p)
                    for g, p in zip(grads, opt.leaves(live)))
        # leaves() walks the sorted keys, so rebuild the tree in that order
        return loss.detach(), _unflatten(params, flat)

    def train_step(params, opt_state, tokens, labels, image_embeds=None):
        if accum == 1:
            loss, grads = grad_of(params, tokens, labels, image_embeds)
        else:
            b = tokens.shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} micro-batches")
            mb = b // accum
            grads, loss = None, 0.0
            for i in range(accum):
                rows = slice(i * mb, (i + 1) * mb)
                img = image_embeds[rows] if cfg.family == "vlm" else None
                loss_i, g_i = grad_of(params, tokens[rows], labels[rows], img)
                if grads is None:
                    grads = opt.tree_map(lambda g: g.float(), g_i)
                else:
                    opt.tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
                loss = loss + loss_i
                del g_i
            grads = opt.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        params, opt_state, metrics = opt.adamw_update(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _unflatten(tree: Any, flat) -> Any:
    """A tree shaped like ``tree`` with leaves from ``flat`` in the
    reference's leaf order."""
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], flat) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return next(flat)
