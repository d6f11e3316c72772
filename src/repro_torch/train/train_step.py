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

With ``param_shardings`` (inside ``sharding.use_mesh``) the step is the
reference's jitted step on a ``"data"`` mesh of W ranks, run as FSDP
(``distributed.fsdp``): parameters and AdamW moments are this rank's
shards, the inputs its rows (``distributed.params.input_shardings``: B/W
where W divides B, else the whole batch on every rank). Each layer is
gathered where it runs; the gradient of a sharded leaf comes back from the
backward as this rank's slice of the mean over ranks (once a
micro-batch, the f32 accumulator held as shards), and the replicated
leaves' gradients and the loss are averaged over the ranks in one f32
all-reduce a step. The loss is so the mean over ranks of the ranks'
losses, the MoE's load-balance term (sized and routed on the rank's
tokens) included, as the reference's ``"ep"`` island averages it (``pmean``).

On a mesh with a ``"model"`` dimension of M > 1 ranks (the dense and moe
families; ``models.transformer``'s model axis) the logits are the rank's
vocabulary columns and :func:`cross_entropy` is vocab-parallel: the row
max, the sum of exponentials and the label's logit (taken on the rank that
holds its column) are reduced over the model ranks. Each rank's loss is
``(ce + 0.01·aux) / M``, and every collective's backward is its adjoint,
so a rank's gradients are those of the sum of the model ranks' losses: the
gradients of the leaves whole over ``"model"`` are added over those ranks
(with the loss, in one f32 all-reduce), then averaged over the batch ranks
as above.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import random as rnd
from repro_torch.configs import ArchConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed import params as layouts
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tp
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt

__all__ = ["cross_entropy", "loss_fn", "make_train_step", "init_train_state"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int | None = None, *,
                  vocab_parallel: bool = False) -> torch.Tensor:
    """Mean next-token CE. logits [B, S, Vp] (f32), labels [B, S] int.

    Columns ``>= vocab`` (the 256-padding) are masked out of the
    logsumexp; the label logit is ``sum(logits · onehot)``. With
    ``vocab_parallel`` the logits are this model rank's ``Vp/M`` columns
    (rank r's from ``r·Vp/M``): the row max, the sum of exponentials and
    the label logit are reduced over the model ranks, and every rank
    returns the same CE. Its backward is the adjoint of those reductions,
    so a rank's gradient is that of the sum of the ranks' CEs: the train
    step weights each by 1/M."""
    logits = logits.float()
    vp = logits.shape[-1]
    first = tp.model_rank() * vp if vocab_parallel else 0
    col = torch.arange(vp, device=logits.device)
    if vocab_parallel:
        col = col + first
    if vocab is not None and vocab < first + vp:
        logits = torch.where(col < vocab, logits, -1e30)
    shifted = logits[:, :-1]
    targets = labels[:, 1:].long()
    if not vocab_parallel:
        lse = torch.logsumexp(shifted, dim=-1)
    onehot = targets[..., None] == col
    label_logit = torch.sum(torch.where(onehot, shifted, 0.0), dim=-1)
    if not vocab_parallel:
        return torch.mean(lse - label_logit)
    top = tp.all_max(shifted.amax(-1))
    sums = tp.all_sum(torch.stack([torch.exp(shifted - top[..., None]).sum(-1), label_logit]))
    return torch.mean(torch.log(sums[0]) + top - sums[1])


def loss_fn(cfg: ArchConfig, params, tokens, labels, image_embeds=None, *, param_shardings=None):
    """``(ce + 0.01·aux, {"ce", "aux"})`` of ``forward``'s logits (this
    rank's, with ``param_shardings``; on the model axis the loss is
    divided by its M ranks, the module docstring)."""
    logits, aux, _ = transformer.forward(cfg, params, tokens, image_embeds,
                                         param_shardings=param_shardings)
    m = tp.model_size() if param_shardings is not None else 1
    ce = cross_entropy(logits, labels, vocab=cfg.vocab,
                       vocab_parallel=m > 1 and tp.divides(cfg.vocab_padded))
    loss = ce + 0.01 * aux  # MoE load-balance coefficient (GShard-style)
    if m > 1:
        loss = loss / m
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

    ``param_shardings`` is ``distributed.params.param_shardings``' tree of
    the parameters, made inside ``use_mesh(mesh)``, where the step must be
    made and run: the step is then the FSDP step of the module docstring,
    on this rank's shards of the parameters and of the AdamW state and on
    its rows. It raises outside a mesh, on another placement tree, and on
    leaves that are not this rank's shards; it never runs on whole
    parameters in their place. On a mesh of one rank, shards are whole and
    the step is the unsharded one."""
    shards = _shard_shapes(cfg, param_shardings)
    opt_cfg = opt_cfg or opt.AdamWConfig()
    accum = max(1, cfg.grad_accum)
    ps = param_shardings if shards is not None and fsdp.active() else None

    def grad_of(params, tokens, labels, image_embeds):
        live = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
        img = image_embeds if cfg.family == "vlm" else None
        loss, _ = loss_fn(cfg, live, tokens, labels, img, param_shardings=ps)
        grads = torch.autograd.grad(loss, list(opt.leaves(live)), allow_unused=True)
        flat = iter(g if g is not None else torch.zeros_like(p)
                    for g, p in zip(grads, opt.leaves(live)))
        # leaves() walks the sorted keys, so rebuild the tree in that order
        return loss.detach(), _unflatten(params, flat)

    def train_step(params, opt_state, tokens, labels, image_embeds=None):
        if shards is not None:
            got = [tuple(t.shape) for t in opt.leaves(params)]
            if got != shards:
                raise ValueError(f"the parameters are not this rank's shards under "
                                 f"param_shardings: {got} against {shards}")
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
        if ps is not None:
            loss = _sum_model_replicated(grads, ps, loss)
            loss = _mean_replicated(grads, ps, loss)
        params, opt_state, metrics = opt.adamw_update(opt_cfg, params, grads, opt_state, ps)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _shard_shapes(cfg: ArchConfig, param_shardings) -> list[tuple[int, ...]] | None:
    """The shapes of this rank's shards in leaf order, from the layout of
    a tree of ``cfg``'s shapes on the meta device; ``None`` without
    ``param_shardings``. Raises outside a mesh and where
    ``param_shardings`` is not that layout."""
    if param_shardings is None:
        return None
    if sh.current_mesh() is None:
        raise ValueError("make_train_step(param_shardings=...) lays the parameters out on the "
                         "'data' mesh: make and run the step inside sharding.use_mesh(mesh)")
    whole = transformer.init_params(cfg, rnd.key(0), device="meta")
    if param_shardings != layouts.param_shardings(cfg, whole):
        raise ValueError("param_shardings is not distributed.params.param_shardings(cfg, params) "
                         "on the current mesh")
    return [tuple(t.shape) for t in opt.leaves(fsdp.shard_tree(whole, param_shardings))]


def _sum_model_replicated(grads: Any, ps: Any, loss: torch.Tensor) -> torch.Tensor:
    """The gradients of the leaves whole over ``"model"`` (in place) and
    ``loss`` (returned) added over the model ranks in rank order, in one
    f32 all-reduce; as they are on one model rank."""
    if not tp.active():
        return loss
    rep = [g for g, p in zip(opt.leaves(grads), opt.leaves(ps), strict=True)
           if fsdp.model_dim(p) is None]
    flat = tp._sum(torch.cat([*(g.reshape(-1).float() for g in rep), loss.reshape(1).float()]),
                   "all-reduce", torch.float32)
    return _put_back(rep, flat)


def _mean_replicated(grads: Any, ps: Any, loss: torch.Tensor) -> torch.Tensor:
    """The gradients of the leaves whole over the batch axes (in place) and
    ``loss`` (returned) averaged over the batch ranks in one f32
    all-reduce; as they are on one batch rank."""
    if fsdp.world() == 1:
        return loss
    rep = [g for g, p in zip(opt.leaves(grads), opt.leaves(ps), strict=True)
           if fsdp.batch_dim(p) is None]
    flat = fsdp.mean_over_ranks(torch.cat([*(g.reshape(-1).float() for g in rep),
                                           loss.reshape(1).float()]))
    return _put_back(rep, flat)


def _put_back(rep: list, flat: torch.Tensor) -> torch.Tensor:
    """``flat``'s values copied into the tensors of ``rep`` in order; its
    last value returned."""
    i = 0
    for g in rep:
        g.copy_(flat[i : i + g.numel()].view(g.shape))
        i += g.numel()
    return flat[i].clone()


def _unflatten(tree: Any, flat) -> Any:
    """A tree shaped like ``tree`` with leaves from ``flat`` in the
    reference's leaf order."""
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], flat) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return next(flat)
