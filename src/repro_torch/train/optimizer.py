"""AdamW with global-norm clipping, on the reference's formulas.
Counterpart of ``repro.train.optimizer``.

The state mirrors the parameter tree: ``{"m", "v", "step"}``, the moments
f32 and ``step`` an int32 0-d tensor, so ``train.checkpoint`` stores and
restores it in the reference's format. ``torch.optim.AdamW`` is not used:
it scales the weight decay by the learning rate apart from the Adam
direction, where the reference adds ``wd·p`` to the direction. Leaves are
taken in the reference's order (a dict's keys sorted), so the global norm
sums them as the reference does.

:func:`adamw_update` updates the parameters and the moments in place
(under ``torch.no_grad``) and returns them, the counterpart of the
reference's donated buffers: at full width a second copy of the tree would
not fit beside the first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict in the reference's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of trees shaped like it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``; f32 0-d."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any) -> dict:
    """Zero f32 moments shaped like ``params`` and ``step`` 0, on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(leaves(params)).device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ l²)`` in f32, the leaves summed in the reference's
    order."""
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / max(norm, 1e-9))`` (new
    tensors, each in its own dtype) and the norm before scaling."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params: Any, grads: Any, state: dict
) -> tuple[Any, dict, dict[str, torch.Tensor]]:
    """One AdamW step: the gradients clipped to ``cfg.clip_norm``, then
    ``p -= lr·(m̂/(√v̂ + eps) + wd·p)`` with ``m̂``, ``v̂`` bias-corrected by
    ``1 − b^step`` (``step`` counted from 1) in f32. Updates ``params``,
    ``state["m"]`` and ``state["v"]`` in place and returns
    ``(params, new state, {"grad_norm", "lr"})``."""
    # clip_by_global_norm's scale, applied a leaf at a time (no clipped copy of the tree)
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]), leaves(state["v"])):
        g = (g * scale).to(g.dtype).float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    metrics = {"grad_norm": norm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
