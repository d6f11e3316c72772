"""End-to-end LM training driver. Counterpart of ``repro.launch.train``.

Trains any assigned architecture (full or ``--reduced`` config) from
seeded random parameters on the deterministic ``TokenStream``, with AdamW
(``train.optimizer``), checkpoints every ``--ckpt-every`` steps and an
automatic resume from the newest step in ``--ckpt-dir``
(``train.checkpoint``, the reference's format). A vlm trains on zero image
embeddings, as the reference's driver does.

It runs on one device and builds no mesh: on one card every mesh
dimension (``"data"``, ``"model"``, ``"pod"``) has one rank, and the step
is the unsharded one, so it needs no process group (the reference enters
a one-device smoke mesh here, and computes parameter shardings it does not
use). A sharded step runs inside ``sharding.use_mesh`` on ranks the caller
starts (``train_step.make_train_step(param_shardings=...)``).
``--device`` defaults to ``cuda`` and raises without a card; the CPU runs
only when asked::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --reduced \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --ckpt-every 50 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    """Train; returns ``{"losses": [...], "final_loss": float or None}``
    (the losses of the steps this run took), which ``python -m`` prints as
    its last line, in JSON."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCHS, default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced_config(cfg)

    stream = TokenStream(cfg.vocab, args.seq, args.batch, seed=args.seed)
    params, opt_state = ts.init_train_state(cfg, rnd.key(args.seed), device=device)
    start_step = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, extra = ckpt.restore(args.ckpt_dir, last, {"params": params, "opt": opt_state},
                                        device=device)
            params, opt_state = state["params"], state["opt"]
            start_step = extra["step"]
            print(f"[train] resumed from step {start_step}")

    opt_cfg = opt.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                              total_steps=args.steps)
    step_fn = ts.make_train_step(cfg, opt_cfg)
    image = (torch.zeros((args.batch, cfg.n_image_tokens, cfg.d_model), dtype=cfg.dtype,
                         device=device) if cfg.family == "vlm" else None)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        tokens, labels = stream.batch(step, device=device)
        params, opt_state, metrics = step_fn(params, opt_state, tokens, labels, image)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"[train] step {step} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.time() - t0):.1f}s)"
            )
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                      extra={"step": step + 1, "arch": args.arch})
    return {"losses": losses, "final_loss": losses[-1] if losses else None}


if __name__ == "__main__":
    print(json.dumps(main()))
