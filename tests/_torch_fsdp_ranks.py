"""The ranks of ``tests/test_torch_fsdp.py``: W processes on the CPU, one
gloo group over a ``file://`` rendezvous, each running the port's FSDP
train and serve steps on its shards and rows, and saving what it saw for
the test to compare with the reference's jitted steps. The cases, their
parameters and their inputs are defined here, from numpy and the port's own
initialisation, so that the reference's side builds the same ones. This
module imports torch, numpy and the port only, so the ranks import neither
JAX nor the reference.
"""

from __future__ import annotations

import pathlib
import threading
import time

import numpy as np
import torch

B, S = 4, 32  # the global batch; S is two SSD chunks of 16 and one attention chunk
DECODE_STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=0)

#: name -> (arch, W, config overrides, global batch)
TRAIN_CASES = {
    "dense2": ("qwen3-4b", 2, {}, B),
    "moe2": ("deepseek-moe-16b", 2, {"capacity_factor": 1.0}, B),  # tokens drop
    "audio2": ("musicgen-medium", 2, {}, B),
    "ssm2": ("mamba2-130m", 2, {}, B),
    "hybrid2": ("zamba2-1.2b", 2, {}, B),
    "vlm2": ("llama-3.2-vision-90b", 2, {"remat": True}, B),
    "dense4": ("qwen3-4b", 4, {"remat": True}, B),
    "moe4": ("deepseek-moe-16b", 4, {}, B),
    "accum2": ("qwen3-4b", 2, {"grad_accum": 2}, B),
    "batch3": ("qwen3-4b", 2, {}, 3),  # W does not divide B: every rank runs it whole
}
#: name -> (arch, W, config overrides): prefill [B, S], then DECODE_STEPS tokens
SERVE_CASES = {
    "dense2": ("qwen3-4b", 2, {}),
    "moe2": ("deepseek-moe-16b", 2, {"capacity_factor": 1.0}),
}
#: the other families' serving seams, held against the port's one-rank run
SERVE_FAMILIES = {
    "ssm2": ("mamba2-130m", 2, {}),
    "hybrid2": ("zamba2-1.2b", 2, {}),
    "vlm2": ("llama-3.2-vision-90b", 2, {}),
}
CKPT_CASE = "dense2"
#: ``fsdp.lookup``'s two branches: a rank looks up fewer ids than the
#: table's rows (the rows move) and more (the table moves)
LOOKUP_ROWS, LOOKUP_DIM, LOOKUP_IDS = 40, 8, (10, 50)


def lookup_inputs(world: int, rank: int, n: int):
    """The table ``[LOOKUP_ROWS, LOOKUP_DIM]``, this rank's ``n`` ids (with
    repeats) and the cotangent of its rows."""
    table = np.random.RandomState(3).randn(LOOKUP_ROWS, LOOKUP_DIM).astype(np.float32)
    rng = np.random.RandomState(100 * world + 10 * rank + n)
    return (table, rng.randint(0, LOOKUP_ROWS, n).astype(np.int64),
            rng.randn(n, LOOKUP_DIM).astype(np.float32))


def config(arch: str, overrides: dict):
    from repro_torch import configs

    return configs.reduced_config(configs.get_config(arch)).replace(**overrides)


def _stress(tree: dict, rng) -> dict:
    """Seeded decay rates and step biases, no skip term, open gates and a
    router 20 times its initial scale, so that gradients run through the
    SSD state and the cross-attention, and the MoE routes unevenly enough
    for capacity to drop tokens."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _stress(v, rng)
        elif k in ("a_log", "dt_bias"):
            out[k] = rng.uniform(-3.0, -1.0, v.shape).astype(v.dtype)
        elif k == "d_skip":
            out[k] = np.zeros_like(v)
        elif k in ("gate_attn", "gate_mlp"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        elif k == "router":
            out[k] = v * 20
        else:
            out[k] = v
    return out


def initial_params(cfg) -> dict:
    """The parameters of a case as numpy: the port's initialisation from
    key 0, stressed."""
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.models import transformer

    p = transformer.init_params(cfg, rnd.key(0), device="cpu")
    return _stress(convert.params_to_numpy(p), np.random.RandomState(7))


def inputs(cfg, batch: int) -> tuple[np.ndarray, np.ndarray | None]:
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (batch, S)).astype(np.int32)
    img = (np.random.RandomState(1).randn(batch, cfg.n_image_tokens, cfg.d_model)
           .astype(np.float32) * 0.5 if cfg.family == "vlm" else None)
    return toks, img


def serve_inputs(cfg) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """The prompt ``[B, S]``, the teacher-forced tokens ``[DECODE_STEPS,
    B]`` and a vlm's image embeddings."""
    rng = np.random.RandomState(2)
    return (rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.randint(0, cfg.vocab, (DECODE_STEPS, B)).astype(np.int32),
            inputs(cfg, B)[1])


def spawn(world: int, out_dir: pathlib.Path, ckpt_dir: pathlib.Path, timeout: float):
    """Start ``world`` ranks; returns the context to :func:`collect`."""
    import torch.multiprocessing as mp

    out_dir.mkdir(parents=True, exist_ok=True)
    init = f"file://{out_dir}/rendezvous"
    return mp.start_processes(
        _rank_main, args=(world, init, str(out_dir), str(ckpt_dir), timeout), nprocs=world,
        join=False, start_method="spawn",
    ), time.monotonic() + timeout


def collect(started, out_dir: pathlib.Path) -> list[dict]:
    """Join the ranks under the deadline (a hang fails: every rank is
    terminated) and load each one's record."""
    ctx, deadline = started
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"the ranks did not finish in time: {out_dir}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(len(ctx.processes))]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _rows(cfg, **arrays):
    """This rank's rows of the step inputs (``input_shardings``' layout)."""
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import params as layouts

    ts = {k: torch.from_numpy(v) for k, v in arrays.items() if v is not None}
    return fsdp.shard_tree(ts, layouts.input_shardings(cfg, ts))


def _state_places(psh):
    from torch.distributed.tensor import Replicate

    return {"params": psh, "opt": {"m": psh, "v": psh, "step": (Replicate(),)}}


def _train(name: str):
    """``(cfg, psh, step, params, state, rows)`` of a train case, the
    parameters and the AdamW state as this rank's shards."""
    from repro_torch import convert
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import params as layouts
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    arch, _, overrides, batch = TRAIN_CASES[name]
    cfg = config(arch, overrides)
    full = convert.params_from_numpy(initial_params(cfg), device="cpu")
    psh = layouts.param_shardings(cfg, full)
    params = fsdp.shard_tree(full, psh)
    toks, img = inputs(cfg, batch)
    rows = _rows(cfg, tokens=toks, image_embeds=img)
    step = ts.make_train_step(cfg, opt.AdamWConfig(**OPT), param_shardings=psh)
    return cfg, psh, step, params, opt.adamw_init(params), rows


def _run(step, params, state, rows):
    from repro_torch.roofline import analysis

    analysis.collective_bytes(reset=True)
    params, state, m = step(params, state, rows["tokens"], rows["tokens"],
                            rows.get("image_embeds"))
    return params, state, m, analysis.collective_bytes(reset=True)


def _whole(params, state, psh) -> dict:
    from repro_torch.distributed import fsdp

    return {"params": _numpy(fsdp.full_tree(params, psh)),
            "m": _numpy(fsdp.full_tree(state["m"], psh)),
            "v": _numpy(fsdp.full_tree(state["v"], psh))}


def lookup_checks(world: int, rank: int) -> dict:
    """``fsdp.lookup``'s rows and the gradient of this rank's shard of the
    table, for each count of ids."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import fsdp

    out = {}
    for n in LOOKUP_IDS:
        table, ids, co = lookup_inputs(world, rank, n)
        place = (Shard(1),)
        shard = fsdp.shard_tree(torch.from_numpy(table), place).requires_grad_()
        rows = fsdp.lookup(config("qwen3-4b", {}), shard, place, torch.from_numpy(ids))
        (grad,) = torch.autograd.grad((rows * torch.from_numpy(co)).sum(), [shard])
        out[n] = (rows.detach().numpy().copy(), grad.numpy().copy())
    return out


def backward_elsewhere(name: str) -> bool:
    """Whether a case's gradients are the same bits with the backward run on
    a thread that has no mesh, as a CUDA backward runs on the autograd
    engine's thread (with remat, the recompute gathers there too)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg, psh, _, params, _, rows = _train(name)

    def grads(elsewhere: bool):
        live = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = ts.loss_fn(cfg, live, rows["tokens"], rows["tokens"], rows.get("image_embeds"),
                             param_shardings=psh)
        out = {}
        run = lambda: out.update(g=torch.autograd.grad(loss, list(opt.leaves(live))))
        if elsewhere:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            run()
        return out["g"]

    return all(torch.equal(a, b) for a, b in zip(grads(False), grads(True), strict=True))


def _checkpoint_checks(world: int, ckpt_dir: pathlib.Path, deadline: float) -> dict:
    """W = 2 saves its step-1 state, steps on, and restores it; W = 4
    waits for that checkpoint and restores it. Both step once from the
    restored state."""
    from repro_torch import random as rnd
    from repro_torch.distributed import fsdp
    from repro_torch.models import transformer
    from repro_torch.train import checkpoint

    cfg, psh, step, params, state, rows = _train(CKPT_CASE)
    places = _state_places(psh)
    out: dict = {}
    if world == 2:
        params, state, *_ = _run(step, params, state, rows)
        checkpoint.save(ckpt_dir, 1, {"params": params, "opt": state}, shardings=places)
        params, state, *_ = _run(step, params, state, rows)
        out["uninterrupted"] = _numpy(fsdp.full_tree(params, psh))
    else:
        while not (ckpt_dir / "step_00000001").exists():
            if time.monotonic() > deadline:
                raise TimeoutError("no W = 2 checkpoint to restore")
            time.sleep(0.05)
    whole = transformer.init_params(cfg, rnd.key(0), device="meta")
    template = {"params": whole, "opt": {"m": whole, "v": whole,
                                         "step": torch.zeros((), dtype=torch.int32,
                                                             device="meta")}}
    restored, _ = checkpoint.restore(ckpt_dir, 1, template, places, device="cpu")
    out["restored"] = _numpy(restored)
    params, state, *_ = _run(step, restored["params"], restored["opt"], rows)
    out["after_restore"] = _numpy(fsdp.full_tree(params, psh))
    return out


def run_checks(world: int, rank: int, ckpt_dir: pathlib.Path, deadline: float) -> dict:
    """Everything a rank does, under the mesh; returns its record."""
    from repro_torch.distributed import fsdp
    from repro_torch.models import transformer as tf

    out: dict = {"rank": rank, "train": {}, "serve": {}, "lookup": lookup_checks(world, rank)}
    if world == 2:  # first: the W = 4 ranks wait for its checkpoint
        out["ckpt"] = _checkpoint_checks(world, ckpt_dir, deadline)
        out["backward_elsewhere"] = backward_elsewhere("vlm2")
    for name, (_, w, _, _) in TRAIN_CASES.items():
        if w != world:
            continue
        cfg, psh, step, params, state, rows = _train(name)
        params, state, m, counts = _run(step, params, state, rows)
        out["train"][name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                              "counts": counts, **_whole(params, state, psh)}
        if name == "dense2":  # the same step again from the same state: the same bits
            cfg, psh, step, params, state, rows = _train(name)
            params, state, m, _ = _run(step, params, state, rows)
            out["train"]["dense2_again"] = {"loss": float(m["loss"]), **_whole(params, state, psh)}
    for name, (arch, w, overrides) in {**SERVE_CASES, **SERVE_FAMILIES}.items():
        if w != world:
            continue
        from repro_torch import convert
        from repro_torch.distributed import params as layouts

        cfg = config(arch, overrides)
        full = convert.params_from_numpy(initial_params(cfg), device="cpu")
        psh = layouts.param_shardings(cfg, full)
        params = fsdp.shard_tree(full, psh)
        prompt, forced, img = serve_inputs(cfg)
        rows = _rows(cfg, tokens=prompt, image_embeds=img)
        forced = [_rows(cfg, token=t)["token"] for t in forced]
        with torch.no_grad():
            logits, cache = tf.prefill(cfg, params, rows["tokens"], rows.get("image_embeds"),
                                       max_seq_len=S + DECODE_STEPS, param_shardings=psh)
            seen = [logits.numpy().copy()]
            for i, tok in enumerate(forced):
                logits, cache = tf.decode(cfg, params, cache, tok, S + i, param_shardings=psh)
                seen.append(logits.numpy().copy())
        out["serve"][name] = {"logits": seen, "rows": int(seen[-1].shape[0])}
    if world == 4:
        out["ckpt"] = _checkpoint_checks(world, ckpt_dir, deadline)
    return out


def _rank_main(rank: int, world: int, init: str, out_dir: str, ckpt_dir: str,
               timeout: float) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as sh

    deadline = time.monotonic() + timeout
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        with sh.use_mesh(mesh):
            out = run_checks(world, rank, pathlib.Path(ckpt_dir), deadline)
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
