"""The ranks of ``tests/test_torch_tp.py``: W gloo processes on the CPU,
each running the port's train and serve steps on its part of a
``("data", "model")`` mesh, and saving what it saw for the test to compare
with the reference's jitted steps on the same mesh. The cases, their
parameters and inputs come from ``_torch_fsdp_ranks`` (numpy and the port's
own initialisation), so the reference's side builds the same ones. This
module imports torch, numpy and the port only: the ranks import neither JAX
nor the reference.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch
from _torch_fsdp_ranks import B, OPT, S, collect, config, initial_params, inputs

DECODE_STEPS = 4  # 36 cache slots: they split over 2 and over 4 model ranks
MAX_SEQ = S + DECODE_STEPS

#: name -> (arch, (data ranks, model ranks), config overrides); each case
#: trains one step, then prefills [B, S] and decodes DECODE_STEPS tokens
CASES = {
    "dense12": ("qwen3-4b", (1, 2), {}),
    "dense22": ("qwen3-4b", (2, 2), {"remat": True}),
    "dense14": ("qwen3-4b", (1, 4), {}),  # 2 KV heads on 4 model ranks: GQA expanded
    "ep22": ("deepseek-moe-16b", (2, 2), {"capacity_factor": 1.0}),  # 4 experts, 2 a rank
    "ep_split14": ("deepseek-moe-16b", (1, 4), {"n_experts": 2, "top_k": 1,
                                               "capacity_factor": 1.0}),
    "tp12": ("deepseek-moe-16b", (1, 2), {"n_experts": 3, "capacity_factor": 1.0}),
}
#: cases trained again with the row-parallel sums left out
CONTROL_CASES = ("dense12", "tp12")
#: the case run twice: the same bits
AGAIN_CASE = "dense22"
#: vocab-parallel cross-entropy: [rows, positions, vocab] logits
CE_SHAPE, CE_VOCAB = (2, 6, 40), 37


def serve_tokens(cfg) -> tuple[np.ndarray, np.ndarray]:
    """The prompt ``[B, S]`` and the teacher-forced tokens ``[DECODE_STEPS, B]``."""
    rng = np.random.RandomState(4)
    return (rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.randint(0, cfg.vocab, (DECODE_STEPS, B)).astype(np.int32))


def ce_inputs() -> tuple[np.ndarray, np.ndarray]:
    """Logits (the padding columns from ``CE_VOCAB`` on) and labels of the
    vocab-parallel cross-entropy."""
    rng = np.random.RandomState(5)
    logits = (rng.randn(*CE_SHAPE) * 3).astype(np.float32)
    labels = rng.randint(0, CE_VOCAB, CE_SHAPE[:2]).astype(np.int64)
    return logits, labels


def spawn(world: int, out_dir: pathlib.Path, timeout: float):
    """Start ``world`` ranks; returns the context to ``collect``."""
    import torch.multiprocessing as mp

    out_dir.mkdir(parents=True, exist_ok=True)
    return mp.start_processes(
        _rank_main, args=(world, f"file://{out_dir}/rendezvous", str(out_dir)), nprocs=world,
        join=False, start_method="spawn",
    ), time.monotonic() + timeout


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _rows(cfg, arrays: dict) -> dict:
    """This rank's rows of the step inputs (``input_shardings``' layout)."""
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import params as layouts

    ts = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return fsdp.shard_tree(ts, layouts.input_shardings(cfg, ts))


def _model(name: str):
    """``(cfg, psh, params)``: a case's placements and this rank's shards."""
    from repro_torch import convert
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import params as layouts

    arch, _, overrides = CASES[name]
    cfg = config(arch, overrides)
    full = convert.params_from_numpy(initial_params(cfg), device="cpu")
    psh = layouts.param_shardings(cfg, full)
    return cfg, psh, fsdp.shard_tree(full, psh)


def train(name: str) -> dict:
    """One train step of a case: the loss, grad-norm, whole first moment
    and parameters, and the collectives it issued."""
    from repro_torch.distributed import fsdp
    from repro_torch.roofline import analysis
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg, psh, params = _model(name)
    rows = _rows(cfg, {"tokens": inputs(cfg, B)[0]})["tokens"]
    step = ts.make_train_step(cfg, opt.AdamWConfig(**OPT), param_shardings=psh)
    state = opt.adamw_init(params)
    analysis.collective_bytes(reset=True)
    params, state, m = step(params, state, rows, rows)
    counts = analysis.collective_bytes(reset=True)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "counts": counts,
            "params": _numpy(fsdp.full_tree(params, psh)),
            "m": _numpy(fsdp.full_tree(state["m"], psh))}


def serve(name: str) -> dict:
    """Prefill and teacher-forced decode of a case: this rank's logits
    (its rows, its vocabulary columns) at each step."""
    from repro_torch.models import transformer as tf

    cfg, psh, params = _model(name)
    prompt, forced = serve_tokens(cfg)
    rows = _rows(cfg, {"tokens": prompt})["tokens"]
    with torch.no_grad():
        logits, cache = tf.prefill(cfg, params, rows, max_seq_len=MAX_SEQ, param_shardings=psh)
        seen = [logits.numpy().copy()]
        slots = int(cache["k"].shape[2])
        for i, tok in enumerate(forced):
            logits, cache = tf.decode(cfg, params, cache, _rows(cfg, {"token": tok})["token"],
                                      S + i, param_shardings=psh)
            seen.append(logits.numpy().copy())
    return {"logits": seen, "slots": slots}


def control(name: str) -> float:
    """The loss of a train step whose row-parallel partials are not added
    over the model ranks (each rank keeps its own)."""
    from repro_torch.distributed import tp
    from repro_torch.models import transformer as tf

    real = tf._to_residual

    def unreduced(partial, par, dtype):
        return (tp._part(partial, 1) if par.seq else partial).to(dtype)

    tf._to_residual = unreduced
    try:
        return train(name)["loss"]
    finally:
        tf._to_residual = real


def vocab_parallel(world: int) -> dict:
    """On a ``(1, world)`` mesh: the vocab-parallel cross-entropy of this
    rank's columns and the gradient of its 1/M share (the train step's
    weighting), and the vocab-parallel embedding lookup of ids from every
    rank's rows with its gradient."""
    from repro_torch.distributed import fsdp, tp
    from repro_torch.distributed import params as layouts
    from repro_torch.models import transformer as tf
    from repro_torch.train import train_step as ts

    logits, labels = ce_inputs()
    cols = CE_SHAPE[-1] // world
    mine = torch.from_numpy(logits[..., tp.model_rank() * cols:(tp.model_rank() + 1) * cols])
    mine.requires_grad_()
    ce = ts.cross_entropy(mine, torch.from_numpy(labels), CE_VOCAB, vocab_parallel=True)
    (g,) = torch.autograd.grad(ce / world, [mine])
    cfg = config("qwen3-4b", {})
    table = torch.from_numpy(np.random.RandomState(6).randn(cfg.vocab_padded, cfg.d_model)
                             .astype(np.float32))
    place = layouts.param_shardings(cfg, {"embed": table})
    shard = fsdp.shard_tree({"embed": table}, place)["embed"].requires_grad_()
    ids = torch.from_numpy(np.random.RandomState(7).randint(0, cfg.vocab, (2, 8)))
    par = tf._Par(world, True)
    rows = tf._embed(cfg, {"embed": shard}, ids, place, par)
    (gt,) = torch.autograd.grad((rows * (1 + torch.arange(rows.numel()).view(rows.shape))).sum(),
                                [shard])
    return {"ce": float(ce.detach()), "ce_grad": g.numpy().copy(), "rows": rows.detach().numpy().copy(),
            "embed_grad": gt.numpy().copy()}


def run_checks(world: int) -> dict:
    """Everything a rank of a launch of ``world`` ranks does; returns its
    record."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as sh

    out: dict = {"train": {}, "serve": {}}
    for name, (_, shape, _) in CASES.items():
        if shape[0] * shape[1] != world:
            continue
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        with sh.use_mesh(mesh):
            out["train"][name] = train(name)
            out["serve"][name] = serve(name)
            if name == AGAIN_CASE:
                out["train"][name + "_again"] = train(name)
            if name in CONTROL_CASES:
                out.setdefault("control", {})[name] = control(name)
    with sh.use_mesh(init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))):
        out["vocab_parallel"] = vocab_parallel(world)
    return out


def _rank_main(rank: int, world: int, init: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        out = run_checks(world)
        out["rank"] = rank
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


__all__ = ["AGAIN_CASE", "CASES", "CONTROL_CASES", "DECODE_STEPS", "MAX_SEQ", "collect",
           "ce_inputs", "serve_tokens", "spawn"]
