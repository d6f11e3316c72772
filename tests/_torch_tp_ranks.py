"""The ranks of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py``: W gloo processes on the CPU,
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
#: the audio, ssm, hybrid and vlm families (``tests/test_torch_tp_families.py``)
FAMILY_CASES = {
    "ssm12": ("mamba2-130m", (1, 2), {}),
    "ssm22": ("mamba2-130m", (2, 2), {}),
    "hybrid12": ("zamba2-1.2b", (1, 2), {"remat": True}),
    "vlm14": ("llama-3.2-vision-90b", (1, 4), {}),  # 2 KV heads on 4 model ranks: expanded
    "audio14": ("musicgen-medium", (1, 4), {"n_heads": 6}),  # 6 heads on 4 ranks: whole
    "odd12": ("qwen3-4b", (1, 2), {}),  # serves only, over a cache of MAX_SEQ + 1 slots
}
#: the cases that only serve, and the session length of their cache (its
#: slots do not split over the model ranks: each rank holds them whole)
SERVE_ONLY = {"odd12": MAX_SEQ + 1}
#: the ssm case trained again with out_proj's partials left unreduced, and
#: with the gated norm over each rank's own heads only
FAMILY_CONTROLS = ("out_proj", "norm")
FAMILY_CONTROL_CASE = "ssm12"
#: cases trained again with the row-parallel sums left out
CONTROL_CASES = ("dense12", "tp12")
#: the case run twice: the same bits
AGAIN_CASE = "dense22"
#: vocab-parallel cross-entropy: [rows, positions, vocab] logits
CE_SHAPE, CE_VOCAB = (2, 6, 40), 37


#: the Mamba layers' scales in the ssm cases: at the initial scale (std
#: 0.02) a layer's gated-norm rows have a mean square near 1e-17, far below
#: rmsnorm's eps of 1e-6, so the norm is the constant 1/√eps whatever the
#: sums of squares (and its control could not miss); with ``in_proj`` and
#: ``conv_w`` scaled it is near 0.05. The hybrid keeps the initial scale:
#: scaled, its shared block's ``wk`` gradient falls to about 10 × AdamW's eps,
#: where the first step's lr·g/(|g| + eps) turns on f32's order of sums
MAMBA_SCALE = {"in_proj": 5.0, "conv_w": 30.0}
MAMBA_SCALED = ("ssm12", "ssm22")


def case_params(name: str) -> dict:
    """A case's parameters as numpy (``initial_params``), the Mamba layers
    of the cases :data:`MAMBA_SCALED` scaled by :data:`MAMBA_SCALE`."""
    arch, _, overrides = case(name)
    params = initial_params(config(arch, overrides))

    def scale(tree, under_mamba=False):
        for k, v in tree.items():
            if isinstance(v, dict):
                scale(v, under_mamba or k == "mamba")
            elif under_mamba and k in MAMBA_SCALE:
                tree[k] = v * MAMBA_SCALE[k]

    if name in MAMBA_SCALED:
        scale(params)
    return params


def case(name: str) -> tuple:
    """``(arch, (data ranks, model ranks), overrides)`` of a case of either
    table."""
    return {**CASES, **FAMILY_CASES}[name]


def max_seq(name: str) -> int:
    """The session length a case's cache is made for."""
    return SERVE_ONLY.get(name, MAX_SEQ)


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


def spawn(world: int, out_dir: pathlib.Path, timeout: float, families: bool = False):
    """Start ``world`` ranks on the cases of :data:`CASES`, or with
    ``families`` of :data:`FAMILY_CASES`; returns the context to
    ``collect``."""
    import torch.multiprocessing as mp

    out_dir.mkdir(parents=True, exist_ok=True)
    return mp.start_processes(
        _rank_main, args=(world, f"file://{out_dir}/rendezvous", str(out_dir), families),
        nprocs=world, join=False, start_method="spawn",
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

    arch, _, overrides = case(name)
    cfg = config(arch, overrides)
    full = convert.params_from_numpy(case_params(name), device="cpu")
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
    toks, img = inputs(cfg, B)
    rows = _rows(cfg, {"tokens": toks, **({} if img is None else {"image_embeds": img})})
    step = ts.make_train_step(cfg, opt.AdamWConfig(**OPT), param_shardings=psh)
    state = opt.adamw_init(params)
    analysis.collective_bytes(reset=True)
    params, state, m = step(params, state, rows["tokens"], rows["tokens"],
                            rows.get("image_embeds"))
    counts = analysis.collective_bytes(reset=True)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "counts": counts,
            "params": _numpy(fsdp.full_tree(params, psh)),
            "m": _numpy(fsdp.full_tree(state["m"], psh))}


def serve(name: str) -> dict:
    """Prefill and teacher-forced decode of a case: this rank's logits
    (its rows, its vocabulary columns) and the collectives it issued at
    each step, its cache's slots and Mamba heads."""
    from repro_torch.models import transformer as tf
    from repro_torch.roofline import analysis

    cfg, psh, params = _model(name)
    prompt, forced = serve_tokens(cfg)
    img = inputs(cfg, B)[1]
    rows = _rows(cfg, {"tokens": prompt, **({} if img is None else {"image_embeds": img})})
    counts = []
    with torch.no_grad():
        analysis.collective_bytes(reset=True)
        logits, cache = tf.prefill(cfg, params, rows["tokens"], rows.get("image_embeds"),
                                   max_seq_len=max_seq(name), param_shardings=psh)
        counts.append(analysis.collective_bytes(reset=True))
        seen = [logits.numpy().copy()]
        slots = int(cache["slot_pos"].shape[1]) if "slot_pos" in cache else None
        for i, tok in enumerate(forced):
            logits, cache = tf.decode(cfg, params, cache, _rows(cfg, {"token": tok})["token"],
                                      S + i, param_shardings=psh, max_seq_len=max_seq(name))
            counts.append(analysis.collective_bytes(reset=True))
            seen.append(logits.numpy().copy())
    mamba = cache.get("mamba", cache)
    return {"logits": seen, "slots": slots, "counts": counts,
            "ssm_heads": int(mamba["ssm"].shape[2]) if "ssm" in mamba else None}


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


def family_control(name: str, which: str) -> dict:
    """:func:`train`'s record of a Mamba case's step with ``out_proj``'s
    partials left unreduced over the model ranks (each rank keeps its own),
    or with the gated norm taken over each rank's own heads only."""
    from repro_torch.distributed import tp
    from repro_torch.models import layers, mamba2
    from repro_torch.models import transformer as tf

    owner, attr = (tf, "_mamba_out") if which == "out_proj" else (mamba2, "_gated_norm")
    real = getattr(owner, attr)
    if which == "out_proj":
        fake = lambda cfg, out, par, dtype: (tp._part(out, 1) if par.seq else out).to(dtype)
    else:
        fake = lambda g, w, d_inner: layers.rmsnorm(g, w)
    setattr(owner, attr, fake)
    try:
        return train(name)
    finally:
        setattr(owner, attr, real)


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
    par = tf._par(cfg, place, ids.shape[1])  # the sequence of 8 split over the ranks
    rows = tf._embed(cfg, {"embed": shard}, ids, place, par)
    (gt,) = torch.autograd.grad((rows * (1 + torch.arange(rows.numel()).view(rows.shape))).sum(),
                                [shard])
    return {"ce": float(ce.detach()), "ce_grad": g.numpy().copy(), "rows": rows.detach().numpy().copy(),
            "embed_grad": gt.numpy().copy()}


def run_checks(world: int, families: bool = False) -> dict:
    """Everything a rank of a launch of ``world`` ranks does (on
    :data:`FAMILY_CASES` with ``families``); returns its record."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as sh

    out: dict = {"train": {}, "serve": {}}
    for name, (_, shape, _) in (FAMILY_CASES if families else CASES).items():
        if shape[0] * shape[1] != world:
            continue
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        with sh.use_mesh(mesh):
            if name not in SERVE_ONLY:
                out["train"][name] = train(name)
            out["serve"][name] = serve(name)
            if name == AGAIN_CASE:
                out["train"][name + "_again"] = train(name)
            if name in CONTROL_CASES:
                out.setdefault("control", {})[name] = control(name)
            if families and name == FAMILY_CONTROL_CASE:
                out["control"] = {w: family_control(name, w) for w in FAMILY_CONTROLS}
    if not families:
        with sh.use_mesh(init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))):
            out["vocab_parallel"] = vocab_parallel(world)
    return out


def _rank_main(rank: int, world: int, init: str, out_dir: str, families: bool) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        out = run_checks(world, families)
        out["rank"] = rank
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


__all__ = ["AGAIN_CASE", "CASES", "CONTROL_CASES", "DECODE_STEPS", "FAMILY_CASES",
           "FAMILY_CONTROLS", "FAMILY_CONTROL_CASE", "MAX_SEQ", "SERVE_ONLY", "case", "case_params",
           "collect",
           "ce_inputs", "max_seq", "serve_tokens", "spawn"]
