"""The dry run: trace every (architecture × input shape) cell's step on the
meta device against the production mesh, and record per-device FLOPs,
bytes, collective bytes and a peak-memory estimate for the report
(``repro_torch.roofline.report``).

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
with XLA against 256 or 512 forced host devices. The port compiles nothing:
it starts a fake process group of W ranks (``torch.distributed``'s ``fake``
backend, no device and no communication), builds the mesh over it, lays
parameters, optimizer state and inputs out with ``distributed.params``, and
runs the cell's step once on meta tensors, which carry shapes and dtypes
and no storage. Every config runs on the reference's production mesh,
``launch.mesh.make_production_mesh`` (``16x16``, ``("data", "model")``;
``2x16x16`` with ``--multi-pod``). The step:

* train: ``train_step.make_train_step(cfg, param_shardings=...)``'s step
  (loss, gradients with ``cfg.remat``'s checkpoints, the AdamW update in
  place);
* prefill: ``transformer.prefill(..., max_seq_len=S, param_shardings=...)``;
* decode: ``transformer.decode`` at position S − 1 over a full cache
  (``max_seq_len`` S).

The step is the one the port executes on W ranks, at one rank's shapes:
its shards of the parameters and of the optimizer state
(``distributed.fsdp`` over the batch axes: each layer gathered where it
runs, each sharded gradient reduce-scattered in the backward;
``distributed.tp`` over ``"model"``), its rows of the batch (B/Dp over the
Dp batch ranks where ``input_shardings`` splits it; the whole batch on
every rank where Dp does not divide it: ``per_rank_batch``,
``batch_split``) and, on the model axis, its part of the sequence between
layers and its ``Sc/M`` cache slots. On the meta device a collective makes
the tensor a native one would (the whole leaf, the shard) and moves
nothing; the gloo emulation's ``[W, ...]`` buffers are not traced. At W = 1
the step is the unsharded one.

What a record holds (the reference's keys where their meaning holds):

* ``flops``: the trace's ops counted by ``torch.utils.flop_counter``'s
  formulas, the table ``FlopCounterMode`` counts with (one dispatch mode
  keeps every tally of the trace; the tests and ``chip_smoke.py`` hold the
  count equal to ``FlopCounterMode``'s over the same step run for real). An
  eager trace counts every layer, so no depth probe is needed (``--probe``
  still fits ``cost(L) = a + b·L`` and must agree).
* ``bytes_accessed``: over every aten op that is not a view, the bytes of
  its tensor inputs and outputs: the unfused upper bound (the report's
  "memory s (ub)").
* ``collectives``: counted from the layout by the rule below, in operand
  bytes as the reference's ``parse_collective_bytes`` counts them, in the
  shape of ``roofline.analysis.collective_bytes()``; the trace counts the
  collectives the step issues and raises where they differ from the rule.
  The rule over the Dp batch ranks (Dp = 1 has none): every
  batch-sharded parameter leaf is all-gathered in the dtype it is used in (``cfg.dtype`` where the
  model casts at use; the embedding as stored, its rows cast after the
  lookup) once per forward pass over it, so ``grad_accum`` times a train
  step, its operand the rank's shard (over both axes); a leaf of the stacked
  layers is gathered again in the backward under ``cfg.remat`` (the embedding, the
  head and the hybrid's shared block are gathered outside the
  checkpoints, once a pass). But where a pass looks up n < V token ids a
  rank, the embedding (V rows, sharded on its columns) moves those rows
  instead of itself: the pass all-gathers the rank's n ids (8 bytes each)
  and all-to-alls its n rows (n × D in the table's dtype), and a train
  step's backward all-to-alls their f32 gradients. In a train step every
  other gathered leaf's f32 gradient is
  reduce-scattered once per micro-batch, its operand the leaf whole over
  the batch axes; the batch-replicated leaves' f32 gradients and the loss
  are averaged in one all-reduce a step, and the squared gradient norm
  summed in another (4 bytes). A stacked leaf is one call a layer.
  The rule over the M model ranks (M = 1 has none; :func:`_model_axis`),
  with n the tokens of the rank's rows in a pass (whole sequence), the
  residual split on the sequence where M divides S > 1: the embedding's
  rows added over the ranks (a reduce-scatter of n × D in the table's
  dtype where the sequence splits, else an all-reduce; none where M does
  not divide the padded vocabulary, which stays whole); in each layer
  the sequence gathered before attention, the MLP, a Mamba layer and a
  cross layer (n/M × D), the f32 row-parallel partials reduce-scattered
  after them (n × D × 4; all-reduced where the sequence is whole),
  ``wk``/``wv`` gathered where GQA is expanded, a prefill's K/V gathered
  over the heads where it is not; where M does not divide a block's heads
  (or ``d_ff``) the block runs whole: each of its weights stored split is
  gathered whole (in the dtype it is used in) and no partials are added; a
  Mamba layer gathers ``in_proj`` where it is stored split, all-reduces
  its gated norm's f32 sums of squares (n × 4) and reduce-scatters
  ``out_proj``'s partials where its heads split, else gathers
  ``out_proj``; the hybrid gathers ``shared_in`` once a pass; a vlm
  cross layer gathers its image K/V weights where GQA is expanded and a
  prefill gathers its image K/V over the heads where it is not; the MoE's
  island (``ep``: two all-to-alls of the [E, C, D] buffers; ``ep_split``:
  those and three of the weights; ``tp``: the sequence gathered and an
  all-reduce of the f32 [E, C, D] partials; the shared experts as the
  MLP); the head's sequence gather (train) or the last position's
  all-reduce (prefill); the loss's row max and (sum-exp, label logit)
  all-reduces where the vocabulary splits. Decode gathers q (and K/V where GQA is not expanded) over
  the heads, the partial softmaxes of the ranks' slots where M divides
  the cache's slots (none over a whole cache), and all-reduces the
  ``wo``/``w2``/``out_proj`` partials and the gated norm's sums. A train
  step's backward issues each collective's adjoint (an all-gather's
  reduce-scatter, a reduce-scatter's all-gather, an all-reduce and an
  all-to-all again, the operand in the gradient's dtype), remat issues a
  layer's forward collectives again but the row-parallel sum that ends a
  decoder layer, a Mamba layer or the shared block
  (``torch.utils.checkpoint`` stops its recompute at the last tensor the
  backward saved; a cross layer's gates save both its sums), and the step
  ends with the model-replicated leaves' f32 gradients and the loss added
  over the ranks in one all-reduce and the squared norm in another.
* ``memory``, per rank:

  - ``argument_bytes``: the rank's shards of the parameters, the optimizer
    state (train) and the inputs (the cache, for decode);
  - ``output_bytes``: the step's outputs: the logits and cache it makes,
    and for train the parameters and state it updates in place;
  - ``alias_bytes``: what train donates, its parameters and state (the
    port's step updates them in place);
  - ``temp_bytes``: the live-bytes peak of the trace (a dispatch mode adds
    each storage an op creates and takes it off when the storage is freed),
    less the outputs the step made: the gathered layers and the gradients
    as the FSDP step holds them (a sharded leaf's gradient whole only
    until its reduce-scatter), without the gloo emulation's buffers;
  - ``peak_bytes_est``: the reference's formula, argument + output + temp
    − alias.

* ``trace_s``: the trace's seconds (it takes the place of ``compile_s``).

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--probe]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --jobs 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cell qwen3-4b:train_4k --cell zamba2-1.2b:long_500k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape decode_32k \\
      --set n_layers=2

Each cell writes ``$REPRO_RESULTS/<mesh>/<arch>__<shape>.json`` (default
``results/dryrun``). Nothing runs on a device: the whole grid runs on the
host's CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback
import weakref
from math import prod
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.distributed import fsdp, tp
from repro_torch.distributed import params as param_rules
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import (
    make_data_mesh,
    make_production_mesh,
    production_mesh_name,
    production_shape,
    production_world,
)
from repro_torch.models import cache as cache_mod
from repro_torch.models import mamba2, moe, transformer
from repro_torch.roofline import analysis
from repro_torch.train import optimizer
from repro_torch.train import train_step as ts

__all__ = ["cell_step", "fake_group", "fake_mesh", "main", "run_cell", "trace_cell"]

RESULTS = pathlib.Path(os.environ.get("REPRO_RESULTS", "results/dryrun"))

#: the collective kinds of a record, as ``analysis.collective_bytes`` names them
_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of ``world`` ranks, this process rank 0, on
    ``torch.distributed``'s ``fake`` backend (no device, no communication);
    destroyed on exit, also when the block raises. Raises if this process
    has a process group already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; the dry run starts its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(world: int, shape: tuple[int, ...] | None = None):
    """:func:`fake_group` of ``world`` ranks and a mesh over it, made the
    current mesh inside the block: one ``"data"`` dimension without
    ``shape`` (``make_data_mesh`` at 256 and 512 ranks), else ``shape``
    over ``("data", "model")`` or ``("pod", "data", "model")``
    (``make_production_mesh`` at its shapes)."""
    from torch.distributed.device_mesh import init_device_mesh

    with fake_group(world):
        multi = {production_world(False): False, production_world(True): True}.get(world)
        if shape is None and multi is not None:
            mesh = make_data_mesh(multi_pod=multi, device="cpu")
        elif shape is None:
            mesh = init_device_mesh("cpu", (world,), mesh_dim_names=(sh.DATA,))
        elif multi is not None and tuple(shape) == production_shape(multi):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
        else:
            names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
            mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)
        with sh.use_mesh(mesh):
            yield mesh


# ------------------------------------------------------------- the tally
def _tensors(tree, out: list) -> list:
    """The tensors of an op's arguments or results, appended to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Tally(TorchDispatchMode):
    """One pass over every aten op of a step: its FLOPs by
    ``torch.utils.flop_counter``'s formulas (the table ``FlopCounterMode``
    counts with), the bytes of the tensor inputs and outputs of every op
    that is not a view, and the live bytes of the storages the ops create:
    each is added when an op outputs it first and taken off when the
    storage is freed. Storages in ``held`` (the step's arguments) are not
    counted."""

    def __init__(self, held: set[int]):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.formulas = flop_registry
        self.held = held
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.owned: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self.owned.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out, [])
        if not func.is_view:
            self.bytes_accessed += _nbytes(_tensors((args, kwargs), list(outs)))
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in self.held or key in self.owned:
                continue
            self.owned[key] = s.nbytes()
            self.live += self.owned[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key)
        return out


def _storage_keys(tree) -> dict[int, int]:
    """``{storage id: bytes}`` of a tree's tensors."""
    out = {}
    for t in _tensors(tree, []):
        s = t.untyped_storage()
        out[s._cdata] = s.nbytes()
    return out


# ------------------------------------------------------------- the step
def _local_shape(shape, placement, axes: tuple[str, ...] | None = None) -> tuple[int, ...]:
    """A leaf's per-rank shape under its placement tuple on the current
    mesh, split over the mesh dimensions ``axes`` only (default: all)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for name, p in zip(fsdp._axes_of(placement), placement):
        if isinstance(p, Shard) and (axes is None or name in axes):
            out[p.dim] //= sh.axis_size(name)
    return tuple(out)


def _is_sharded(placement) -> bool:
    """Whether a placement splits its leaf over the batch axes."""
    return fsdp.batch_dim(placement) is not None


def _walk(tree, places, names=()):
    """``(names, leaf, placement)`` over a tree and its placement tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, places[k], (*names, k))
        else:
            yield (*names, k), v, places[k]


#: leading stacked axes of the parameter leaves under each top-level key
_STACKED = {"layers": 1, "mamba_tail": 1, "cross_layers": 1, "self_layers": 2,
            "mamba_groups": 2}


def _layers_of(names, t) -> int:
    """The layers a parameter leaf stacks (one collective call each)."""
    return prod(t.shape[: _STACKED.get(names[0], 0)])


def _local_inputs(specs: dict, places: dict) -> dict:
    """``specs``' leaves as meta tensors at their per-rank shapes."""

    def local(v, p):
        if isinstance(v, dict):
            return {k: local(x, p[k]) for k, x in v.items()}
        return torch.empty(_local_shape(v.shape, p), dtype=v.dtype, device="meta")

    return {k: local(v, places[k]) for k, v in specs.items()}


def _realize(name: str, v, device, gen: torch.Generator):
    """A meta input as a tensor on ``device``: token ids drawn from
    ``gen`` below 256, image embeddings N(0, 1), a zero cache with its slot
    positions at −1."""
    if isinstance(v, dict):
        return {k: _realize(k, x, device, gen) for k, x in v.items()}
    if name == "slot_pos":
        return torch.full(v.shape, -1, dtype=v.dtype, device=device)
    if name in ("tokens", "labels", "token"):
        return torch.randint(0, 256, v.shape, generator=gen).to(v.dtype).to(device)
    if name == "image_embeds":
        return torch.randn(v.shape, generator=gen).to(v.dtype).to(device)
    return torch.zeros(v.shape, dtype=v.dtype, device=device)


def cell_step(cfg: configs.ArchConfig, shape: configs.Shape, *,
              device="meta") -> tuple[Callable, tuple, dict]:
    """``(step, args, info)`` of the cell on the current mesh:
    ``step(*args)`` runs the cell's step once at the per-rank shapes, its
    parameters and inputs drawn from seed 0 on ``device`` (on the meta
    device nothing is allocated); with W > 1 the step takes the rank's
    shards (``fsdp.shard_tree``). ``info`` holds the config the step runs
    (``grad_accum`` 1 where the rank's rows do not split into
    ``cfg.grad_accum`` micro-batches), the ``whole`` parameter tree and
    its ``param_shardings``, the per-rank ``inputs``, their
    ``input_shardings``, ``per_rank_batch`` and ``batch_split``."""
    specs = configs.input_specs(cfg, shape)
    in_sh = param_rules.input_shardings(cfg, specs)
    inputs = _local_inputs(specs, in_sh)
    if torch.device(device).type != "meta":
        gen = torch.Generator().manual_seed(0)
        inputs = {k: _realize(k, v, device, gen) for k, v in inputs.items()}
    lead = "token" if shape.kind == "decode" else "tokens"
    per_rank = int(inputs[lead].shape[0])
    if shape.kind == "train" and per_rank % max(1, cfg.grad_accum):
        cfg = cfg.replace(grad_accum=1)  # the rank's rows do not split: one micro-batch
    img = (inputs["image_embeds"],) if cfg.family == "vlm" and shape.kind != "decode" else ()
    whole = transformer.init_params(cfg, rnd.key(0), device=device)
    psh = param_rules.param_shardings(cfg, whole)
    ps = psh if fsdp.active() else None
    params = fsdp.shard_tree(whole, psh) if fsdp.active() else whole
    if shape.kind == "train":
        step = ts.make_train_step(cfg, param_shardings=ps)
        args = (params, optimizer.adamw_init(params), inputs["tokens"], inputs["labels"], *img)
    elif shape.kind == "prefill":

        def step(params, tokens, image_embeds=None):
            with torch.no_grad():
                return transformer.prefill(cfg, params, tokens, image_embeds,
                                           max_seq_len=shape.seq_len, param_shardings=ps)

        args = (params, inputs["tokens"], *img)
    else:

        def step(params, cache, token):
            with torch.no_grad():
                return transformer.decode(cfg, params, cache, token, shape.seq_len - 1,
                                          param_shardings=ps, max_seq_len=shape.seq_len)

        args = (params, inputs["cache"], inputs["token"])
    info = {"cfg": cfg, "whole": whole, "param_shardings": psh, "inputs": inputs,
            "input_shardings": in_sh, "per_rank_batch": per_rank,
            "batch_split": _is_sharded(in_sh[lead])}
    return step, args, info


def _collectives(cfg, shape, params, places, world: int | None = None) -> dict[str, Any]:
    """A step's collective operand bytes by the rule of the module
    docstring (``cfg`` the config the step runs: ``cell_step``'s) on the
    current mesh (``world``, where given, its batch ranks)."""
    out: dict[str, Any] = {k: {"bytes": 0, "count": 0} for k in _KINDS}

    def add(kind, nbytes, calls=1):
        out[kind]["bytes"] += nbytes
        out[kind]["count"] += calls

    batch = fsdp.world()
    if world is not None and world != batch:
        raise ValueError(f"the rule at {world} batch ranks on a mesh of {batch}")
    train = shape.kind == "train"
    accum = max(1, cfg.grad_accum) if train else 1
    rows = shape.global_batch // batch if shape.global_batch % batch == 0 else shape.global_batch
    tokens = rows * (1 if shape.kind == "decode" else shape.seq_len) // accum  # a pass
    model = sh.axis_size(sh.MODEL) > 1
    if batch > 1:
        replicated = 0
        for names, t, p in _walk(params, places):
            calls = _layers_of(names, t)
            gathered = prod(_local_shape(t.shape, p, (sh.MODEL,)))  # whole over the batch
            if not _is_sharded(p):
                replicated += gathered
                continue
            embed = names == ("embed",)
            rows_held = _local_shape(t.shape, p, (sh.MODEL,))[0]
            if embed and tokens < rows_held:  # the rows the ranks look up move, not the table
                for _ in range(accum):
                    add("all-gather", tokens * 8)
                    add("all-to-all", tokens * t.shape[1] * t.element_size())
                    if train:
                        add("all-to-all", tokens * t.shape[1] * 4)
                continue
            use = t.element_size() if embed else torch.empty(
                (), dtype=fsdp.use_dtype(cfg, t)).element_size()
            remat = 2 if train and cfg.remat and names[0] in _STACKED else 1
            add("all-gather", accum * remat * use * prod(_local_shape(t.shape, p)),
                accum * remat * calls)
            if train:
                add("reduce-scatter", accum * gathered * 4, accum * calls)
        if train:  # the replicated gradients with the loss, then the squared norm
            add("all-reduce", (replicated + 1) * 4, 1)
            add("all-reduce", 4, 1)
    if model:
        _model_axis(cfg, shape, params, places, rows, accum, add)
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def _model_axis(cfg, shape, params, places, rows: int, accum: int, add) -> None:
    """The collectives over ``"model"`` of a step (the module docstring's
    rule), added with ``add(kind, bytes)``."""
    m = sh.axis_size(sh.MODEL)
    train, decode = shape.kind == "train", shape.kind == "decode"
    s = 1 if decode else shape.seq_len
    seq = s > 1 and tp.divides(s)
    rows = rows // accum  # a micro-batch
    n = rows * s  # the tokens of the rank's rows in a pass
    d, hd, kv, h = cfg.d_model, cfg.hd, cfg.n_kv_heads, cfg.n_heads
    act = torch.empty((), dtype=cfg.dtype).element_size()
    flat = {names: (t, p) for names, t, p in _walk(params, places)}
    table = flat[("embed",)][0].element_size()
    split = tp.splits(cfg)  # the widths that split; the others run whole
    vocab = tp.divides(cfg.vocab_padded)  # else the embedding and head run whole
    heads = split.heads
    kv_whole = heads and not split.kv

    # an entry: (kind, bytes, the backward's kind, its bytes)
    def gather(nbytes):
        """An all-gather; its adjoint the reduce-scatter of the whole."""
        return ("all-gather", nbytes, "reduce-scatter", nbytes * m)

    def to_residual():
        """Row-parallel f32 partials of n × D added into the residual stream
        (the gradient in the activations' dtype)."""
        if seq:
            return ("reduce-scatter", n * d * 4, "all-gather", n // m * d * act)
        return ("all-reduce", n * d * 4, "all-reduce", n * d * act)

    def seq_gather():
        return [gather(n // m * d * act)] if seq else []

    def weight(*names, size):
        """A weight of ``size`` elements gathered whole where it is stored
        split over the model ranks, in the dtype it is used in."""
        t, p = flat[names]
        if fsdp.model_dim(p) is None:
            return []
        return [gather(size // m * torch.empty((), dtype=fsdp.use_dtype(cfg, t)).element_size())]

    def attn_weights(*at, keys=("wq", "wk", "wv", "wo")):
        """An attention block's weights ``keys`` gathered whole where they
        are stored split (its heads do not split, or ``wk``/``wv`` where
        GQA is expanded)."""
        sizes = {"wq": d * h * hd, "wk": d * kv * hd, "wv": d * kv * hd, "wo": h * hd * d}
        return [w for k in keys for w in weight(*at, k, size=sizes[k])]

    decode_sum = ("all-reduce", rows * d * 4, None, 0)  # a decode step's f32 partials

    def attn(*at):
        """A self-attention block, its weights under ``at``."""
        if not heads:
            return seq_gather() + attn_weights(*at)
        out = seq_gather()
        if kv_whole:
            out += attn_weights(*at, keys=("wk", "wv"))
        elif shape.kind == "prefill":  # the cache's K/V, every KV head
            out += [gather(n * (kv // m) * hd * act)] * 2
        return out + [to_residual()]

    def attn_decode(*at, whole_cache):
        if heads:
            out = [gather(rows * (h // m) * hd * act)]  # q's heads
            if kv_whole:
                out += attn_weights(*at, keys=("wk", "wv"))
            else:
                out += [gather(rows * (kv // m) * hd * act)] * 2
        else:
            out = attn_weights(*at)
        if not whole_cache:
            out.append(gather(rows * h * (hd + 2) * 4))  # the partial softmaxes
        return out + ([decode_sum] if heads else [])

    def mlp():
        """``(entries, tail)``: the MLP; ``tail`` the trailing entries remat
        does not run again (``torch.utils.checkpoint`` stops its recompute
        at the last tensor the backward saved: a row-parallel sum added to
        the residual stream is not one)."""
        if decode:
            return ([decode_sum] if split.ff else []), 0
        if split.ff:
            return seq_gather() + [to_residual()], 1
        return seq_gather(), 0

    def moe_ffn():
        e, f = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        mode = moe.moe_mode(e, m)
        out = seq_gather() if mode == "tp" or cfg.n_shared_experts else []
        t = n // m if seq and mode != "tp" else n
        cap = moe._capacity(cfg, t, e)
        if mode == "ep":
            out += [("all-to-all", e * cap * d * act, "all-to-all", e * cap * d * act)] * 2
        elif mode == "ep_split":
            use_w = torch.empty((), dtype=fsdp.use_dtype(
                cfg, flat[("layers", "moe", "w1")][0])).element_size()
            r = m // e
            cap = -(-cap // r) * r
            out += [("all-to-all", e * cap * d * act, "all-to-all", e * cap * d * act)] * 2
            out += [("all-to-all", d * f * use_w, "all-to-all", d * f * use_w)] * 3
        else:
            out.append(("all-reduce", e * cap * d * 4, "all-reduce", e * cap * d * act))
        if split.shared_ff:
            return out + [to_residual()], 1
        return out, 0

    def mamba(*at):
        dims = mamba2.mamba_dims(cfg)
        out = seq_gather() + weight(*at, "in_proj", size=d * dims["in_dim"])
        if not split.ssm:
            return out + weight(*at, "out_proj", size=dims["d_inner"] * d), 0
        # the gated norm's f32 sums of squares, then out_proj's partials
        norm = ("all-reduce", n * 4, "all-reduce", n * 4)
        if decode:
            return out + [norm, decode_sum], 0
        return out + [norm, to_residual()], 1

    def cross(*at):
        if decode:  # over the cached image K/V
            out = [decode_sum] if heads else attn_weights(*at, keys=("wq", "wo"))
            return out + mlp()[0], 0
        out = attn_weights(*at, keys=("wk", "wv")) if not heads or kv_whole else []
        out += seq_gather()
        out += [to_residual()] if heads else attn_weights(*at, keys=("wq", "wo"))
        return out + mlp()[0], 0  # the gates save both sums: remat runs all again

    sc = cache_mod.cache_seq_len(cfg, shape.seq_len)
    whole_cache = not tp.divides(sc)

    def dense_layer(*at):
        """A decoder layer's ``(entries, tail)``: attention and the MLP."""
        if decode:
            return attn_decode(*at, "attn", whole_cache=whole_cache) + mlp()[0], 0
        f, tail = mlp()
        return attn(*at, "attn") + f, tail

    once: list = []  # a pass's entries outside the layers
    if cfg.family in ("dense", "audio", "moe"):
        if cfg.family == "moe":
            f, tail = moe_ffn()
            a = (attn_decode("layers", "attn", whole_cache=whole_cache) if decode
                 else attn("layers", "attn"))
            units = [(a + f, tail)] * cfg.n_layers
        else:
            units = [dense_layer("layers")] * cfg.n_layers
    elif cfg.family == "ssm":
        units = [mamba("layers", "mamba")] * cfg.n_layers
    elif cfg.family == "hybrid":
        g, per = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
        once = weight("shared_in", size=2 * d * d)
        units = [dense_layer("shared_block")] * g + [mamba("mamba_groups", "mamba")] * (g * per)
        if cfg.n_layers > g * per:
            units += [mamba("mamba_tail", "mamba")] * (cfg.n_layers - g * per)
    else:  # vlm
        g, per = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
        units = [dense_layer("self_layers")] * (g * per) + [cross("cross_layers", "attn")] * g
        if shape.kind == "prefill" and heads and not kv_whole:  # the cache's image K/V
            t_img = cfg.n_image_tokens
            once = [gather(rows * t_img * (kv // m) * hd * act)] * (2 * g)

    for _ in range(accum):
        if vocab:
            add("reduce-scatter" if seq else "all-reduce", n * d * table)  # the embedding's rows
        for kind, nbytes, *_ in once:
            add(kind, nbytes)
        for entries, tail in units:
            again = entries[:len(entries) - tail] if train and cfg.remat else []
            for kind, nbytes, *_ in entries + again:
                add(kind, nbytes)
        if train:
            if seq:
                add("all-gather", n // m * d * act)  # the head's sequence
            if vocab:
                add("all-reduce", rows * (s - 1) * 4)  # the row max
                add("all-reduce", 2 * rows * (s - 1) * 4)  # sum-exp and the label logit
                add("all-reduce", 2 * rows * (s - 1) * 4)  # ... in the backward
            if seq:
                add("reduce-scatter", n * d * act)
            for entries, _ in units:
                for _, _, kind, nbytes in entries:
                    add(kind, nbytes)
            for _, _, kind, nbytes in once:
                add(kind, nbytes)
            if vocab and seq:
                add("all-gather", n // m * d * table)  # the embedding rows' gradient
            elif vocab:
                add("all-reduce", n * d * table)
        elif shape.kind == "prefill" and seq:
            add("all-reduce", rows * d * act)  # the last position
    if train:
        rep = sum(prod(t.shape) // _shard_parts(p) for t, p in flat.values()
                  if fsdp.model_dim(p) is None)
        add("all-reduce", (rep + 1) * 4)
        add("all-reduce", 4)


def _shard_parts(placement) -> int:
    """The ranks a placement splits its leaf over."""
    return prod(sh.axis_size(n) for n in fsdp._shard_dims(placement))


def trace_cell(cfg: configs.ArchConfig, shape: configs.Shape) -> dict[str, Any]:
    """Trace the cell's step once on the meta device on the current mesh
    and return the record's cost fields (the module docstring)."""
    t0 = time.perf_counter()
    step, args, info = cell_step(cfg, shape, device="meta")
    whole, psh = info["whole"], info["param_shardings"]
    held = _storage_keys(args)
    analysis.collective_bytes(reset=True)
    with _Tally(set(held)) as tally:
        result = step(*args)
    trace_s = time.perf_counter() - t0
    collectives = _collectives(info["cfg"], shape, whole, psh)
    traced = analysis.collective_bytes(reset=True)
    if traced != collectives:
        raise RuntimeError(f"{cfg.name} × {shape.name}: the traced step's collectives {traced} "
                           f"are not the rule's {collectives}")
    made = sum(n for k, n in _storage_keys(result).items() if k not in held)
    param_bytes = _nbytes(_tensors(args[0], []))
    arg_bytes = param_bytes + _nbytes(_tensors(info["inputs"], []))
    alias = 0
    if shape.kind == "train":  # the optimizer state is an argument too; both are donated
        state_bytes = _nbytes(_tensors(args[1], []))
        arg_bytes += state_bytes
        alias = param_bytes + state_bytes
    memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": alias + made,
        "temp_bytes": tally.peak - made,
        "alias_bytes": alias,
    }
    memory["peak_bytes_est"] = (memory["argument_bytes"] + memory["output_bytes"]
                                + memory["temp_bytes"] - memory["alias_bytes"])
    return {
        "trace_s": round(trace_s, 3),
        "flops": float(tally.flops),
        "bytes_accessed": float(tally.bytes_accessed),
        "collectives": collectives,
        "grad_accum": info["cfg"].grad_accum,
        "memory": memory,
        "per_rank_batch": info["per_rank_batch"],
        "batch_split": info["batch_split"],
    }


def _probe_depth(cfg) -> int:
    """The smallest homogeneous unit of layers (a group for vlm/hybrid)."""
    if cfg.family == "vlm":
        return cfg.cross_attn_every
    if cfg.family == "hybrid":
        return cfg.shared_attn_every
    return 1


def _probe_costs(cfg, shape) -> dict:
    """Traces at depths p and 2p and ``analysis.extrapolate_linear`` to the
    config's depth: ``cost(L) = a + b·L``. The reference needs them because
    XLA counts a scan body once; an eager trace counts every layer, so the
    extrapolation equals the full trace (a check of the trace's linearity)."""
    unit = _probe_depth(cfg)
    probes = {}
    for mult in (1, 2):
        cost = trace_cell(cfg.replace(n_layers=unit * mult), shape)
        probes[mult] = {
            "flops": cost["flops"],
            "bytes_accessed": cost["bytes_accessed"],
            "collective_bytes": cost["collectives"]["total_bytes"],
        }
    total_units = cfg.n_layers // unit
    return {
        "unit_layers": unit,
        "probe_1": probes[1],
        "probe_2": probes[2],
        "extrapolated": analysis.extrapolate_linear(probes[1], probes[2], 1, total_units),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, probe: bool = False,
             overrides: dict | None = None, tag: str = "") -> dict:
    """The record of one cell on its production mesh (``16x16`` or ``2x16x16``),
    traced inside a fake process group of its ranks, which is gone when
    this returns or raises."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = configs.SHAPES[shape_name]
    world = production_world(multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": production_mesh_name(multi_pod),
                 "chips": world, "tag": tag}
    with fake_mesh(world, production_shape(multi_pod)):
        rec.update(trace_cell(cfg, shape))
        if probe:
            rec["probe"] = _probe_costs(cfg, shape)
    print(f"[dryrun] {arch} × {shape_name} on {rec['mesh']}: trace {rec['trace_s']}s, "
          f"peak/device {rec['memory']['peak_bytes_est'] / 2**30:.2f} GiB, "
          f"flops/device {rec['flops']:.3e}, "
          f"coll {rec['collectives']['total_bytes'] / 2**20:.1f} MiB, "
          f"batch/rank {rec['per_rank_batch']}"
          + ("" if rec["batch_split"] else " (whole on every rank)"), flush=True)
    return rec


def _overrides(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def _cell_cost(cell) -> tuple:
    """A cell's place in the queue of ``--jobs``: prefill first (its flash
    tiles grow with S²), then train, then decode, deeper configs first."""
    arch, shape, _ = cell
    kind = configs.SHAPES[shape].kind
    return ({"prefill": 0, "train": 1, "decode": 2}[kind], -configs.get_config(arch).n_layers)


def _warm() -> None:
    """Trace a reduced cell once in this process: the modules a trace
    imports lazily (checkpointing, the device mesh, the fake backend) are
    then loaded."""
    cfg = configs.reduced_config(configs.get_config("qwen3-4b")).replace(remat=True)
    with fake_mesh(1):
        trace_cell(cfg, configs.Shape("warm", 64, 1, "train"))


def _pool_cell(task) -> tuple:
    """One cell in a ``--jobs`` worker: ``(arch, shape, multi, error or
    None)``, the record written to ``out``."""
    arch, shape, multi, probe, overrides, tag, out = task
    try:
        rec = run_cell(arch, shape, multi_pod=multi, probe=probe, overrides=overrides, tag=tag)
        pathlib.Path(out).write_text(json.dumps(rec, indent=1))
        return arch, shape, multi, None
    except Exception:
        return arch, shape, multi, traceback.format_exc()[-2000:]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=configs.ARCHS)
    ap.add_argument("--shape", choices=list(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", action="append", default=[], metavar="ARCH:SHAPE",
                    help="a cell to trace (repeatable), in place of --arch/--shape or --all")
    ap.add_argument("--probe", action="store_true",
                    help="also trace depths p and 2p and extrapolate (must equal the full trace)")
    ap.add_argument("--subprocess-per-cell", action="store_true",
                    help="isolate each cell in a fresh process")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes tracing cells at once, the costliest first (the "
                         "whole grid takes minutes of one core; the traces use no device)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf experiments)")
    ap.add_argument("--tag", default="", help="experiment tag for the record")
    args = ap.parse_args(argv)
    cells = [tuple(c.split(":", 1)) for c in args.cell]
    if args.all:
        cells = configs.runnable_cells()
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    if not cells or any(c not in configs.runnable_cells() for c in cells):
        ap.error(f"give --arch and --shape, --cell ARCH:SHAPE or --all; runnable cells: "
                 f"{configs.runnable_cells()}")
    overrides = _overrides(args.set)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    suffix = f"__{args.tag}" if args.tag else ""

    def out_path(arch, shape, multi):
        outdir = RESULTS / production_mesh_name(multi)
        outdir.mkdir(parents=True, exist_ok=True)
        return outdir / f"{arch.replace('.', '_')}__{shape}{suffix}.json"

    todo = [(a, s, m) for m in meshes for a, s in cells]
    failures = []
    if args.jobs > 1:
        import multiprocessing

        from repro_torch.launch import dryrun as this  # pickled by its module name

        tasks = [(a, s, m, args.probe, overrides, args.tag, str(out_path(a, s, m)))
                 for a, s, m in sorted(todo, key=_cell_cost)]
        # the workers fork from this process once it has traced a small cell,
        # so none of them imports torch or warms its lazy modules again
        _warm()
        with multiprocessing.get_context("fork").Pool(args.jobs) as pool:
            for arch, shape, multi, err in pool.imap_unordered(this._pool_cell, tasks):
                if err is not None:
                    failures.append((arch, shape, multi, err))
                    print(f"[dryrun] FAIL {arch} × {shape} multi={multi}\n{err}", flush=True)
    for arch, shape, multi in todo if args.jobs <= 1 else ():
        out = out_path(arch, shape, multi)
        if args.subprocess_per_cell:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape]
            if multi:
                cmd.append("--multi-pod")
            if args.probe:
                cmd.append("--probe")
            if args.tag:
                cmd += ["--tag", args.tag]
            for kv in args.set:
                cmd += ["--set", kv]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                failures.append((arch, shape, multi, r.stderr[-2000:]))
                print(f"[dryrun] FAIL {arch} × {shape} multi={multi}\n{r.stderr[-2000:]}")
            else:
                print(r.stdout.strip().splitlines()[0] if r.stdout else "")
            continue
        try:
            rec = run_cell(arch, shape, multi_pod=multi, probe=args.probe,
                           overrides=overrides, tag=args.tag)
            out.write_text(json.dumps(rec, indent=1))
        except Exception:
            failures.append((arch, shape, multi, traceback.format_exc()[-2000:]))
            print(f"[dryrun] FAIL {arch} × {shape} multi={multi}")
            traceback.print_exc()

    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for a, s, m, _ in failures:
            print(f"  {a} × {s} (multi={m})")
        sys.exit(1)
    print("\n[dryrun] all cells traced OK")


if __name__ == "__main__":
    main()
