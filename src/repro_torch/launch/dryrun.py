"""The dry run: trace every (architecture × input shape) cell's step on the
meta device against the production mesh, and record per-device FLOPs,
bytes, collective bytes and a peak-memory estimate for the report
(``repro_torch.roofline.report``).

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
with XLA against 256 or 512 forced host devices. The port compiles nothing:
it starts a fake process group of W ranks (``torch.distributed``'s ``fake``
backend, no device and no communication), builds
``launch.mesh.make_production_mesh`` over it (W = 256, ``data256``; 512,
``data512``, with ``--multi-pod``), lays parameters, optimizer state and
inputs out with ``distributed.params``, and runs the cell's step once on
meta tensors, which carry shapes and dtypes and no storage:

* train: ``train_step.make_train_step(cfg)``'s step (loss, gradients with
  ``cfg.remat``'s checkpoints, the AdamW update in place);
* prefill: ``transformer.prefill(..., max_seq_len=S)``;
* decode: ``transformer.decode`` at position S − 1 over a full cache.

The step runs at the per-rank shapes: the batch is divided by W where
``input_shardings`` splits it, and stays whole on every rank where W does
not divide it (``per_rank_batch``, ``batch_split``). It runs on the whole
parameters, as the port's step does.

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
* ``collectives``: counted from the layout, not parsed from a program, in
  operand bytes as the reference's ``parse_collective_bytes`` counts them,
  in the shape of ``roofline.analysis.collective_bytes()``. The rule, with
  W > 1 (one rank has none): every data-sharded parameter leaf is
  all-gathered in ``cfg.dtype`` (the dtype it is used in) once per forward
  pass over it, so ``grad_accum`` times a train step and twice that with
  remat, its operand the rank's shard; every gradient leaf is reduced once
  in f32, reduce-scatter where the leaf is sharded and all-reduce where it
  is replicated, its operand the whole leaf. A stacked leaf is one call a
  layer.
* ``memory``, per rank:

  - ``argument_bytes``: the rank's shards of the parameters, the optimizer
    state (train) and the inputs (the cache, for decode);
  - ``output_bytes``: the step's outputs: the logits and cache it makes,
    and for train the parameters and state it updates in place;
  - ``alias_bytes``: what train donates, its parameters and state (the
    port's step updates them in place);
  - ``temp_bytes``: the live-bytes peak of the trace (a dispatch mode adds
    each storage an op creates and takes it off when the storage is freed),
    less the outputs the step made, plus the largest gathered layer: with
    W > 1, over the stacked layers (and the embedding and head apart), the
    most bytes of data-sharded leaves that the step reads in their stored
    dtype, whole (a leaf cast to ``cfg.dtype`` at use is held whole by the
    trace's cast already). The trace holds every gradient whole until the
    update, as the port's step does; an FSDP step that reduce-scatters a
    layer's gradient in the backward would hold 1/W of it, so with W > 1
    this is an upper bound;
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
from repro_torch.distributed import params as param_rules
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_production_mesh, production_mesh_name, production_world
from repro_torch.models import transformer
from repro_torch.roofline import analysis
from repro_torch.train import train_step as ts

__all__ = ["cell_step", "fake_group", "fake_mesh", "main", "run_cell", "trace_cell"]

RESULTS = pathlib.Path(os.environ.get("REPRO_RESULTS", "results/dryrun"))

#: the collective kinds of a record, as ``analysis.collective_bytes`` names them
_KINDS = ("all-gather", "reduce-scatter", "all-reduce")


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
def fake_mesh(world: int):
    """:func:`fake_group` of ``world`` ranks and its ``"data"`` mesh, made
    the current mesh inside the block: ``make_production_mesh`` at 256 and
    512 ranks, any other size directly."""
    from torch.distributed.device_mesh import init_device_mesh

    with fake_group(world):
        multi = {production_world(False): False, production_world(True): True}.get(world)
        if multi is None:
            mesh = init_device_mesh("cpu", (world,), mesh_dim_names=(sh.DATA,))
        else:
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
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
def _local_shape(shape, placement, world: int) -> tuple[int, ...]:
    """A leaf's per-rank shape under its placement tuple."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for p in placement:
        if isinstance(p, Shard):
            out[p.dim] //= world
    return tuple(out)


def _is_sharded(placement) -> bool:
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) for p in placement)


def _walk(tree, places, names=()):
    """``(names, leaf, placement)`` over a tree and its placement tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, places[k], (*names, k))
        else:
            yield (*names, k), v, places[k]


def _local_bytes(tree, places, world: int) -> int:
    """The rank's bytes of a tree laid out by ``places``."""
    return sum(prod(_local_shape(t.shape, p, world)) * t.element_size()
               for _, t, p in _walk(tree, places))


#: leading stacked axes of the parameter leaves under each top-level key
_STACKED = {"layers": 1, "mamba_tail": 1, "cross_layers": 1, "self_layers": 2,
            "mamba_groups": 2}


def _layers_of(names, t) -> int:
    """The layers a parameter leaf stacks (one collective call each)."""
    return prod(t.shape[: _STACKED.get(names[0], 0)])


def _local_inputs(specs: dict, places: dict, world: int) -> dict:
    """``specs``' leaves as meta tensors at their per-rank shapes."""

    def local(v, p):
        if isinstance(v, dict):
            return {k: local(x, p[k]) for k, x in v.items()}
        return torch.empty(_local_shape(v.shape, p, world), dtype=v.dtype, device="meta")

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
    device nothing is allocated). ``info`` holds the config the step runs
    (``grad_accum`` 1 where the rank's rows do not split into
    ``cfg.grad_accum`` micro-batches), the per-rank ``inputs``, their
    ``input_shardings``, ``per_rank_batch`` and ``batch_split``."""
    world = sh.axis_size(sh.DATA)
    specs = configs.input_specs(cfg, shape)
    in_sh = param_rules.input_shardings(cfg, specs)
    inputs = _local_inputs(specs, in_sh, world)
    if torch.device(device).type != "meta":
        gen = torch.Generator().manual_seed(0)
        inputs = {k: _realize(k, v, device, gen) for k, v in inputs.items()}
    lead = "token" if shape.kind == "decode" else "tokens"
    per_rank = int(inputs[lead].shape[0])
    if shape.kind == "train" and per_rank % max(1, cfg.grad_accum):
        cfg = cfg.replace(grad_accum=1)  # the rank's rows do not split: one micro-batch
    key = rnd.key(0)
    img = (inputs["image_embeds"],) if cfg.family == "vlm" and shape.kind != "decode" else ()
    if shape.kind == "train":
        params, state = ts.init_train_state(cfg, key, device=device)
        step = ts.make_train_step(cfg)
        args = (params, state, inputs["tokens"], inputs["labels"], *img)
    elif shape.kind == "prefill":
        params = transformer.init_params(cfg, key, device=device)

        def step(params, tokens, image_embeds=None):
            with torch.no_grad():
                return transformer.prefill(cfg, params, tokens, image_embeds,
                                           max_seq_len=shape.seq_len)

        args = (params, inputs["tokens"], *img)
    else:
        params = transformer.init_params(cfg, key, device=device)

        def step(params, cache, token):
            with torch.no_grad():
                return transformer.decode(cfg, params, cache, token, shape.seq_len - 1)

        args = (params, inputs["cache"], inputs["token"])
    info = {"cfg": cfg, "inputs": inputs, "input_shardings": in_sh, "per_rank_batch": per_rank,
            "batch_split": _is_sharded(in_sh[lead])}
    return step, args, info


def _collectives(cfg, shape, params, places, world: int) -> dict[str, Any]:
    """A step's collective operand bytes by the rule of the module
    docstring."""
    out: dict[str, Any] = {k: {"bytes": 0, "count": 0} for k in _KINDS}
    if world > 1:
        use = torch.empty((), dtype=cfg.dtype).element_size()
        passes = 1
        if shape.kind == "train":
            passes = max(1, cfg.grad_accum) * (2 if cfg.remat else 1)
        for names, t, p in _walk(params, places):
            calls = _layers_of(names, t)
            sharded = _is_sharded(p)
            if sharded:
                out["all-gather"]["bytes"] += passes * prod(_local_shape(t.shape, p, world)) * use
                out["all-gather"]["count"] += passes * calls
            if shape.kind == "train":
                kind = "reduce-scatter" if sharded else "all-reduce"
                out[kind]["bytes"] += t.numel() * 4
                out[kind]["count"] += calls
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def _gathered_layer(cfg, params, places, world: int) -> int:
    """The largest gathered layer the trace does not hold already: over the
    stacked layers (the embedding, the head and each other top-level leaf
    or block apart), the most bytes of data-sharded leaves read in their
    stored dtype; 0 on one rank."""
    if world == 1:
        return 0
    casts = cfg.cast_params_before_use and cfg.param_dtype != cfg.dtype
    units: dict[str, int] = {}
    for names, t, p in _walk(params, places):
        if _is_sharded(p) and (names[-1] == "embed" or not casts):
            unit = names[0] if names[0] in _STACKED or len(names) > 1 else "/".join(names)
            units[unit] = units.get(unit, 0) + t.numel() * t.element_size() // _layers_of(names, t)
    return max(units.values(), default=0)


def trace_cell(cfg: configs.ArchConfig, shape: configs.Shape) -> dict[str, Any]:
    """Trace the cell's step once on the meta device on the current mesh
    and return the record's cost fields (the module docstring)."""
    from torch.distributed.tensor import Replicate

    world = sh.axis_size(sh.DATA)
    t0 = time.perf_counter()
    step, args, info = cell_step(cfg, shape, device="meta")
    params = args[0]
    psh = param_rules.param_shardings(cfg, params)
    held = _storage_keys(args)
    with _Tally(set(held)) as tally:
        result = step(*args)
    trace_s = time.perf_counter() - t0
    made = sum(n for k, n in _storage_keys(result).items() if k not in held)
    param_bytes = _local_bytes(params, psh, world)
    arg_bytes = param_bytes + _nbytes(_tensors(info["inputs"], []))
    alias = 0
    if shape.kind == "train":  # the optimizer state is an argument too; both are donated
        state_bytes = _local_bytes(args[1], {"m": psh, "v": psh, "step": (Replicate(),)}, world)
        arg_bytes += state_bytes
        alias = param_bytes + state_bytes
    memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": alias + made,
        "temp_bytes": tally.peak - made + _gathered_layer(cfg, params, psh, world),
        "alias_bytes": alias,
    }
    memory["peak_bytes_est"] = (memory["argument_bytes"] + memory["output_bytes"]
                                + memory["temp_bytes"] - memory["alias_bytes"])
    return {
        "trace_s": round(trace_s, 3),
        "flops": float(tally.flops),
        "bytes_accessed": float(tally.bytes_accessed),
        "collectives": _collectives(info["cfg"], shape, params, psh, world),
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
    """The record of one cell on the production mesh, traced inside a fake
    process group of its ranks, which is gone when this returns or raises."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = configs.SHAPES[shape_name]
    world = production_world(multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": production_mesh_name(multi_pod),
                 "chips": world, "tag": tag}
    with fake_mesh(world):
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
