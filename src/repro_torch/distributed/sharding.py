"""The mesh context, the logical layout rule, and the few collectives the
sharded planes run.

Counterpart of ``repro.distributed.sharding``: :func:`use_mesh`,
:func:`current_mesh`, :func:`axis_size`, :func:`batch_axes`,
:func:`logical_to_spec`, :func:`named_sharding` and :func:`shard`. The mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimensions are
``("data",)``, ``("data", "model")`` or ``("pod", "data", "model")``, the
reference's production layouts, built by the caller over a process group
it started::

    dist.init_process_group("nccl", init_method=..., rank=r, world_size=w)
    mesh = init_device_mesh("cuda", (w // m, m), mesh_dim_names=("data", "model"))
    with use_mesh(mesh):
        ...

Outside any mesh every collective here is the identity, as the reference's
``mesh is None`` path is.

Logical axes map to mesh dimensions as the reference maps them::

  batch    -> ("pod", "data")   activations' leading dim / FSDP weight dim
  seq      -> "model"           the residual stream between layers
  tensor   -> "model"           heads / ff / vocab / experts' ff
  expert   -> "model"           the MoE's expert-parallel groups

and an axis that does not divide its dimension is dropped
(:func:`logical_to_spec`, the reference's ``_dim_spec``). A layout is a
tuple of ``torch.distributed.tensor`` placements, one a mesh dimension:
``Shard(d)`` or ``Replicate()``; a dimension over ``("pod", "data")`` is
``Shard(d)`` on both, pod the outer.

:func:`shard` is a layout statement: it checks the rank and returns its
input. The port's layers keep each tensor in the layout the reference's
constraint names (``models.transformer``: the residual split on the
sequence over ``"model"``, heads and ff split inside attention and the
MLP), with explicit collectives (``distributed.tp``) where GSPMD would
insert them. ``shard_map`` is left out by design: the MoE islands
(``models.moe``) are plain functions with explicit collectives.

The collectives use only ``all_reduce`` (SUM, MIN, MAX): NCCL and gloo both
take it on CUDA tensors, where gloo has no ``all_gather``. They run over a
group of mesh dimensions: by default the batch axes (``"pod"`` and
``"data"``, flattened pod-major), the ``"model"`` dimension for the tensor
parallel collectives; over several dimensions one call is an ``all_reduce``
a dimension. A gather is an ``all_reduce`` SUM of a zero-filled ``[G, ...]``
buffer in which each rank fills its own slot, which is exact, since each
entry has one non-zero term. Every f32 combine gathers the G partials and
adds them in rank order (:func:`_sum_over_ranks`), so a result does not
depend on the backend's reduction order and is the same from run to run at
a given G.

Each collective issued here is counted by kind in
:data:`COLLECTIVE_COUNTS` (its bytes and calls), which
``repro_torch.roofline.analysis.collective_bytes`` reads in the shape of the
reference's ``parse_collective_bytes``. The FSDP step
(``distributed.fsdp``) and the tensor-parallel layers (``distributed.tp``)
build their collectives the same way.
"""

from __future__ import annotations

import contextlib
import threading
from math import prod
from typing import Any, Sequence

import torch

__all__ = ["axis_size", "batch_axes", "current_mesh", "logical_to_spec", "named_sharding",
           "shard", "use_mesh"]

#: the mesh dimensions of the port
DATA, MODEL, POD = "data", "model", "pod"
#: the mesh layouts the port takes: the reference's
LAYOUTS = ((DATA,), (DATA, MODEL), (POD, DATA, MODEL))

_local = threading.local()

#: bytes and calls of the collectives issued in this process, by kind: a
#: reduction is an ``all-reduce``; a gather, one ``all_reduce`` of a
#: ``[G, ...]`` buffer, an ``all-gather`` (each call is counted once); the
#: FSDP step's gradient reductions (``distributed.fsdp``) and the sums after
#: a row-parallel product (``distributed.tp``) a ``reduce-scatter``, the
#: embedding's exchange of rows and the MoE's token exchange an ``all-to-all``
COLLECTIVE_COUNTS = {kind: {"bytes": 0, "count": 0}
                     for kind in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")}


@contextlib.contextmanager
def use_mesh(mesh: Any):
    """Make ``mesh`` (a ``DeviceMesh`` with dimensions ``("data",)``,
    ``("data", "model")`` or ``("pod", "data", "model")``, or ``None``) the
    current mesh inside the block."""
    if mesh is not None and tuple(mesh.mesh_dim_names or ()) not in LAYOUTS:
        raise ValueError(f"the port's mesh has one dimension named {DATA!r}, or the dimensions "
                         f"{LAYOUTS[1]} or {LAYOUTS[2]}; got {mesh.mesh_dim_names}")
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def current_mesh() -> Any:
    return getattr(_local, "mesh", None)


def _names() -> tuple[str, ...]:
    mesh = current_mesh()
    return () if mesh is None else tuple(mesh.mesh_dim_names)


def axis_size(name: str) -> int:
    """Ranks along mesh dimension ``name``; 1 without a mesh or such a dimension."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(name)))


def batch_axes() -> tuple[str, ...]:
    """The data-parallel mesh dimensions present on the current mesh."""
    return tuple(a for a in (POD, DATA) if a in _names())


def group_size(axes: Sequence[str]) -> int:
    """Ranks of the group over mesh dimensions ``axes``."""
    return prod(axis_size(a) for a in axes)


def group_rank(axes: Sequence[str]) -> int:
    """This process's rank in the group over ``axes``, row-major in the
    order given (0 without a mesh)."""
    mesh = current_mesh()
    r = 0
    for a in axes:
        if mesh is not None and a in mesh.mesh_dim_names:
            r = r * axis_size(a) + int(mesh.get_local_rank(a))
    return r


# ------------------------------------------------------------ the layout rule
def _dim_spec(entry, size: int) -> tuple[str, ...] | None:
    """One logical entry resolved to the mesh dimensions that divide
    ``size`` together (the reference's rule: an entry that does not divide
    is dropped whole), ``None`` where it resolves to none."""
    if entry is None:
        return None
    resolved: list[str] = []
    for name in entry if isinstance(entry, tuple) else (entry,):
        if name == "batch":
            resolved.extend(batch_axes())
        elif name in ("seq", "tensor", "expert", MODEL):
            if axis_size(MODEL) > 1:
                resolved.append(MODEL)
        elif name in (POD, DATA):
            if name in _names():
                resolved.append(name)
        else:
            raise ValueError(f"unknown logical axis {name!r}")
    resolved = list(dict.fromkeys(resolved))
    if not resolved or size % prod(axis_size(a) for a in resolved):
        return None
    return tuple(resolved)


def logical_to_spec(logical: Sequence, shape: Sequence[int]) -> tuple:
    """The placement tuple of a tensor of ``shape`` whose dimensions have
    the logical axes ``logical``: for each dimension of the current mesh,
    ``Shard(d)`` where it splits dimension ``d``, else ``Replicate()``
    (``()`` without a mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    if len(logical) != len(shape):
        raise ValueError(f"logical axes {tuple(logical)} for a tensor of shape {tuple(shape)}")
    owner: dict[str, int] = {}
    for d, (entry, size) in enumerate(zip(logical, shape)):
        for name in _dim_spec(entry, int(size)) or ():
            owner.setdefault(name, d)
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in _names())


def named_sharding(logical: Sequence, shape: Sequence[int]) -> tuple | None:
    """:func:`logical_to_spec` on the current mesh; ``None`` without one
    (the reference's ``NamedSharding`` is the mesh with its spec)."""
    return None if current_mesh() is None else logical_to_spec(logical, shape)


def shard(x: torch.Tensor, *logical) -> torch.Tensor:
    """``x`` itself: a logical layout statement (one entry per dimension:
    a logical axis name, a tuple of them, or ``None``). The port's layers
    hold each tensor in that layout themselves (the module docstring)."""
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} logical axes for a tensor of {x.ndim} dimensions")
    return x


# ------------------------------------------------------------ the collectives
def _mesh_rank() -> int:
    """This process's rank over the batch axes; 0 without a mesh. Every
    model rank of a batch group reads the same."""
    return group_rank(batch_axes())


def _process_rank() -> int:
    """This process's rank over every dimension of the mesh, row-major (0
    only at coordinate 0 on every dimension); 0 without a mesh."""
    return group_rank(_names())


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def _all_reduce(t: torch.Tensor, op: str = "sum", kind: str = "all-reduce",
                nbytes: int | None = None, axes: Sequence[str] | None = None) -> torch.Tensor:
    """``t`` reduced over the group of ``axes`` (default: the batch axes)
    in place (``op`` one of sum, min, max); ``t`` itself without a mesh.
    Integer and min/max reductions, and sums with one non-zero term an
    entry, are exact. The call is counted once under ``kind`` with
    ``nbytes`` (default: ``t``'s)."""
    mesh = current_mesh()
    if mesh is None:
        return t
    import torch.distributed as dist

    tally = COLLECTIVE_COUNTS[kind]
    tally["bytes"] += t.numel() * t.element_size() if nbytes is None else nbytes
    tally["count"] += 1
    axes = batch_axes() if axes is None else axes
    for a in axes:
        if axis_size(a) > 1 or len(axes) == 1:
            dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=mesh.get_group(a))
    return t


def _gather(t: torch.Tensor, axes: Sequence[str] | None = None,
            kind: str = "all-gather", nbytes: int | None = None) -> torch.Tensor:
    """``[G, *t.shape]``: every rank's ``t`` over the group of ``axes``
    (default: the batch axes) in rank order, exactly."""
    axes = batch_axes() if axes is None else axes
    buf = torch.zeros((group_size(axes), *t.shape), dtype=t.dtype, device=t.device)
    buf[group_rank(axes)] = t
    return _all_reduce(buf, kind=kind, nbytes=nbytes, axes=axes)


def _sum_over_ranks(*parts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each f32 tensor of ``parts`` summed over the batch ranks, the
    partials added in rank order (one gather for all of them); ``parts``
    themselves without a mesh."""
    if current_mesh() is None:
        return parts
    g = _gather(torch.cat([p.reshape(-1).float() for p in parts]))
    acc = g[0].clone()
    for r in range(1, g.shape[0]):
        acc += g[r]
    out, i = [], 0
    for p in parts:
        out.append(acc[i : i + p.numel()].view(p.shape))
        i += p.numel()
    return tuple(out)


def _row_block(n_local: int, device) -> tuple[int, int]:
    """``(n, offset)``: the rows over all batch ranks, and where this
    rank's contiguous block of ``n_local`` starts among them (ranks hold
    their blocks in rank order)."""
    if current_mesh() is None:
        return n_local, 0
    counts = _gather(torch.tensor(n_local, dtype=torch.int64, device=device)).tolist()
    return sum(counts), sum(counts[: _mesh_rank()])
