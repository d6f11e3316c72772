"""The mesh context, and the few collectives the sharded plane runs.

Counterpart of the mesh context of ``repro.distributed.sharding``:
:func:`use_mesh`, :func:`current_mesh`, :func:`axis_size` and
:func:`batch_axes`. The mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with one dimension named ``"data"``, which the caller builds over a process
group it started::

    dist.init_process_group("nccl", init_method=..., rank=r, world_size=w)
    mesh = init_device_mesh("cuda", (w,), mesh_dim_names=("data",))
    with use_mesh(mesh):
        BWKM(k=27, engine="distributed").fit(x)

Outside any mesh the plane is one shard and every collective here is the
identity, as the reference's ``mesh is None`` path is.

The collectives use only ``all_reduce`` (SUM, MIN, MAX): NCCL and gloo both
take it on CUDA tensors, where gloo has no ``all_gather``. A gather is an
``all_reduce`` SUM of a zero-filled ``[W, ...]`` buffer in which each rank
fills its own slot, which is exact, since each entry has one non-zero term.
Every f32 combine gathers the W partials and adds them in rank order
(:func:`_sum_over_ranks`), so a result does not depend on the backend's
reduction order and is the same from run to run at a given W.

Each collective issued here is counted by kind in
:data:`COLLECTIVE_COUNTS` (its bytes and calls), which
``repro_torch.roofline.analysis.collective_bytes`` reads in the shape of the
reference's ``parse_collective_bytes``.

The port splits rows only: there is no ``"model"`` axis. So
:func:`shard`, the models' layout constraint, returns its input (the
reference's is a no-op without a model mesh too), and the reference's
helpers that serve the model axis (``named_sharding``, ``logical_to_spec``,
``shard_map``) are left out by design.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

__all__ = ["axis_size", "batch_axes", "current_mesh", "shard", "use_mesh"]

#: the one mesh dimension of the port
DATA = "data"

_local = threading.local()

#: bytes and calls of the collectives issued in this process, by kind: a
#: reduction is an ``all-reduce``; a gather, one ``all_reduce`` of a
#: ``[W, ...]`` buffer, an ``all-gather`` (each call is counted once)
COLLECTIVE_COUNTS = {kind: {"bytes": 0, "count": 0} for kind in ("all-gather", "all-reduce")}


@contextlib.contextmanager
def use_mesh(mesh: Any):
    """Make ``mesh`` (a ``DeviceMesh`` with one dimension named ``"data"``,
    or ``None``) the current mesh inside the block."""
    if mesh is not None and tuple(mesh.mesh_dim_names or ()) != (DATA,):
        raise ValueError(
            f"the port's mesh has one dimension named {DATA!r}, got {mesh.mesh_dim_names}"
        )
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def current_mesh() -> Any:
    return getattr(_local, "mesh", None)


def axis_size(name: str) -> int:
    """Ranks along mesh dimension ``name``; 1 without a mesh or such a dimension."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(name)))


def batch_axes() -> tuple[str, ...]:
    """The data-parallel mesh dimensions present on the current mesh."""
    mesh = current_mesh()
    return () if mesh is None else (DATA,)


def shard(x: torch.Tensor, *logical) -> torch.Tensor:
    """``x`` itself: a logical layout constraint (one entry per dimension:
    a logical axis name, a tuple of them, or ``None``), which the port,
    with no model axis, leaves to the caller's placement."""
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} logical axes for a tensor of {x.ndim} dimensions")
    return x


def _mesh_rank() -> int:
    """This process's rank along ``"data"``; 0 without a mesh."""
    mesh = current_mesh()
    return 0 if mesh is None else int(mesh.get_local_rank(DATA))


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def _all_reduce(t: torch.Tensor, op: str = "sum", kind: str = "all-reduce") -> torch.Tensor:
    """``t`` reduced over the ranks in place (``op`` one of sum, min, max);
    ``t`` itself without a mesh. Integer and min/max reductions are exact.
    The call is counted under ``kind``."""
    mesh = current_mesh()
    if mesh is None:
        return t
    import torch.distributed as dist

    tally = COLLECTIVE_COUNTS[kind]
    tally["bytes"] += t.numel() * t.element_size()
    tally["count"] += 1
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=mesh.get_group(DATA))
    return t


def _gather(t: torch.Tensor) -> torch.Tensor:
    """``[W, *t.shape]``: every rank's ``t`` in rank order, exactly."""
    buf = torch.zeros((axis_size(DATA), *t.shape), dtype=t.dtype, device=t.device)
    buf[_mesh_rank()] = t
    return _all_reduce(buf, kind="all-gather")


def _sum_over_ranks(*parts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each f32 tensor of ``parts`` summed over the ranks, the W partials
    added in rank order (one gather for all of them); ``parts`` themselves
    without a mesh."""
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
    """``(n, offset)``: the rows over all ranks, and where this rank's
    contiguous block of ``n_local`` starts among them (ranks hold their
    blocks in rank order)."""
    if current_mesh() is None:
        return n_local, 0
    counts = _gather(torch.tensor(n_local, dtype=torch.int64, device=device)).tolist()
    return sum(counts), sum(counts[: _mesh_rank()])
