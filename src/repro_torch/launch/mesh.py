"""The meshes: the production meshes the dry run plans every config
against, the same ranks on one ``"data"`` dimension (FSDP alone), and the
one the drivers run the distributed engine on.

Counterpart of ``repro.launch.mesh``. The reference's production mesh is
16 × 16 chips (``("data", "model")``), or 2 × 16 × 16 across two pods
(``("pod", "data", "model")``): :func:`make_production_mesh`, which records
and result directories name ``16x16`` and ``2x16x16``
(:func:`production_mesh_name`, as the reference's dry run names them).
:func:`make_data_mesh` puts the same 256 or 512 ranks on one ``"data"``
dimension (``dryrun.fake_mesh`` without a shape).
"""

from __future__ import annotations

import contextlib
import tempfile
from math import prod

import torch

from repro_torch.device import resolve_device

__all__ = ["make_data_mesh", "make_production_mesh", "make_smoke_mesh",
           "production_mesh_name", "production_shape", "production_world"]


def production_shape(multi_pod: bool = False) -> tuple[int, ...]:
    """The reference's production mesh: 16 × 16, or 2 × 16 × 16."""
    return (2, 16, 16) if multi_pod else (16, 16)


def production_world(multi_pod: bool = False) -> int:
    """Ranks of the production mesh: the reference's 256 chips a pod, 512
    across two pods."""
    return prod(production_shape(multi_pod))


def production_mesh_name(multi_pod: bool = False) -> str:
    """``16x16`` or ``2x16x16``."""
    return "x".join(map(str, production_shape(multi_pod)))


def _mesh_over_group(shape: tuple[int, ...], names: tuple[str, ...], device, what: str):
    """The ``DeviceMesh`` of ``shape`` over this process's group, which must
    have as many ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group of {world} ranks; "
                           f"start one first (init_process_group(..., world_size={world}))")
    if dist.get_world_size() != world:
        raise RuntimeError(f"{what} needs a process group of {world} ranks, "
                           f"this one has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda"):
    """The reference's ``("data", "model")`` 16 × 16 ``DeviceMesh``, or
    ``("pod", "data", "model")`` 2 × 16 × 16, over the process group this
    process belongs to. Raises, naming the world size it needs, when there
    is no group or the group has another size."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh_over_group(production_shape(multi_pod), names, device, "make_production_mesh")


def make_data_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda"):
    """The ``"data"`` ``DeviceMesh`` of :func:`production_world` ranks over
    the process group this process belongs to. Raises as
    :func:`make_production_mesh`."""
    return _mesh_over_group((production_world(multi_pod),), ("data",), device, "make_data_mesh")


@contextlib.contextmanager
def make_smoke_mesh(device: str | torch.device = "cuda", shape: tuple[int, ...] | None = None):
    """A one-rank process group and its ``DeviceMesh``, for the sharded
    paths in one process: one ``"data"`` dimension by default, or
    ``shape`` (all ones) over the reference's names for its length, e.g.
    the reference's ``(1, 1, 1)`` ``("pod", "data", "model")``. NCCL on the
    card, gloo on the CPU, rendezvous through a file in a temporary
    directory. Use as ``with make_smoke_mesh() as mesh, use_mesh(mesh):``;
    the group is destroyed on exit. Raises if this process already has a
    process group: build the mesh over that one instead."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    shape = tuple(shape or (1,))
    names = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if names is None or prod(shape) != 1:
        raise ValueError(f"a smoke mesh is one rank over at most three dimensions, got {shape}")
    if dist.is_initialized():
        raise RuntimeError("a process group exists already; build the mesh over it with "
                           "init_device_mesh(..., mesh_dim_names=('data',))")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            yield init_device_mesh(dev.type, shape, mesh_dim_names=names)
        finally:
            dist.destroy_process_group()
