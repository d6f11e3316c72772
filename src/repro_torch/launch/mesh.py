"""The meshes: the one the drivers run the distributed engine on, and the
production mesh the dry run plans against.

Counterpart of ``repro.launch.mesh``. The reference's production mesh is
16 × 16 TPU chips (data × model), or 2 × 16 × 16 across two pods; the port
has no model axis, so :func:`make_production_mesh` puts the same chip
counts, 256 or 512, on its one ``"data"`` dimension. Records and result
directories name these meshes ``data256`` and ``data512``
(:func:`production_mesh_name`).
"""

from __future__ import annotations

import contextlib
import tempfile

import torch

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_smoke_mesh", "production_mesh_name",
           "production_world"]


def production_world(multi_pod: bool = False) -> int:
    """Ranks of the production mesh: the reference's 256 chips a pod, 512
    across two pods."""
    return 512 if multi_pod else 256


def production_mesh_name(multi_pod: bool = False) -> str:
    """``data256`` or ``data512``."""
    return f"data{production_world(multi_pod)}"


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda"):
    """The ``"data"`` ``DeviceMesh`` of :func:`production_world` ranks over
    the process group this process belongs to. Raises, naming the world
    size it needs, when there is no group or the group has another size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = production_world(multi_pod)
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh needs a process group of {world} ranks; "
                           f"start one first (init_process_group(..., world_size={world}))")
    if dist.get_world_size() != world:
        raise RuntimeError(f"make_production_mesh needs a process group of {world} ranks, "
                           f"this one has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, (world,), mesh_dim_names=("data",))


@contextlib.contextmanager
def make_smoke_mesh(device: str | torch.device = "cuda"):
    """A one-rank process group and its one-dimensional ``"data"``
    ``DeviceMesh``, for the distributed engine in one process: NCCL on the
    card, gloo on the CPU, rendezvous through a file in a temporary
    directory. Use as ``with make_smoke_mesh() as mesh, use_mesh(mesh):``;
    the group is destroyed on exit. Raises if this process already has a
    process group: build the mesh over that one instead."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group exists already; build the mesh over it with "
                           "init_device_mesh(..., mesh_dim_names=('data',))")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            yield init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
        finally:
            dist.destroy_process_group()
