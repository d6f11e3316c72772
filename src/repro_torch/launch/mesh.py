"""The mesh the drivers run the distributed engine on.

Counterpart of ``repro.launch.mesh``'s ``make_smoke_mesh``. The reference's
``make_production_mesh`` (a 16 × 16 data × model mesh of TPU chips) serves
its models' sharding and comes with it (ROADMAP A16).
"""

from __future__ import annotations

import contextlib
import tempfile

import torch

from repro_torch.device import resolve_device

__all__ = ["make_smoke_mesh"]


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
