"""The kernel seams every caller goes through. Counterpart of ``repro.kernels.ops``.

Dispatch goes by the device of the tensors: a CUDA tensor always goes to the
hand-written kernel (or the call raises), a CPU tensor to the plain version
in :mod:`repro_torch.kernels.ref`. There is no fallback from one to the other.

``n_dist`` — the distance evaluations a pass requires, the paper's cost unit
(Section 3) — is computed here, the same way for both devices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.ref import AssignUpdate, PrunedAssignUpdate

__all__ = [
    "AssignUpdate",
    "PrunedAssignUpdate",
    "assign_top2",
    "assign_top2_chunk",
    "assign_update",
    "assign_update_pruned",
    "pairwise_sqdist_chunk",
]


def _on_cuda(x: torch.Tensor, *others: torch.Tensor) -> bool:
    for t in others:
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    return x.device.type == "cuda"


def assign_top2(
    x: torch.Tensor, c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(assign, d1, d2)``: kernel B1 on CUDA, see ``ref.assign_top2``."""
    if _on_cuda(x, c):
        from repro_torch.kernels import distance_assign

        return distance_assign.assign_top2_cuda(x.contiguous(), c.contiguous())
    return ref.assign_top2(x, c)


def _pad_to_chunk(x: torch.Tensor, chunk_size: int) -> tuple[int, torch.Tensor]:
    """Zero-pad a ragged ``[n <= chunk_size, d]`` chunk to the chunk shape;
    callers slice the first ``n`` result rows off."""
    n = x.shape[0]
    if n > chunk_size:
        raise ValueError(f"chunk of {n} rows exceeds chunk_size={chunk_size}")
    if n < chunk_size:
        x = F.pad(x, (0, 0, 0, chunk_size - n))
    return n, x


def assign_top2_chunk(
    x: torch.Tensor, c: torch.Tensor, *, chunk_size: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk-shaped :func:`assign_top2`: the tail chunk is padded to
    ``chunk_size`` rows and the padding is sliced off the result."""
    n, x = _pad_to_chunk(x, chunk_size)
    assign, d1, d2 = assign_top2(x, c)
    return assign[:n], d1[:n], d2[:n]


def pairwise_sqdist_chunk(
    x: torch.Tensor, c: torch.Tensor, *, chunk_size: int
) -> torch.Tensor:
    """Chunk-shaped ``[n, K]`` squared-distance matrix (``transform``). The
    reference has no Pallas kernel here either; it is one matrix product."""
    n, x = _pad_to_chunk(x, chunk_size)
    return ref.pairwise_sqdist(x, c)[:n]


def _dense_dist_count(w: torch.Tensor, k: int) -> torch.Tensor:
    return (w > 0).float().sum() * k


def assign_update(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> AssignUpdate:
    """One weighted Lloyd pass: kernel B2 on CUDA, see ``ref.assign_update``.
    ``n_dist`` charges K per row with ``w > 0``."""
    if _on_cuda(x, w, c):
        from repro_torch.kernels import fused_assign_update as fau

        out = AssignUpdate(*fau.fused_assign_update_cuda(
            x.contiguous(), w.float().contiguous(), c.contiguous()
        ))
    else:
        out = ref.assign_update(x, w, c)
    return out._replace(n_dist=_dense_dist_count(w, c.shape[0]))


def assign_update_pruned(
    x: torch.Tensor,
    w: torch.Tensor,
    c: torch.Tensor,
    assign: torch.Tensor,
    active: torch.Tensor,
) -> PrunedAssignUpdate:
    """One drift-bound-pruned pass: kernel B3 on CUDA, see
    ``ref.assign_update_pruned``. ``n_dist`` charges K per active row with
    ``w > 0``, whatever granularity the kernel skips at."""
    n_dist = (active.bool() & (w > 0)).float().sum() * c.shape[0]
    if _on_cuda(x, w, c, assign, active):
        from repro_torch.kernels import fused_assign_update as fau

        out = PrunedAssignUpdate(*fau.fused_assign_update_pruned_cuda(
            x.contiguous(), w.float().contiguous(), c.contiguous(),
            assign.to(torch.int32).contiguous(), active.bool().contiguous(),
        ))
    else:
        out = ref.assign_update_pruned(x, w, c, assign, active)
    return out._replace(n_dist=n_dist)
