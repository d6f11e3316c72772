"""The kernel seams every caller goes through. Counterpart of ``repro.kernels.ops``.

Dispatch goes by the device of the tensors: a CUDA tensor always goes to the
hand-written kernel (or the call raises), a CPU tensor to the plain version
in :mod:`repro_torch.kernels.ref`. There is no fallback from one to the other.

``n_dist`` — the distance evaluations a pass requires, the paper's cost unit
(Section 3) — is computed here, the same way for both devices.

``assign_update`` and ``assign_update_pruned`` go to the fused kernels B2/B3
on CUDA where their ``[K, d + 1]`` partial fits (``fused_supported``), and
otherwise — on the CPU always — through the one two-pass body,
``ref.two_pass``, run with this module's seams: :func:`assign_top2` (B1),
then :func:`cluster_sums` (B4) under the (composed) assignment.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.fused_assign_update import fused_supported
from repro_torch.kernels.ref import AssignUpdate, MinSqDistUpdate, PrunedAssignUpdate

__all__ = [
    "AssignUpdate",
    "MinSqDistUpdate",
    "PrunedAssignUpdate",
    "assign_top2",
    "assign_top2_chunk",
    "assign_update",
    "assign_update_chunk",
    "assign_update_pruned",
    "assign_update_pruned_chunk",
    "cluster_sums",
    "min_sqdist_update",
    "min_sqdist_update_chunk",
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


def cluster_sums(
    x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor, num_clusters: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sums [K, d], counts [K])``: kernel B4 on CUDA, see ``ref.cluster_sums``."""
    if _on_cuda(x, w, assign):
        from repro_torch.kernels import cluster_update

        return cluster_update.cluster_sums_cuda(
            x.contiguous(), w.float().contiguous(), assign.to(torch.int32).contiguous(),
            num_clusters,
        )
    return ref.cluster_sums(x, w, assign, num_clusters)


def _dense_dist_count(w: torch.Tensor, k: int) -> torch.Tensor:
    return (w > 0).float().sum() * k


def assign_update(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> AssignUpdate:
    """One weighted Lloyd pass, see ``ref.assign_update``: kernel B2 on CUDA
    where it fits, else the two-pass body. ``n_dist`` charges K per row with
    ``w > 0``."""
    if _on_cuda(x, w, c) and fused_supported(x.shape[1], c.shape[0]):
        from repro_torch.kernels import fused_assign_update as fau

        out = AssignUpdate(*fau.fused_assign_update_cuda(
            x.contiguous(), w.float().contiguous(), c.contiguous()
        ))
    else:
        out = AssignUpdate(*ref.two_pass(assign_top2, cluster_sums, x, w, c))
    return out._replace(n_dist=_dense_dist_count(w, c.shape[0]))


def assign_update_chunk(
    x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, *, chunk_size: int
) -> AssignUpdate:
    """Chunk-shaped :func:`assign_update`: the tail chunk is padded to
    ``chunk_size`` rows of weight 0, so the statistics are exactly those of
    the ``n`` real rows; the per-row outputs are sliced back to ``n``."""
    n, x = _pad_to_chunk(x, chunk_size)
    w = F.pad(w.float(), (0, chunk_size - n))
    out = assign_update(x, w, c)
    return out._replace(assign=out.assign[:n], d1=out.d1[:n], d2=out.d2[:n])


def assign_update_pruned(
    x: torch.Tensor,
    w: torch.Tensor,
    c: torch.Tensor,
    assign: torch.Tensor,
    active: torch.Tensor,
) -> PrunedAssignUpdate:
    """One drift-bound-pruned pass, see ``ref.assign_update_pruned``: kernel
    B3 on CUDA where it fits, else the two-pass body. ``n_dist`` charges K
    per active row with ``w > 0``, whatever granularity the kernel skips
    at."""
    n_dist = (active.bool() & (w > 0)).float().sum() * c.shape[0]
    if _on_cuda(x, w, c, assign, active) and fused_supported(x.shape[1], c.shape[0]):
        from repro_torch.kernels import fused_assign_update as fau

        out = PrunedAssignUpdate(*fau.fused_assign_update_pruned_cuda(
            x.contiguous(), w.float().contiguous(), c.contiguous(),
            assign.to(torch.int32).contiguous(), active.bool().contiguous(),
        ))
    else:
        out = PrunedAssignUpdate(
            *ref.two_pass(assign_top2, cluster_sums, x, w, c, assign, active)
        )
    return out._replace(n_dist=n_dist)


def assign_update_pruned_chunk(
    x: torch.Tensor,
    w: torch.Tensor,
    c: torch.Tensor,
    assign: torch.Tensor,
    active: torch.Tensor,
    *,
    chunk_size: int,
) -> PrunedAssignUpdate:
    """Chunk-shaped :func:`assign_update_pruned`: padding rows have weight
    0, are never active and have cached id 0, so they add nothing; the
    per-row outputs are sliced back to ``n``."""
    n, x = _pad_to_chunk(x, chunk_size)
    pad = chunk_size - n
    w = F.pad(w.float(), (0, pad))
    assign = F.pad(assign.to(torch.int32), (0, pad))
    active = F.pad(active.bool(), (0, pad))
    out = assign_update_pruned(x, w, c, assign, active)
    return out._replace(assign=out.assign[:n], d1=out.d1[:n], d2=out.d2[:n])


def min_sqdist_update(
    x: torch.Tensor,
    w: torch.Tensor,
    cand: torch.Tensor,
    cvalid: torch.Tensor,
    mind2: torch.Tensor,
) -> MinSqDistUpdate:
    """One k-means|| fold: kernel B5 on CUDA, see ``ref.min_sqdist_update``.
    ``n_dist`` charges one distance per row with ``w > 0`` and valid
    candidate."""
    n_dist = (w > 0).float().sum() * (cvalid > 0).float().sum()
    if _on_cuda(x, w, cand, cvalid, mind2):
        from repro_torch.kernels import min_sqdist_update as msu

        out = MinSqDistUpdate(*msu.min_sqdist_update_cuda(
            x.contiguous(), w.float().contiguous(), cand.contiguous(),
            cvalid.float().contiguous(), mind2.float().contiguous(),
        ))
    else:
        out = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
    return out._replace(n_dist=n_dist)


def min_sqdist_update_chunk(
    x: torch.Tensor,
    w: torch.Tensor,
    cand: torch.Tensor,
    cvalid: torch.Tensor,
    mind2: torch.Tensor,
    *,
    chunk_size: int,
) -> MinSqDistUpdate:
    """Chunk-shaped :func:`min_sqdist_update`: padding rows carry weight 0
    and min-d² 0, so they add nothing, and the per-row output is sliced
    back to ``n``."""
    n, x = _pad_to_chunk(x, chunk_size)
    pad = chunk_size - n
    w = F.pad(w.float(), (0, pad))
    mind2 = F.pad(mind2.float(), (0, pad))
    out = min_sqdist_update(x, w, cand, cvalid, mind2)
    return out._replace(mind2=out.mind2[:n])
