"""B4: weighted per-cluster sums and counts for a given assignment, bound for
CUDA tensors.

Replaces ``repro/kernels/cluster_update.py:cluster_sums_pallas``. The CUDA
source is ``csrc/cluster_sums.cu`` over the fold of ``csrc/cluster_fold.cuh``,
which B2/B3 share: a fixed grid of at most 128 CTAs along the rows, each
streaming its contiguous rows through a ring of TMA-filled stages and
adding them in row order into a ``[K-tile, column-chunk]`` partial in shared
memory (one warp per cluster residue, one lane per column), then a second
kernel that sums the partials in CTA order — deterministic, no float
atomics, scratch that does not grow with n, and any d (past ``d + 1 =
40,960`` the columns are tiled too, which leaves the bits as they are). Its
plain version is :func:`repro_torch.kernels.ref.cluster_sums`.

It is the second pass of ``ops.assign_update`` / ``assign_update_pruned``
wherever the fused kernels' partial does not fit (``K·(d + 1) > 16,384``),
such as the k-means|| weighting pass over 2,001 candidates. There it is
bound by memory: about 0.125 ms on an H100 for x [5,000,000, 19]. It
launches with an explicit fold plan
(:func:`repro_torch.roofline.analysis.cluster_sums_blocking`: the partial's
``[kt, cw]`` tiling and the ring's stages), which the C side checks.
``cluster_sums_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_assign import DTYPE_CODES, check_operand, check_rc, stream_of
from repro_torch.roofline import analysis

__all__ = ["cluster_sums_cuda", "fold_args", "fold_ctas", "kernel_fold_plan"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def fold_ctas(n: int) -> int:
    """CTAs along the rows of the shared fold over ``n`` rows: one partial
    each, at most 128 whatever n is."""
    return min(analysis.FOLD_MAX_CTAS, -(-n // analysis.FOLD_TILE))


def fold_args(fold: dict) -> list[int]:
    """A fold plan's integers ``(kt, cw, stages)``, as the kernels take them."""
    return [int(fold["kt"]), int(fold["cw"]), int(fold["stages"])]


def kernel_fold_plan(
    n: int, d: int, k: int, *, dtype_bytes: int = 4, err: bool = True, act: bool = False,
    kt: int = 0, cw: int = 0, stages: int = 0,
) -> dict:
    """What the statistics fold launches with for this plan, as the C side
    (``bwkm_fold_plan``) fills it, under the keys of ``analysis.fold_plan``;
    raises ``PlanError`` for a plan it refuses. Host code: it needs the
    built library, not a card."""
    f = _build.library("cluster_sums").bwkm_fold_plan
    f.argtypes = [_L, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    f.restype = ctypes.c_int
    out = (ctypes.c_longlong * 9)()
    check_rc(f(n, d, k, dtype_bytes, int(err), int(act), kt, cw, stages,
               ctypes.addressof(out)), "fold plan")
    keys = ("kt", "cw", "stages", "xstaged", "sbytes", "pbytes", "smem_bytes", "ctas", "tiles")
    plan = dict(zip(keys, out))
    plan["xstaged"] = bool(plan["xstaged"])
    return plan


def _fn():
    f = _build.library("cluster_sums").bwkm_cluster_sums_ex
    f.argtypes = [_P, _I, _P, _P, _L, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P]
    f.restype = ctypes.c_int
    return f


def cluster_sums_cuda(
    x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor, num_clusters: int, *,
    plan: dict | None = None, _part_floats: int = 0, _phases: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sums f32[K, d], counts f32[K])`` of ``x [n, d]`` (f32 or bf16)
    weighted by ``w [n]`` (f32) under ``assign [n]`` (i32); rows with
    ``w == 0`` or an id outside ``[0, K)`` add nothing. ``plan`` is an
    ``analysis.cluster_sums_blocking`` plan (``None``: the analytic one).

    The private ``_part_floats`` caps the analytic plan's shared partial (0:
    its default), which tiles clusters and columns more finely and leaves
    the bits as they are; ``_phases`` runs the fold (1) or the reduction (2)
    alone. Both exist to test and time the fold."""
    if x.device.type != "cuda":
        raise ValueError(f"cluster_sums_cuda takes CUDA tensors, got {x.device}")
    dev = x.device
    check_operand("x", x, dev, DTYPE_CODES, 2)
    check_operand("w", w, dev, (torch.float32,), 1)
    check_operand("assign", assign, dev, (torch.int32,), 1)
    n, d = x.shape
    k = int(num_clusters)
    if w.shape[0] != n or assign.shape[0] != n:
        raise ValueError("w and assign must have one entry per row of x")
    if k < 1 or d < 1:
        raise ValueError(f"cluster_sums_cuda takes K >= 1 and d >= 1, got {k}, {d}")
    if plan is None:
        plan = analysis.cluster_sums_blocking(d, k, n=n, dtype_bytes=x.element_size(),
                                              part_floats=_part_floats)
    f32 = dict(dtype=torch.float32, device=dev)
    sums, counts = torch.empty(k, d, **f32), torch.empty(k, **f32)
    part = torch.empty(max(fold_ctas(n), 1) * k * (d + 1), **f32)
    fn = _fn()
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], w.data_ptr(), assign.data_ptr(), n, d, k,
            sums.data_ptr(), counts.data_ptr(), part.data_ptr(), *fold_args(plan),
            int(_phases), stream_of(dev),
        )
    check_rc(rc, "cluster_sums")
    cluster_sums_cuda.launches += 1
    return sums, counts


cluster_sums_cuda.launches = 0
