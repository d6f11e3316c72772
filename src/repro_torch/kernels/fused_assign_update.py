"""B2 and B3: one weighted Lloyd pass (dense or pruned), bound for CUDA tensors.

Replace ``repro/kernels/fused_assign_update.py:fused_assign_update_pallas``
(B2) and ``fused_assign_update_pruned_pallas`` (B3). The CUDA source is
``csrc/fused_assign_update.cu``: three launches, the top-2 scan that B1
runs (``csrc/top2.cuh``), writing the (composed) assignment and the
distances, then B4's fold
(``csrc/cluster_fold.cuh``: at most 128 CTAs, each streaming its rows
through a ring of TMA-filled stages and summing them in row order into a
shared-memory partial, with the error summed in row order beside it), then
a reduction of the partials in CTA order — deterministic, no float atomics,
and scratch that does not grow with n (:func:`fused_scratch_floats`). B3 is
the same launches given a cached assignment and an active mask, so pruned
statistics are bit-identical to dense ones whenever the assignments agree.
The plain versions are :func:`repro_torch.kernels.ref.assign_update` and
:func:`~repro_torch.kernels.ref.assign_update_pruned`.

At the main path's shapes (≤ 14,528 representatives, d = 19, K = 27) the
pass moves about 1 MB and is bound by launch latency; at the k-means||
weighting pass (every row, 561 candidates) by the scan's operations.
Both launch with an explicit plan for the scan and the fold
(:func:`repro_torch.roofline.analysis.assign_update_blocking`); every plan
the C side takes gives the same bits, and one it refuses raises
:class:`~repro_torch.kernels.distance_assign.PlanError`. B3's rows a thread
are not a knob: a row tile sets which inactive rows skip together.
``fused_assign_update_cuda.launches`` and
``fused_assign_update_pruned_cuda.launches`` count launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cluster_update import fold_args, fold_ctas
from repro_torch.kernels.distance_assign import (
    DTYPE_CODES,
    check_operand,
    check_rc,
    scan_args,
    stream_of,
)
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import FUSED_MAX_KD1

__all__ = [
    "FUSED_MAX_KD1",
    "ROWS_PER_CTA",
    "check_fused",
    "fused_assign_update_cuda",
    "fused_assign_update_pruned_cuda",
    "fused_scratch_floats",
    "fused_supported",
    "launch_pass",
]

#: fewest rows a row tile of the scan in ``csrc/top2.cuh`` holds
ROWS_PER_CTA = analysis.SCAN_THREADS

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def fused_supported(d: int, k: int) -> bool:
    """Whether ``[K, d]`` fits the fused kernels' per-CTA partial: the
    plan's ``fused_ok`` (K·(d + 1) ≤ :data:`FUSED_MAX_KD1`)."""
    return analysis.assign_update_blocking(d, k)["fused_ok"]


def fused_scratch_floats(n: int, d: int, k: int) -> int:
    """Floats of scratch one pass takes: one ``K·(d + 1) + 1`` partial (the
    statistics and the error) per fold CTA, at most 128 whatever n is."""
    return fold_ctas(n) * (k * (d + 1) + 1)


def check_fused(d: int, k: int) -> None:
    """Raise ``ValueError`` for a shape the fused kernels do not take."""
    if not fused_supported(d, k):
        raise ValueError(
            f"K·(d+1) = {k * (d + 1)} exceeds the fused kernels' limit {FUSED_MAX_KD1}; "
            "ops.assign_update takes the two-pass path (B1, then B4 cluster_sums) there"
        )


def _fn():
    f = _build.library("fused_assign_update").bwkm_assign_update_ex
    f.argtypes = [_P, _I, _P, _P, _I, _P, _P, _L, _I, _I] + [_P] * 7 + [_I] * 6 + [_P]
    f.restype = ctypes.c_int
    return f


def launch_pass(x, w, c, cached, active, plan):
    """One dense (``cached`` and ``active`` None) or pruned pass without the
    launch counts: the wrappers below count, the autotune's timing runs do
    not (they are not launches of the caller's path)."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused kernels take CUDA tensors, got {x.device}")
    dev = x.device
    check_operand("x", x, dev, DTYPE_CODES, 2)
    check_operand("c", c, dev, DTYPE_CODES, 2)
    check_operand("w", w, dev, (torch.float32,), 1)
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d or k < 1 or w.shape[0] != n:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, c {tuple(c.shape)} do not match"
        )
    check_fused(d, k)
    if cached is not None:
        check_operand("assign", cached, dev, (torch.int32,), 1)
        check_operand("active", active, dev, (torch.bool,), 1)
        if cached.shape[0] != n or active.shape[0] != n:
            raise ValueError("assign and active must have one entry per row of x")
    pruned = cached is not None
    if plan is None:
        plan = analysis.assign_update_blocking(d, k, n=n, dtype_bytes=x.element_size(),
                                               pruned=pruned)
    scan = scan_args(plan, n=n, d=d) if pruned else scan_args(plan)
    f32 = dict(dtype=torch.float32, device=dev)
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    d1, d2 = torch.empty(n, **f32), torch.empty(n, **f32)
    sums, counts, err = torch.empty(k, d, **f32), torch.empty(k, **f32), torch.empty((), **f32)
    part = torch.empty(max(fused_scratch_floats(n, d, k), 1), **f32)
    fn = _fn()
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], w.data_ptr(), c.data_ptr(),
            DTYPE_CODES[c.dtype],
            None if cached is None else cached.data_ptr(),
            None if active is None else active.data_ptr(),
            n, d, k, assign.data_ptr(), d1.data_ptr(), d2.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), err.data_ptr(), part.data_ptr(), *scan,
            *fold_args(plan["fold"]), stream_of(dev),
        )
    check_rc(rc, "fused assign+update")
    return assign, d1, d2, sums, counts, err


def fused_assign_update_cuda(
    x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, *, plan: dict | None = None
):
    """Dense pass: ``(assign, d1, d2, sums, counts, err)``; rows with
    ``w == 0`` get an assignment but add nothing. ``plan`` (``None``: the
    analytic one) is an ``analysis.assign_update_blocking`` plan."""
    out = launch_pass(x, w, c, None, None, plan)
    fused_assign_update_cuda.launches += 1
    return out


def fused_assign_update_pruned_cuda(
    x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, assign: torch.Tensor,
    active: torch.Tensor, *, plan: dict | None = None,
):
    """Pruned pass: as the dense one, with ``assign`` the cached ids and
    ``active`` the rows whose bounds could not prove them unchanged;
    ``plan`` an ``assign_update_blocking(..., pruned=True)`` plan whose rows
    a thread are the kernel's own at this n."""
    out = launch_pass(x, w, c, assign, active, plan)
    fused_assign_update_pruned_cuda.launches += 1
    return out


fused_assign_update_cuda.launches = 0
fused_assign_update_pruned_cuda.launches = 0
