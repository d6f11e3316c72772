"""B2 and B3: one weighted Lloyd pass (dense or pruned), bound for CUDA tensors.

Replace ``repro/kernels/fused_assign_update.py:fused_assign_update_pallas``
(B2) and ``fused_assign_update_pruned_pallas`` (B3). The CUDA source is
``csrc/fused_assign_update.cu``: a top-2 scan per row, per-CTA statistics
partials summed in row order, and a second kernel that reduces the partials
over CTAs in CTA order — deterministic, no float atomics. B3 is the same
kernel given a cached assignment and an active mask, so pruned statistics
are bit-identical to dense ones whenever the assignments agree. The plain
versions are :func:`repro_torch.kernels.ref.assign_update` and
:func:`~repro_torch.kernels.ref.assign_update_pruned`.

At the main path's shapes (≤ 14,528 representatives, d = 19, K = 27) the
pass moves about 1 MB and is bound by launch latency and the serial
per-CTA loops. ``fused_assign_update_cuda.launches`` and
``fused_assign_update_pruned_cuda.launches`` count launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_assign import DTYPE_CODES, check_operand, stream_of

__all__ = [
    "FUSED_MAX_KD1",
    "ROWS_PER_CTA",
    "check_fused",
    "fused_assign_update_cuda",
    "fused_assign_update_pruned_cuda",
    "fused_supported",
]

#: rows per CTA in ``csrc/top2.cuh``; one statistics partial per CTA
ROWS_PER_CTA = 128
#: largest K·(d + 1) a per-CTA partial may hold (64 KB of f32): bounds the
#: split-K scratch at half a kilobyte per row
FUSED_MAX_KD1 = 16_384

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def fused_supported(d: int, k: int) -> bool:
    """Whether ``[K, d]`` fits the fused kernels' per-CTA partial."""
    return k * (d + 1) <= FUSED_MAX_KD1


def check_fused(d: int, k: int) -> None:
    """Raise ``ValueError`` for a shape the fused kernels do not take."""
    if not fused_supported(d, k):
        raise ValueError(
            f"K·(d+1) = {k * (d + 1)} exceeds the fused kernels' limit {FUSED_MAX_KD1}; "
            "that shape needs the two-pass path (B4 cluster_sums kernel), not ported yet"
        )


def _fn():
    f = _build.library("fused_assign_update").bwkm_assign_update
    f.argtypes = [_P, _I, _P, _P, _I, _P, _P, _L, _I, _I] + [_P] * 9
    f.restype = ctypes.c_int
    return f


def _launch(x, w, c, cached, active):
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
    nb = -(-n // ROWS_PER_CTA)
    f32 = dict(dtype=torch.float32, device=dev)
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    d1, d2 = torch.empty(n, **f32), torch.empty(n, **f32)
    sums, counts, err = torch.empty(k, d, **f32), torch.empty(k, **f32), torch.empty((), **f32)
    part, errpart = torch.empty(max(nb, 1) * k * (d + 1), **f32), torch.empty(max(nb, 1), **f32)
    fn = _fn()
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], w.data_ptr(), c.data_ptr(),
            DTYPE_CODES[c.dtype],
            None if cached is None else cached.data_ptr(),
            None if active is None else active.data_ptr(),
            n, d, k, assign.data_ptr(), d1.data_ptr(), d2.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), err.data_ptr(), part.data_ptr(), errpart.data_ptr(),
            stream_of(dev),
        )
    if rc != 0:
        raise RuntimeError(f"fused assign+update kernel launch failed: cudaError_t {rc}")
    return assign, d1, d2, sums, counts, err


def fused_assign_update_cuda(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor):
    """Dense pass: ``(assign, d1, d2, sums, counts, err)``; rows with
    ``w == 0`` get an assignment but add nothing."""
    out = _launch(x, w, c, None, None)
    fused_assign_update_cuda.launches += 1
    return out


def fused_assign_update_pruned_cuda(
    x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, assign: torch.Tensor,
    active: torch.Tensor,
):
    """Pruned pass: as the dense one, with ``assign`` the cached ids and
    ``active`` the rows whose bounds could not prove them unchanged."""
    out = _launch(x, w, c, assign, active)
    fused_assign_update_pruned_cuda.launches += 1
    return out


fused_assign_update_cuda.launches = 0
fused_assign_update_pruned_cuda.launches = 0
