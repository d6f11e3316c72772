"""B5: the k-means|| fold (running min-d² and its weighted cost), bound for
CUDA tensors.

Replaces ``repro/kernels/min_sqdist_update.py:min_sqdist_update_pallas`` and
stands for its Pallas-on-Triton twin ``repro/kernels/gpu.py:
min_sqdist_update_gpu``. The CUDA source is ``csrc/min_sqdist_update.cu``
over the scan of ``csrc/top2.cuh`` that B1–B3 run: persistent CTAs that load
only the valid candidates (``cvalid != 0``, compacted in id order) into
shared memory once per launch, then walk the rows in tiles, four rows a
thread, with each row's running min in a register (x read once per fold).
Rows too wide for four resident candidates (d > 14,432) take the scan's
wide-row form. Each row tile writes a cost partial and a second kernel sums
them in a fixed order — deterministic, no float atomics. The fold is bit for bit the fold
over ``cand[cvalid != 0]`` alone, and with no valid candidate ``mind2``
passes through. Its plain version is
:func:`repro_torch.kernels.ref.min_sqdist_update`.

At the k-means|| path's shapes (x [5,000,000, 19], L = 112) the fold is
bound by f32 operations, about 0.34 ms on an H100 against 0.13 ms for its
bytes. ``min_sqdist_update_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_assign import DTYPE_CODES, check_operand, stream_of
from repro_torch.kernels.fused_assign_update import ROWS_PER_CTA  # a cost partial per tile

__all__ = ["min_sqdist_update_cuda"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn():
    f = _build.library("min_sqdist_update").bwkm_min_sqdist_update
    f.argtypes = [_P, _I, _P, _P, _I, _P, _P, _L, _I, _I, _P, _P, _P, _P]
    f.restype = ctypes.c_int
    return f


def min_sqdist_update_cuda(
    x: torch.Tensor, w: torch.Tensor, cand: torch.Tensor, cvalid: torch.Tensor,
    mind2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mind2 f32[n], cost f32[])``: ``mind2`` folded with the candidates
    ``cand [L, d]`` whose ``cvalid [L]`` is nonzero, and ``Σ w·mind2``. x and
    cand are CUDA tensors of f32 or bf16; w, cvalid and mind2 are f32."""
    if x.device.type != "cuda":
        raise ValueError(f"min_sqdist_update_cuda takes CUDA tensors, got {x.device}")
    dev = x.device
    check_operand("x", x, dev, DTYPE_CODES, 2)
    check_operand("cand", cand, dev, DTYPE_CODES, 2)
    for name, t in (("w", w), ("cvalid", cvalid), ("mind2", mind2)):
        check_operand(name, t, dev, (torch.float32,), 1)
    n, d = x.shape
    n_cand = cand.shape[0]
    if cand.shape[1] != d or n_cand < 1 or cvalid.shape[0] != n_cand:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, cand {tuple(cand.shape)}, cvalid "
            f"{tuple(cvalid.shape)} do not match"
        )
    if w.shape[0] != n or mind2.shape[0] != n:
        raise ValueError("w and mind2 must have one entry per row of x")
    f32 = dict(dtype=torch.float32, device=dev)
    out, cost = torch.empty(n, **f32), torch.empty((), **f32)
    costpart = torch.empty(max(-(-n // ROWS_PER_CTA), 1), **f32)
    fn = _fn()
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], w.data_ptr(), cand.data_ptr(),
            DTYPE_CODES[cand.dtype], cvalid.data_ptr(), mind2.data_ptr(), n, d, n_cand,
            out.data_ptr(), cost.data_ptr(), costpart.data_ptr(), stream_of(dev),
        )
    if rc != 0:
        raise RuntimeError(f"min_sqdist_update kernel launch failed: cudaError_t {rc}")
    min_sqdist_update_cuda.launches += 1
    return out, cost


min_sqdist_update_cuda.launches = 0
