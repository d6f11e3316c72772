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
bytes. It launches with an explicit plan
(:func:`repro_torch.roofline.analysis.min_sqdist_blocking`: candidates per
resident chunk and a cap on the grid), which the C side checks; its rows a
thread are the kernel's own at n, since each row tile writes one cost
partial and so sets the order φ is summed in.
``min_sqdist_update_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_assign import (
    DTYPE_CODES,
    check_operand,
    check_rc,
    scan_args,
    stream_of,
)
from repro_torch.kernels.fused_assign_update import ROWS_PER_CTA  # a cost partial per tile
from repro_torch.roofline import analysis

__all__ = ["launch_fold", "min_sqdist_update_cuda"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn():
    f = _build.library("min_sqdist_update").bwkm_min_sqdist_update_ex
    f.argtypes = [_P, _I, _P, _P, _I, _P, _P, _L, _I, _I, _P, _P, _P, _I, _I, _I, _P]
    f.restype = ctypes.c_int
    return f


def min_sqdist_update_cuda(
    x: torch.Tensor, w: torch.Tensor, cand: torch.Tensor, cvalid: torch.Tensor,
    mind2: torch.Tensor, *, plan: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mind2 f32[n], cost f32[])``: ``mind2`` folded with the candidates
    ``cand [L, d]`` whose ``cvalid [L]`` is nonzero, and ``Σ w·mind2``. x and
    cand are CUDA tensors of f32 or bf16; w, cvalid and mind2 are f32.
    ``plan`` is an ``analysis.min_sqdist_blocking`` plan (``None``: the
    analytic one) whose rows a thread are the kernel's own at this n."""
    out = launch_fold(x, w, cand, cvalid, mind2, plan)
    min_sqdist_update_cuda.launches += 1
    return out


def launch_fold(x, w, cand, cvalid, mind2, plan):
    """:func:`min_sqdist_update_cuda` without the launch count: the
    autotune's timing runs, which are not launches of the caller's path."""
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
    if plan is None:
        plan = analysis.min_sqdist_blocking(d, n_cand, n=n, dtype_bytes=x.element_size())
    scan = scan_args(plan, n=n, d=d)
    f32 = dict(dtype=torch.float32, device=dev)
    out, cost = torch.empty(n, **f32), torch.empty((), **f32)
    costpart = torch.empty(max(-(-n // ROWS_PER_CTA), 1), **f32)
    fn = _fn()
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], w.data_ptr(), cand.data_ptr(),
            DTYPE_CODES[cand.dtype], cvalid.data_ptr(), mind2.data_ptr(), n, d, n_cand,
            out.data_ptr(), cost.data_ptr(), costpart.data_ptr(), *scan, stream_of(dev),
        )
    check_rc(rc, "min_sqdist_update")
    return out, cost


min_sqdist_update_cuda.launches = 0
