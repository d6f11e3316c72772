"""B1: the fused distance + argmin + top-2 kernel, bound for CUDA tensors.

Replaces ``repro/kernels/distance_assign.py:assign_top2_pallas``. The CUDA
source is ``csrc/distance_assign.cu`` (with ``csrc/top2.cuh``); its plain
version is :func:`repro_torch.kernels.ref.assign_top2`. On an H100 at the
main path's shapes the kernel is bound by memory and launch latency (about
11 FLOP per byte at d = 19, K = 27); it reads x once and never writes the
``[n, K]`` distance matrix. ``assign_top2_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["DTYPE_CODES", "assign_top2_cuda", "check_operand", "stream_of"]

#: element types the kernels load; they always compute in f32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def check_operand(name: str, t: torch.Tensor, device: torch.device, dtypes, ndim: int):
    """Raise on what the kernels do not take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes {list(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _fn():
    f = _build.library("distance_assign").bwkm_assign_top2
    f.argtypes = [_P, _I, _P, _I, _L, _I, _I, _P, _P, _P, _P]
    f.restype = ctypes.c_int
    return f


def assign_top2_cuda(
    x: torch.Tensor, c: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(assign i32[n], d1 f32[n], d2 f32[n])`` of ``x [n,d]`` against
    ``c [K,d]``, both CUDA tensors of f32 or bf16."""
    if x.device.type != "cuda":
        raise ValueError(f"assign_top2_cuda takes CUDA tensors, got {x.device}")
    check_operand("x", x, x.device, DTYPE_CODES, 2)
    check_operand("c", c, x.device, DTYPE_CODES, 2)
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d or k < 1:
        raise ValueError(f"shapes x {tuple(x.shape)} and c {tuple(c.shape)} do not match")
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    d1 = torch.empty(n, dtype=torch.float32, device=x.device)
    d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    fn = _fn()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], c.data_ptr(), DTYPE_CODES[c.dtype],
            n, d, k, assign.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            stream_of(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"assign_top2 kernel launch failed: cudaError_t {rc}")
    assign_top2_cuda.launches += 1
    return assign, d1, d2


assign_top2_cuda.launches = 0
