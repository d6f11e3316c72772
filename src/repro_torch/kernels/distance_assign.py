"""B1: the fused distance + argmin + top-2 kernel, bound for CUDA tensors.

Replaces ``repro/kernels/distance_assign.py:assign_top2_pallas``. The CUDA
source is ``csrc/distance_assign.cu`` over the scan of ``csrc/top2.cuh``
(the centroids resident in shared memory for the launch, rows blocked in
registers; rows too wide for four resident centroids, d > 14,432, take its
wide-row form); its plain version is :func:`repro_torch.kernels.ref.assign_top2`.
At the predict chunk (d = 19, K = 27, about 11 FLOP per byte) the kernel is
bound by memory and launch latency, at the k-means|| weighting pass (2,001
candidates) by f32 operations; it reads x once and never writes the
``[n, K]`` distance matrix. It launches with an explicit plan
(:func:`repro_torch.roofline.analysis.assign_update_blocking`: rows a
thread, candidates per resident chunk, a cap on the grid), which the C side
checks and refuses with :class:`PlanError` if it does not fit.
``assign_top2_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import analysis

__all__ = ["DTYPE_CODES", "PlanError", "assign_top2_cuda", "check_operand", "check_rc",
           "kernel_scan_plan", "launch_top2", "scan_args", "stream_of"]

#: element types the kernels load; they always compute in f32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: what the kernels return for a plan that does not fit (cudaErrorInvalidValue)
_INVALID = 1


class PlanError(ValueError):
    """A kernel refused its launch plan: it does not fit the shape or the
    card. Nothing was launched."""


def check_rc(rc: int, what: str) -> None:
    """Raise for a kernel's nonzero ``cudaError_t``: :class:`PlanError` for
    a refused plan, else ``RuntimeError``."""
    if rc == _INVALID:
        raise PlanError(f"{what}: the kernel refused its plan (cudaErrorInvalidValue)")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc}")


def scan_args(plan: dict, *, n: int | None = None, d: int | None = None) -> list[int]:
    """The scan's plan integers ``(rows a thread, kc, CTA cap)``. Given the
    shape (B3, B5), the rows a thread must be the kernel's own at ``n``:
    there a row tile sets which rows skip together (B3) or one cost partial
    (B5), so they are not a knob."""
    rpt = int(plan["rows_per_thread"])
    if n is not None and rpt != analysis.default_rows_per_thread(n, d):
        raise PlanError(f"rows a thread {rpt} differ from the kernel's own at n = {n}, "
                        f"d = {d}, which fix this kernel's bits")
    return [rpt, int(plan.get("bk", plan.get("bl", 0))), int(plan["ctas"])]


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
    f = _build.library("distance_assign").bwkm_assign_top2_ex
    f.argtypes = [_P, _I, _P, _I, _L, _I, _I, _P, _P, _P, _I, _I, _I, _P]
    f.restype = ctypes.c_int
    return f


def kernel_scan_plan(
    n: int, d: int, k: int, *, dtype_bytes: int = 4, rows_per_thread: int = 0, kc: int = 0
) -> dict:
    """What the scan of B1–B3 and B5 launches with for this plan, as the C
    side (``bwkm_scan_plan``) fills it, under the keys of
    ``analysis.scan_plan``; raises :class:`PlanError` for a plan it refuses.
    Host code: it needs the built library, not a card."""
    f = _build.library("distance_assign").bwkm_scan_plan
    f.argtypes = [_L, _I, _I, _I, _I, _I, _P]
    f.restype = ctypes.c_int
    out = (ctypes.c_longlong * 8)()
    check_rc(f(n, d, k, dtype_bytes, rows_per_thread, kc, ctypes.addressof(out)), "scan plan")
    keys = ("wide", "rows_per_thread", "bn", "bk", "xbytes", "smem_bytes", "scan_dx", "tiles")
    plan = dict(zip(keys, out))
    plan["wide"] = bool(plan["wide"])
    return plan


def assign_top2_cuda(
    x: torch.Tensor, c: torch.Tensor, *, plan: dict | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(assign i32[n], d1 f32[n], d2 f32[n])`` of ``x [n,d]`` against
    ``c [K,d]``, both CUDA tensors of f32 or bf16, launched with ``plan``
    (``None``: the analytic plan of ``analysis.assign_update_blocking`` at
    this shape). Every plan gives the same bits."""
    out = launch_top2(x, c, plan)
    assign_top2_cuda.launches += 1
    return out


def launch_top2(x: torch.Tensor, c: torch.Tensor, plan: dict | None):
    """:func:`assign_top2_cuda` without the launch count: the autotune's
    timing runs, which are not launches of the caller's path."""
    if x.device.type != "cuda":
        raise ValueError(f"assign_top2_cuda takes CUDA tensors, got {x.device}")
    check_operand("x", x, x.device, DTYPE_CODES, 2)
    check_operand("c", c, x.device, DTYPE_CODES, 2)
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d or k < 1:
        raise ValueError(f"shapes x {tuple(x.shape)} and c {tuple(c.shape)} do not match")
    if plan is None:
        plan = analysis.assign_update_blocking(d, k, n=n, dtype_bytes=x.element_size())
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    d1 = torch.empty(n, dtype=torch.float32, device=x.device)
    d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    fn = _fn()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], c.data_ptr(), DTYPE_CODES[c.dtype],
            n, d, k, assign.data_ptr(), d1.data_ptr(), d2.data_ptr(), *scan_args(plan),
            stream_of(x.device),
        )
    check_rc(rc, "assign_top2")
    return assign, d1, d2


assign_top2_cuda.launches = 0
