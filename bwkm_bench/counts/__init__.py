"""The benchmark's own counts of what each kernel has to do, and the card's
published peaks, for the ``<kernel>_roofline`` metrics.

Operations and bytes are those the call's inputs need, over its valid
candidates only (no parked slots): every input byte read once, every output
byte written once, whatever the kernel reads again. A kernel's least time is
the larger of operations over the peak rate and bytes over the peak
bandwidth (:func:`bound_s`). The peaks are NVIDIA's data sheet for the H100
SXM at its 700 W limit (``peaks.json``): 989 TFLOP/s is the card's highest
dense floating-point rate (bf16/fp16 on the tensor cores), so no float32
kernel, on CUDA cores or tensor cores, can read above 100 %.
"""

from __future__ import annotations

import json
import pathlib

__all__ = ["PEAKS", "b1", "b2", "b3", "b4", "b5", "bound_s"]

PEAKS = json.loads((pathlib.Path(__file__).parent / "peaks.json").read_text())

_I32 = _F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` and ``nbytes``."""
    return max(flops / PEAKS["flops_per_s"], nbytes / PEAKS["bytes_per_s"])


def b1(n: int, k: int, d: int, xsize: int = 4, csize: int = 4) -> tuple[float, float]:
    """B1, top-2 assignment of ``x [n, d]`` against ``k`` centres:
    2·n·k·d operations; x and c in, assign, d1, d2 out."""
    return 2.0 * n * k * d, n * d * xsize + k * d * csize + n * (_I32 + 2 * _F32)


def b2(n: int, k: int, d: int, xsize: int = 4, csize: int = 4) -> tuple[float, float]:
    """B2, B1 plus the weighted per-cluster sums: 2·n·k·d + 2·n·d + n
    operations; x, w, c in, assign, d1, d2, sums, counts, err out."""
    flops = 2.0 * n * k * d + 2.0 * n * d + n
    nbytes = (n * d * xsize + n * _F32 + k * d * csize + n * (_I32 + 2 * _F32)
              + k * (d + 1) * _F32 + _F32)
    return flops, nbytes


def b3(n: int, k: int, d: int, active: int, xsize: int = 4, csize: int = 4) -> tuple[float, float]:
    """B3, B2 over the ``active`` rows only for the distances; every row's
    cached id and mask are read and its statistics folded."""
    flops = 2.0 * active * k * d + 2.0 * n * d + n
    nbytes = (n * d * xsize + n * _F32 + k * d * csize + n * (_I32 + 1) + n * (_I32 + 2 * _F32)
              + k * (d + 1) * _F32 + _F32)
    return flops, nbytes


def b4(n: int, k: int, d: int, xsize: int = 4) -> tuple[float, float]:
    """B4, weighted per-cluster sums and counts under given labels:
    2·n·d + n operations; x, w, assign in, sums and counts out."""
    return 2.0 * n * d + n, n * d * xsize + n * (_F32 + _I32) + k * (d + 1) * _F32


def b5(n: int, valid: int, d: int, xsize: int = 4, csize: int = 4) -> tuple[float, float]:
    """B5, the k-means|| fold over ``valid`` candidates: 2·n·valid·d + 2·n
    operations; x, w, the running min-d² and the valid candidates in, the
    new min-d² and the cost out."""
    flops = 2.0 * n * valid * d + 2.0 * n
    nbytes = n * d * xsize + n * _F32 + valid * d * csize + 2 * n * _F32 + _F32
    return flops, nbytes
