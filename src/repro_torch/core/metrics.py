"""Error metrics (paper Section 3). Counterpart of ``repro.core.metrics``.

The paper's cost unit is the number of distance computations; its quality
unit is the relative error Ê_M (Eq. 6) against the best solution any
compared method found. :func:`kmeans_error` and ``BWKM.score`` share one
chunk loop, :func:`chunked_error`: one B1 launch a chunk on the card, the
chunks' sums of d1 added in float64 on the device.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F

from repro_torch.device import as_points
from repro_torch.kernels import ops

__all__ = ["kmeans_error", "relative_errors"]


def tensor_chunks(x: torch.Tensor, chunk_size: int) -> Iterable[tuple[torch.Tensor, int]]:
    """``(chunk, n_valid)`` over the rows of ``x`` where it lies, every chunk
    ``chunk_size`` rows, the tail zero-padded past ``n_valid``."""
    for i in range(0, x.shape[0], chunk_size):
        nv = min(chunk_size, x.shape[0] - i)
        yield (x[i : i + chunk_size] if nv == chunk_size
               else F.pad(x[i:], (0, 0, 0, chunk_size - nv))), nv


def chunked_error(chunks: Iterable[tuple[torch.Tensor, int]], c: torch.Tensor) -> torch.Tensor:
    """``Σ min_k ‖x − c_k‖²`` over the valid rows of ``(chunk, n_valid)``
    pairs, a float64 0-d tensor on ``c``'s device; no host sync."""
    err = torch.zeros((), dtype=torch.float64, device=c.device)
    for x, nv in chunks:
        _, d1, _ = ops.assign_top2_chunk(x, c, chunk_size=x.shape[0])
        err = err + d1[:nv].sum(dtype=torch.float64)
    return err


def kmeans_error(x, c, *, batch: int = 65536) -> torch.Tensor:
    """Full-dataset K-means error ``E^D(C)`` (Eq. 1) as a 0-d f32 tensor,
    streamed in ``batch``-row chunks so the ``[n, K]`` distance matrix never
    exists. ``x`` stays on its device if it is a tensor (else it goes to
    CUDA); ``c`` joins it."""
    x = as_points(x)
    c = as_points(torch.as_tensor(c, device=x.device))
    return chunked_error(tensor_chunks(x, batch), c).float()


def relative_errors(errors: dict[str, float]) -> dict[str, float]:
    """``Ê_M = (E_M − min E) / min E`` for every method M (Eq. 6)."""
    best = min(errors.values())
    return {m: (e - best) / best for m, e in errors.items()}
