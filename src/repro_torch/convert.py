"""Carry state across from the reference package, as numpy.

A ``Partition`` of ``repro`` (its seven arrays, through ``np.asarray``)
becomes a ``repro_torch`` :class:`~repro_torch.core.partition.Partition` on a
device and back, with the same dtypes. A fitted ``repro.BWKM``'s
``centroids_`` load into :meth:`repro_torch.BWKM.from_centroids`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.partition import Partition

__all__ = ["PARTITION_FIELDS", "partition_from_numpy", "partition_to_numpy"]

#: field -> (numpy dtype, torch dtype)
PARTITION_FIELDS = {
    "lo": (np.float32, torch.float32),
    "hi": (np.float32, torch.float32),
    "psum": (np.float32, torch.float32),
    "count": (np.float32, torch.float32),
    "active": (np.bool_, torch.bool),
    "block_id": (np.int32, torch.int32),
    "n_blocks": (np.int32, torch.int32),
}


def partition_from_numpy(part: Any, *, device: str | torch.device = "cuda") -> Partition:
    """``part``: a mapping or an object with the seven ``Partition`` fields."""
    get = part.__getitem__ if isinstance(part, dict) else lambda f: getattr(part, f)
    return Partition(**{
        f: torch.as_tensor(np.array(get(f), npt), dtype=tt, device=device)
        for f, (npt, tt) in PARTITION_FIELDS.items()
    })


def partition_to_numpy(part: Partition) -> dict[str, np.ndarray]:
    return {
        f: getattr(part, f).detach().cpu().numpy().astype(npt, copy=False)
        for f, (npt, _) in PARTITION_FIELDS.items()
    }
