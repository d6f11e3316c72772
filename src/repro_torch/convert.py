"""Carry state across from the reference package, as numpy.

A ``Partition`` of ``repro`` (its seven arrays, through ``np.asarray``)
becomes a ``repro_torch`` :class:`~repro_torch.core.partition.Partition` on a
device and back, with the same dtypes. A fitted ``repro.BWKM``'s
``centroids_`` load into :meth:`repro_torch.BWKM.from_centroids`. A model's
parameter tree (nested dicts of arrays, through ``np.asarray``) becomes the
port's tree of tensors on a device and back, with the same keys, shapes and
dtypes (:func:`params_from_numpy`, :func:`params_to_numpy`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.partition import Partition

__all__ = [
    "PARTITION_FIELDS",
    "params_from_numpy",
    "params_to_numpy",
    "partition_from_numpy",
    "partition_to_numpy",
]

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


def _leaf_to_tensor(leaf: Any, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree: Any, *, device: str | torch.device = "cuda") -> Any:
    """A nested dict of arrays (a reference parameter tree) as tensors on
    ``device``, with the same keys, shapes and dtypes."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    return _leaf_to_tensor(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """The port's parameter tree as numpy arrays on the host, with the same
    keys, shapes and dtypes (bf16 as ``ml_dtypes.bfloat16``)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
