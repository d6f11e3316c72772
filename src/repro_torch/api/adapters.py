"""Turn what a caller holds into what an engine takes. Counterpart of
``repro.api.adapters``.

* a tensor, an array or nested lists of numbers — points in memory;
* ``"points.npy"`` — a memory-mapped file;
* ``"shards/part-*.npy"``, a directory of shards or a list of shard paths;
* any :class:`~repro_torch.data.chunks.ChunkSource`.

:func:`to_chunk_source` feeds the streaming engine and out-of-core
``predict`` / ``score`` / ``transform``; :func:`to_array` loads the data
whole for the in-core engine.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.data.chunks import ChunkSource, as_chunk_source, is_path_list, resolve_paths

__all__ = ["is_out_of_core", "resolve_paths", "to_array", "to_chunk_source"]


def is_out_of_core(data: Any) -> bool:
    """True when ``data`` names storage rather than holding points in
    memory: a path, a glob, a directory, a shard list or a chunk source."""
    return isinstance(data, (ChunkSource, str, os.PathLike)) or is_path_list(data)


def to_chunk_source(data: Any, chunk_size: int) -> ChunkSource:
    """Any accepted input as a :class:`ChunkSource`; data in memory becomes
    an ``ArrayChunkSource`` over a host view of it."""
    if isinstance(data, torch.Tensor):
        data = data.detach().to("cpu", torch.float32).numpy()
    elif not is_out_of_core(data):
        data = np.asarray(data, np.float32)
    return as_chunk_source(data, chunk_size)


def to_array(data: Any, device) -> torch.Tensor:
    """Any accepted input as a resident ``float32 [n, d]`` tensor on
    ``device``; out-of-core inputs are loaded whole."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.float32)
    if is_out_of_core(data):
        data = np.concatenate(list(to_chunk_source(data, 1 << 16).chunks()))
    # torch shares the array's memory, so a read-only array is copied
    return torch.from_numpy(np.require(np.asarray(data, np.float32), np.float32, ["C", "W"])).to(device)
