"""Out-of-core chunk sources for the streaming engine.

Counterpart of ``repro.data.chunks``, as the port's own numpy code. A
:class:`ChunkSource` presents a dataset as a deterministic, repeatable
sequence of fixed-size row chunks, the contract the streaming plane's
multi-pass loops are built on. Three backends:

* :class:`ArrayChunkSource` — an array already in host memory;
* :class:`MemmapChunkSource` — a memory-mapped ``.npy`` file, paged in by
  the OS on demand, so ``n·d`` never has to fit in RAM;
* :class:`ShardedFileSource` — ``.npy`` shards presented as one dataset,
  re-chunked to a fixed chunk size across shard boundaries.

:func:`padded_device_chunks` is the host-to-device feed. Every chunk is
padded to ``[chunk_size, d]`` and the next chunk's copy is enqueued before
the current one is handed out. On CUDA the copies leave from two pinned host
buffers used in turn; each buffer is refilled only after a CUDA event
recorded behind its last copy has completed, so no copy reads a buffer that
is being overwritten.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Iterator, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

__all__ = [
    "ArrayChunkSource",
    "ChunkReadError",
    "ChunkSource",
    "MemmapChunkSource",
    "ShardedFileSource",
    "as_chunk_source",
    "chunk_at",
    "chunks_from",
    "is_path_list",
    "padded_device_chunks",
    "reservoir_sample",
    "resolve_paths",
    "write_npy_shards",
]


class ChunkReadError(OSError):
    """A chunk could not be produced from backing storage: a shard vanished,
    was truncated or changed shape mid-iteration. Names the path and the
    logical chunk index."""

    def __init__(self, message: str, *, path: str | None = None, chunk_index: int | None = None):
        super().__init__(message)
        self.path = path
        self.chunk_index = chunk_index


@runtime_checkable
class ChunkSource(Protocol):
    """A repeatable stream of ``float32 [<= chunk_size, d]`` row chunks.

    Every chunk but possibly the last has exactly ``chunk_size`` rows, and
    repeated iterations yield identical chunks in identical order (the
    streaming plane keeps per-chunk state aligned by position).
    """

    @property
    def n_points(self) -> int: ...

    @property
    def dim(self) -> int: ...

    @property
    def chunk_size(self) -> int: ...

    @property
    def n_chunks(self) -> int: ...

    def chunks(self) -> Iterator[np.ndarray]: ...


def _check_chunk_size(chunk_size: int) -> int:
    chunk_size = int(chunk_size)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    return chunk_size


def _n_chunks(n: int, chunk_size: int) -> int:
    return max(1, -(-n // chunk_size))


class ArrayChunkSource:
    """Chunk view over a host-resident array (zero-copy row slices)."""

    def __init__(self, x: np.ndarray, chunk_size: int):
        self._x = np.asarray(x)
        if self._x.ndim != 2:
            raise ValueError(f"expected [n, d] array, got shape {self._x.shape}")
        self._chunk_size = _check_chunk_size(chunk_size)

    @property
    def n_points(self) -> int:
        return self._x.shape[0]

    @property
    def dim(self) -> int:
        return self._x.shape[1]

    @property
    def chunk_size(self) -> int:
        return self._chunk_size

    @property
    def n_chunks(self) -> int:
        return _n_chunks(self.n_points, self._chunk_size)

    def chunks(self) -> Iterator[np.ndarray]:
        for start in range(0, self.n_points, self._chunk_size):
            yield self._x[start : start + self._chunk_size]

    def chunk_at(self, index: int) -> np.ndarray:
        start = _chunk_start(self, index)
        return self._x[start : start + self._chunk_size]


class MemmapChunkSource(ArrayChunkSource):
    """Chunks from a memory-mapped ``.npy`` file; each chunk is read into a
    private buffer, so the working set is a chunk or two whatever ``n``."""

    def __init__(self, path: str | os.PathLike, chunk_size: int):
        super().__init__(np.load(path, mmap_mode="r"), chunk_size)
        self.path = os.fspath(path)

    def chunks(self) -> Iterator[np.ndarray]:
        for start in range(0, self.n_points, self._chunk_size):
            yield np.array(self._x[start : start + self._chunk_size])

    def chunk_at(self, index: int) -> np.ndarray:
        start = _chunk_start(self, index)
        return np.array(self._x[start : start + self._chunk_size])


class ShardedFileSource:
    """Several ``.npy`` shards presented as one logical ``[n, d]`` dataset.

    Shards may have ragged row counts; chunks are re-packed to the fixed
    ``chunk_size`` across shard boundaries. At most one shard is mapped at a
    time.
    """

    def __init__(self, paths: Sequence[str | os.PathLike], chunk_size: int):
        if not paths:
            raise ValueError("ShardedFileSource needs at least one shard")
        self.paths = [os.fspath(p) for p in paths]
        self._chunk_size = _check_chunk_size(chunk_size)
        rows, dims = [], []
        for p in self.paths:
            arr = np.load(p, mmap_mode="r")
            if arr.ndim != 2:
                raise ValueError(f"shard {p}: expected [n, d], got {arr.shape}")
            rows.append(arr.shape[0])
            dims.append(arr.shape[1])
        if len(set(dims)) != 1:
            raise ValueError(f"shards disagree on d: {dict(zip(self.paths, dims))}")
        self._rows = rows
        self._dim = dims[0]

    @property
    def n_points(self) -> int:
        return int(sum(self._rows))

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def chunk_size(self) -> int:
        return self._chunk_size

    @property
    def n_chunks(self) -> int:
        return _n_chunks(self.n_points, self._chunk_size)

    def _load_shard(self, shard_i: int, chunk_index: int) -> np.ndarray:
        """Map shard ``shard_i`` again and check it against the geometry the
        constructor recorded; a shard deleted, truncated or rewritten
        mid-iteration raises :class:`ChunkReadError`."""
        p = self.paths[shard_i]
        expected = (self._rows[shard_i], self._dim)
        try:
            arr = np.load(p, mmap_mode="r")
        except (OSError, ValueError) as e:
            raise ChunkReadError(
                f"shard {p!r} unreadable while producing chunk {chunk_index} "
                f"(deleted or truncated mid-iteration?): {e}",
                path=p, chunk_index=chunk_index,
            ) from e
        if arr.ndim != 2 or arr.shape != expected:
            raise ChunkReadError(
                f"shard {p!r} changed shape while producing chunk "
                f"{chunk_index}: expected {expected}, found {arr.shape}",
                path=p, chunk_index=chunk_index,
            )
        return arr

    def chunks(self) -> Iterator[np.ndarray]:
        cs = self._chunk_size
        pending: list[np.ndarray] = []
        pending_rows = 0
        emitted = 0
        for shard_i in range(len(self.paths)):
            arr = self._load_shard(shard_i, emitted)
            start = 0
            while start < arr.shape[0]:
                take = min(cs - pending_rows, arr.shape[0] - start)
                pending.append(np.array(arr[start : start + take]))
                pending_rows += take
                start += take
                if pending_rows == cs:
                    yield pending[0] if len(pending) == 1 else np.concatenate(pending)
                    pending, pending_rows = [], 0
                    emitted += 1
        if pending_rows:
            yield pending[0] if len(pending) == 1 else np.concatenate(pending)

    def chunk_at(self, index: int) -> np.ndarray:
        start = _chunk_start(self, index)
        stop = min(start + self._chunk_size, self.n_points)
        offsets = np.concatenate([[0], np.cumsum(self._rows)])
        parts: list[np.ndarray] = []
        for shard_i, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
            if hi <= start or lo >= stop:
                continue
            arr = self._load_shard(shard_i, index)
            parts.append(np.array(arr[max(start - lo, 0) : stop - lo]))
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _chunk_start(source: ChunkSource, index: int) -> int:
    index = int(index)
    if not 0 <= index < source.n_chunks:
        raise IndexError(f"chunk index {index} out of range [0, {source.n_chunks})")
    return index * source.chunk_size


def chunk_at(source: ChunkSource, index: int) -> np.ndarray:
    """Chunk ``index`` of any source: the backend's ``chunk_at`` where it has
    one, else a scan through ``chunks()`` (O(index) chunks of I/O)."""
    fn = getattr(source, "chunk_at", None)
    if fn is not None:
        return fn(index)
    _chunk_start(source, index)  # validate the range before paying for the scan
    for i, chunk in enumerate(source.chunks()):
        if i == index:
            return np.asarray(chunk)
    raise IndexError(f"source exhausted before chunk {index}")


def chunks_from(source: ChunkSource, start: int) -> Iterator[np.ndarray]:
    """``chunks()`` from chunk index ``start`` on, by random access where the
    backend has it, else by skipping."""
    if start == 0:
        yield from source.chunks()
        return
    if not 0 <= start <= source.n_chunks:
        raise IndexError(f"start chunk {start} out of range [0, {source.n_chunks}]")
    if getattr(source, "chunk_at", None) is not None:
        for i in range(start, source.n_chunks):
            yield chunk_at(source, i)
        return
    for i, chunk in enumerate(source.chunks()):
        if i >= start:
            yield chunk


_GLOB_CHARS = ("*", "?", "[")


def is_path_list(x) -> bool:
    """True for a non-empty list or tuple made entirely of path-likes (a
    shard list, as opposed to nested numeric data)."""
    return (
        isinstance(x, (list, tuple))
        and bool(x)
        and all(isinstance(p, (str, os.PathLike)) for p in x)
    )


def resolve_paths(path: str | os.PathLike) -> list[str] | str:
    """A glob pattern or a directory becomes its sorted shard list, a plain
    file stays a single path. An existing path always wins over its reading
    as a glob pattern (``data[1].npy`` resolves to itself)."""
    s = os.fspath(path)
    if os.path.isdir(s):
        paths = sorted(_glob.glob(os.path.join(s, "*.npy")))
        if not paths:
            raise FileNotFoundError(f"directory {s!r} contains no .npy shards")
        return paths
    if os.path.exists(s):
        return s
    if any(ch in s for ch in _GLOB_CHARS):
        paths = sorted(_glob.glob(s))
        if paths:
            return paths
        raise FileNotFoundError(f"glob {s!r} matched no files")
    return s


def as_chunk_source(x, chunk_size: int) -> ChunkSource:
    """An array, path, glob, directory, list of paths or existing source, as
    a source."""
    if isinstance(x, ChunkSource):
        return x
    if isinstance(x, (str, os.PathLike)):
        resolved = resolve_paths(x)
        if isinstance(resolved, list):
            return ShardedFileSource(resolved, chunk_size)
        return MemmapChunkSource(resolved, chunk_size)
    if is_path_list(x):
        return ShardedFileSource(x, chunk_size)
    return ArrayChunkSource(np.asarray(x), chunk_size)


def padded_device_chunks(source: ChunkSource, device: str | torch.device):
    """Yield ``(x [chunk_size, d] f32 on device, n_valid)`` with one chunk of
    lookahead: chunk ``i + 1``'s copy is enqueued before chunk ``i`` is
    handed out. Rows past ``n_valid`` are zero; callers mask them.

    On CUDA each chunk goes through one of two pinned host buffers, used in
    turn, with ``non_blocking`` copies on the current stream; before a
    buffer is refilled, the event recorded after its previous copy is
    waited on, so a copy never reads a buffer that is being overwritten.
    Filling the next buffer on the host overlaps the device's work on the
    current chunk.
    """
    device = torch.device(device)
    cs, d = source.chunk_size, source.dim
    on_cuda = device.type == "cuda"
    if on_cuda:
        pinned = [torch.empty((cs, d), dtype=torch.float32, pin_memory=True) for _ in range(2)]
        copied: list[torch.cuda.Event | None] = [None, None]

    def put(i: int, chunk: np.ndarray) -> tuple[torch.Tensor, int]:
        n = chunk.shape[0]
        if n > cs or (n and chunk.shape[1] != d):
            raise ValueError(f"chunk {i} has shape {chunk.shape}, beyond [{cs}, {d}]")
        if not on_cuda:
            buf = np.zeros((cs, d), np.float32)
            buf[:n] = chunk
            return torch.from_numpy(buf).to(device), n
        b = i % 2
        if copied[b] is not None:
            copied[b].synchronize()  # its last copy has read the buffer
        host = pinned[b].numpy()
        host[:n] = chunk
        host[n:] = 0.0
        x_dev = torch.empty((cs, d), dtype=torch.float32, device=device)
        x_dev.copy_(pinned[b], non_blocking=True)
        copied[b] = torch.cuda.Event()
        copied[b].record()
        return x_dev, n

    prev = None
    for i, chunk in enumerate(source.chunks()):
        cur = put(i, chunk)
        if prev is not None:
            yield prev
        prev = cur
    if prev is not None:
        yield prev


def reservoir_sample(source: ChunkSource, size: int, seed: int) -> np.ndarray:
    """One-pass uniform sample of ``size`` rows (vectorised reservoir): after
    ``t`` rows each row is retained with probability ``size/t``. The draws
    are the reference's, from ``numpy.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    reservoir: np.ndarray | None = None
    filled = 0
    seen = 0
    for chunk in source.chunks():
        chunk = np.asarray(chunk, np.float32)
        if reservoir is None:
            reservoir = np.empty((size, chunk.shape[1]), np.float32)
        fill = min(size - filled, chunk.shape[0])
        if fill > 0:
            reservoir[filled : filled + fill] = chunk[:fill]
            filled += fill
        tail = chunk[fill:]
        if tail.shape[0]:
            t = seen + fill + np.arange(1, tail.shape[0] + 1)
            accept = rng.random_sample(tail.shape[0]) < (size / t)
            idx = np.flatnonzero(accept)
            if idx.size:
                slots = rng.randint(0, size, size=idx.size)
                reservoir[slots] = tail[idx]
        seen += chunk.shape[0]
    if reservoir is None:
        raise ValueError("empty chunk source")
    return reservoir[:filled] if filled < size else reservoir


def write_npy_shards(x: np.ndarray, directory: str | os.PathLike, *, rows_per_shard: int) -> list[str]:
    """Write ``x`` as ``.npy`` shards of ``rows_per_shard`` rows."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, start in enumerate(range(0, x.shape[0], rows_per_shard)):
        p = os.path.join(os.fspath(directory), f"shard_{i:05d}.npy")
        np.save(p, np.asarray(x[start : start + rows_per_shard], np.float32))
        paths.append(p)
    return paths
