"""Deterministic fault injectors for chunk sources and shard rounds.

Counterpart of ``repro.testing.faults``. Each injector wraps a
:class:`~repro_torch.data.chunks.ChunkSource` and presents the same protocol
(including ``chunk_at`` random access, which the retry path in
``repro_torch.data.resilient`` relies on); :func:`shard_loss_rows_mask`
encodes the loss of a data shard's statistics for the sharded plane.
Fault schedules are **seeded and explicit** — a test that injects
``{2: 1, 5: 2}`` transient failures can assert that
``RunHealth.retries == 3`` exactly, and two runs with the same schedule see
byte-identical streams.

Failure-count semantics: schedules count *fetches of a chunk over the
injector's lifetime*, not per pass — chunk ``i`` with ``fails[i] = 2`` fails
its first two fetches ever (whichever pass they happen in) and succeeds
forever after. That makes expected counters independent of how many passes a
driver makes, which is what lets the determinism suite assert equality with
the injected schedule.
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping

import numpy as np

from repro_torch.data import chunks as ck

__all__ = [
    "CorruptChunkSource",
    "CrashingSource",
    "FakeClock",
    "FlakyIOSource",
    "InjectedCrash",
    "StragglerSource",
    "seeded_fault_schedule",
    "shard_loss_rows_mask",
]


def seeded_fault_schedule(
    n_chunks: int, *, rate: float, seed: int, fails: int = 1
) -> dict[int, int]:
    """Draw a deterministic ``{chunk_index: n_failures}`` schedule: each chunk
    independently faulty with probability ``rate``. Same seed → same dict."""
    rng = np.random.RandomState(seed)
    hit = rng.random_sample(n_chunks) < rate
    return {int(i): int(fails) for i in np.flatnonzero(hit)}


def shard_loss_rows_mask(n: int, n_shards: int, lost: "tuple[int, ...] | list[int]") -> np.ndarray:
    """Row-level alive mask (f32 0/1) for "shard s's stats are missing".

    Rows are sharded contiguously (``shard_points`` row order), so shard
    ``s`` of ``S`` owns rows ``[s·n/S, (s+1)·n/S)``. Zeroing a shard's rows
    in the stats fold is exactly losing that shard's ``BlockStats``
    contribution for the round.
    """
    if n % n_shards != 0:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    mask = np.ones(n, np.float32)
    per = n // n_shards
    for s in lost:
        if not 0 <= s < n_shards:
            raise ValueError(f"shard {s} out of range [0, {n_shards})")
        mask[s * per : (s + 1) * per] = 0.0
    return mask


class FakeClock:
    """Deterministic monotonic clock for straggler/deadline tests: ``sleep``
    advances time instead of waiting, so backoff and latency injection are
    instant and exactly reproducible."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self.sleeps: list[float] = []  # every sleep requested, in order

    def time(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self.now += float(seconds)


class _Wrapper:
    """Protocol passthrough base for the injectors."""

    def __init__(self, inner: ck.ChunkSource):
        self._inner = inner

    @property
    def n_points(self) -> int:
        return self._inner.n_points

    @property
    def dim(self) -> int:
        return self._inner.dim

    @property
    def chunk_size(self) -> int:
        return self._inner.chunk_size

    @property
    def n_chunks(self) -> int:
        return self._inner.n_chunks

    def _produce(self, index: int) -> np.ndarray:
        return ck.chunk_at(self._inner, index)

    def chunks(self) -> Iterator[np.ndarray]:
        for i, chunk in enumerate(self._inner.chunks()):
            yield self._emit(i, chunk)

    def chunk_at(self, index: int) -> np.ndarray:
        return self._emit(index, self._produce(index))

    def _emit(self, index: int, chunk: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class FlakyIOSource(_Wrapper):
    """Transient IO failures: fetch of chunk ``i`` raises ``exc`` while fewer
    than ``fails[i]`` fetches of it have been attempted, then succeeds.

    ``attempts`` records lifetime fetch counts per chunk — tests read it to
    verify the retry layer issued exactly the expected number of fetches.
    """

    def __init__(
        self,
        inner: ck.ChunkSource,
        fails: Mapping[int, int],
        *,
        exc: type[BaseException] = IOError,
    ):
        super().__init__(inner)
        self.fails = dict(fails)
        self.exc = exc
        self.attempts: dict[int, int] = {}

    @classmethod
    def seeded(
        cls, inner: ck.ChunkSource, *, rate: float, seed: int, fails: int = 1
    ) -> "FlakyIOSource":
        return cls(inner, seeded_fault_schedule(inner.n_chunks, rate=rate,
                                                seed=seed, fails=fails))

    def _emit(self, index: int, chunk: np.ndarray) -> np.ndarray:
        seen = self.attempts.get(index, 0)
        self.attempts[index] = seen + 1
        if seen < self.fails.get(index, 0):
            raise self.exc(f"injected transient IO failure on chunk {index} "
                           f"(attempt {seen + 1}/{self.fails[index]})")
        return chunk


class CorruptChunkSource(_Wrapper):
    """Data corruption: chunk ``i`` arrives with ``corrupt[i]`` rows replaced
    by ``value`` (NaN by default) at seeded, stable positions — the same rows
    are poisoned on every pass, like real on-disk corruption."""

    def __init__(
        self,
        inner: ck.ChunkSource,
        corrupt: Mapping[int, int],
        *,
        value: float = np.nan,
        seed: int = 0,
    ):
        super().__init__(inner)
        self.corrupt = dict(corrupt)
        self.value = value
        self.seed = seed

    def corrupted_rows(self, index: int, n_rows: int) -> np.ndarray:
        k = min(self.corrupt.get(index, 0), n_rows)
        if k == 0:
            return np.zeros((0,), np.int64)
        rng = np.random.RandomState((self.seed * 9973 + index) % (2**32))
        return rng.choice(n_rows, size=k, replace=False)

    def _emit(self, index: int, chunk: np.ndarray) -> np.ndarray:
        rows = self.corrupted_rows(index, chunk.shape[0])
        if rows.size == 0:
            return chunk
        out = np.array(chunk, np.float32, copy=True)
        out[rows] = self.value
        return out


class StragglerSource(_Wrapper):
    """Latency injection: fetching chunk ``i`` sleeps ``delays[i]`` seconds
    for its first ``times`` fetches (then recovers). Pair with
    :class:`FakeClock` — pass ``sleep=clock.sleep`` here and
    ``clock=clock.time`` to the resilient source — for deterministic
    deadline tests."""

    def __init__(
        self,
        inner: ck.ChunkSource,
        delays: Mapping[int, float],
        *,
        times: int = 1,
        sleep: Callable[[float], None] | None = None,
    ):
        import time

        super().__init__(inner)
        self.delays = dict(delays)
        self.times = int(times)
        self._sleep = sleep if sleep is not None else time.sleep
        self.attempts: dict[int, int] = {}

    def _emit(self, index: int, chunk: np.ndarray) -> np.ndarray:
        seen = self.attempts.get(index, 0)
        self.attempts[index] = seen + 1
        if index in self.delays and seen < self.times:
            self._sleep(self.delays[index])
        return chunk


class InjectedCrash(RuntimeError):
    """A mid-stream process death."""


class CrashingSource(_Wrapper):
    """Terminal crash: any access to chunk ``crash_at`` raises
    :class:`InjectedCrash` (the whole process dying, not a retryable
    fetch)."""

    def __init__(self, inner: ck.ChunkSource, crash_at: int):
        super().__init__(inner)
        self.crash_at = int(crash_at)

    def _emit(self, index: int, chunk: np.ndarray) -> np.ndarray:
        if index == self.crash_at:
            raise InjectedCrash(f"injected crash at chunk {index}")
        return chunk
