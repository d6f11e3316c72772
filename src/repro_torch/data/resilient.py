"""ResilientChunkSource — fault-tolerant chunk delivery.

Counterpart of ``repro.data.resilient``. Wraps any
:class:`~repro_torch.data.chunks.ChunkSource` with the retry/skip/
quarantine policy the streaming engine runs on unreliable storage:

  * **Retry** — transient fetch failures (``OSError``/``ChunkReadError`` by
    default) are retried under seeded-jitter exponential backoff. The jitter
    is a pure function of ``(policy.seed, chunk index, attempt)``, so a rerun
    with the same seed and the same injected fault schedule sleeps the same
    delays and produces the same stream — bit-identical fits.
  * **Deadline** — a fetch that takes longer than ``deadline_s`` (stragglers)
    is discarded and counted, then retried like a failure.
  * **Skip-and-reweight** — when attempts are exhausted and
    ``on_exhausted="skip"``, the chunk is *terminally lost*: this pass and
    every later pass yield an empty ``[0, d]`` chunk at its position (keeping
    per-chunk host state aligned across the streaming driver's passes), and
    the lost mass is recorded in :class:`~repro_torch.health.RunHealth`
    instead of aborting the fit. The BWKM weighted-set formulation makes continuing on
    the surviving mass principled — block representatives are mass-weighted
    means, so missing mass shrinks weights rather than biasing positions
    (Big-means shows sample-based fits preserve K-means quality).
  * **Quarantine** — rows containing non-finite values are dropped *before*
    they can poison centroid sums, with a counter, instead of propagating
    NaNs through every downstream reduction. Quarantine is a deterministic
    function of the data, so repeated passes drop the same rows.

``n_points``/``n_chunks`` report the wrapped source's geometry (the
*intended* stream); the realised mass after losses is what the health
record accounts for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np

from repro_torch.data import chunks as ck
from repro_torch.health import RunHealth

__all__ = ["ChunkLostError", "ResilientChunkSource", "RetryPolicy"]


class ChunkLostError(ck.ChunkReadError):
    """All retry attempts for a chunk failed and the policy forbids skipping."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Seeded-jitter exponential backoff with a per-chunk deadline.

    The delay before retry ``a`` (0-based) of chunk ``i`` is
    ``min(max_delay_s, base_delay_s·2^a) · u`` with
    ``u ~ Uniform[1−jitter, 1]`` drawn from ``RandomState`` seeded by
    ``(seed, i, a)`` — deterministic per (policy, chunk, attempt), decorrelated
    across chunks so a fleet of readers hammering recovering storage doesn't
    retry in lockstep.
    """

    max_attempts: int = 4  # total fetch attempts per chunk (first + retries)
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5  # fraction of the backoff randomised away
    seed: int = 0
    deadline_s: float | None = None  # per-fetch wall-clock budget
    retryable: tuple = (OSError,)  # ChunkReadError is an OSError

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay_s(self, chunk_index: int, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based) of chunk ``chunk_index``."""
        base = min(self.max_delay_s, self.base_delay_s * (2.0**attempt))
        rng = np.random.RandomState(
            (1_000_003 * (self.seed + 1) + 7919 * chunk_index + attempt) % (2**32)
        )
        u = 1.0 - self.jitter * rng.random_sample()
        return float(base * u)


class ResilientChunkSource:
    """Retry/skip/quarantine wrapper around any chunk source.

    Parameters
    ----------
    inner:
        the source to protect. Random access (``chunk_at``) is used when the
        backend provides it (all built-ins do); protocol-only sources fall
        back to the generic O(index) scan in :func:`repro_torch.data.chunks.chunk_at`.
    policy:
        the :class:`RetryPolicy`.
    on_exhausted:
        ``"raise"`` (default) propagates a :class:`ChunkLostError` once
        attempts run out; ``"skip"`` enters skip-and-reweight mode.
    quarantine:
        drop non-finite rows with a counter (default on).
    health:
        an existing :class:`RunHealth` to accumulate into; a fresh one is
        created otherwise.
    sleep / clock:
        injectable for deterministic tests (``repro_torch.testing.faults.FakeClock``).
    """

    def __init__(
        self,
        inner: ck.ChunkSource,
        *,
        policy: RetryPolicy | None = None,
        on_exhausted: str = "raise",
        quarantine: bool = True,
        health: RunHealth | None = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        if on_exhausted not in ("raise", "skip"):
            raise ValueError(
                f"on_exhausted must be 'raise' or 'skip', got {on_exhausted!r}"
            )
        self._inner = inner
        self.policy = policy or RetryPolicy()
        self.on_exhausted = on_exhausted
        self.quarantine = quarantine
        self.health = health if health is not None else RunHealth()
        self._sleep = sleep
        self._clock = clock
        self._lost: set[int] = set()  # terminally lost chunk indices (sticky)

    # -- geometry: the intended stream ---------------------------------------
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

    @property
    def lost_chunk_indices(self) -> frozenset[int]:
        return frozenset(self._lost)

    # -- the guarded fetch ----------------------------------------------------
    def _rows_at(self, index: int) -> int:
        return min(self.chunk_size, self.n_points - index * self.chunk_size)

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.dim), np.float32)

    def _fetch(self, index: int) -> np.ndarray:
        """One chunk through the full policy: retries, deadline, terminal
        skip. Lost chunks short-circuit to empty on every later access."""
        if index in self._lost:
            return self._empty()
        pol = self.policy
        last_exc: BaseException | None = None
        for attempt in range(pol.max_attempts):
            if attempt > 0:
                self.health.retries += 1
                self._sleep(pol.delay_s(index, attempt - 1))
            t0 = self._clock()
            try:
                chunk = ck.chunk_at(self._inner, index)
            except pol.retryable as e:  # noqa: PERF203 - the retry loop IS the point
                last_exc = e
                continue
            if pol.deadline_s is not None and self._clock() - t0 > pol.deadline_s:
                self.health.deadline_hits += 1
                last_exc = ck.ChunkReadError(
                    f"chunk {index} fetch exceeded deadline "
                    f"({self._clock() - t0:.3f}s > {pol.deadline_s}s)",
                    chunk_index=index,
                )
                continue
            return self._sanitize(chunk)
        # attempts exhausted
        if self.on_exhausted == "skip":
            self._lost.add(index)
            self.health.lost_chunks += 1
            self.health.lost_points += self._rows_at(index)
            self.health.lost_mass_frac = max(
                self.health.lost_mass_frac,
                self.health.lost_points / max(self.n_points, 1),
            )
            return self._empty()
        raise ChunkLostError(
            f"chunk {index} lost after {pol.max_attempts} attempts: {last_exc}",
            chunk_index=index,
        ) from last_exc

    def _sanitize(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.asarray(chunk, np.float32)
        if not self.quarantine:
            return chunk
        finite = np.isfinite(chunk).all(axis=1)
        if finite.all():
            return chunk
        self.health.quarantined_rows += int((~finite).sum())
        return chunk[finite]

    # -- ChunkSource protocol -------------------------------------------------
    def chunks(self) -> Iterator[np.ndarray]:
        for i in range(self.n_chunks):
            yield self._fetch(i)

    def chunk_at(self, index: int) -> np.ndarray:
        if not 0 <= index < self.n_chunks:
            raise IndexError(
                f"chunk index {index} out of range [0, {self.n_chunks})"
            )
        return self._fetch(index)
