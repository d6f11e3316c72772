"""Streaming data plane and sessions: Algorithm 5 out of core, chunk by chunk.

Counterpart of ``repro.engine.streaming``. Points arrive as fixed-size
chunks from a :class:`~repro_torch.data.chunks.ChunkSource` (or a
:class:`~repro_torch.data.resilient.ResilientChunkSource`), padded to
``[chunk_size, d]`` by :func:`~repro_torch.data.chunks.padded_device_chunks`;
everything the algorithm needs about them is folded into per-block
statistics ``(Σx, |B|, min x, max x)``. The device holds a chunk or two, the
``[M, d]`` statistics and the candidates or centroids: O(chunk + M·d). The
full-length state lives on the host, one array per chunk: block memberships
(``int32``, 4 B/point), k-means||'s min-d² (``f32``, 4 B/point) and the
pruned Lloyd bounds (12 B/point). Each chunk's memberships come back to the
host as it is done, one wait per chunk, as in the reference.

Padding rows are inert everywhere: masked out of ``block_stats`` by
``valid``, weight 0 in kernels B2/B3/B5, never active in B3. Chunk
statistics combine in f32 in chunk order (minima and maxima exactly), so a
streamed fit is deterministic and pruned ≡ dense still holds bit for bit in
:class:`StreamingLloydSession`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import bwkm as core_bwkm
from repro_torch.core import init_partition, kmeanspp
from repro_torch.core import kmeans_ll as core_ll
from repro_torch.core import lloyd as lloyd_mod
from repro_torch.core import partition as part_mod
from repro_torch.core.partition import BlockStats, Partition, SplitPlan
from repro_torch.data.chunks import ChunkSource, padded_device_chunks, reservoir_sample
from repro_torch.engine.plane import global_extent
from repro_torch.health import RunHealth
from repro_torch.kernels import ops

__all__ = [
    "StreamBWKMResult",
    "StreamLLSession",
    "StreamStats",
    "StreamingLloydSession",
    "StreamingPlane",
    "default_init_sample_size",
    "streaming_initial_partition",
]

_BIG = 3.0e38


@dataclasses.dataclass
class StreamStats:
    """How much data moved to reach the result."""

    n_chunks: int
    chunk_size: int
    passes: int = 0  # passes over the whole dataset
    points_streamed: int = 0  # Σ chunk rows fed to the device


@dataclasses.dataclass
class StreamBWKMResult(core_bwkm.BWKMResult):
    stream: StreamStats | None = None


def _valid(cs: int, nv: int, device) -> torch.Tensor:
    return torch.arange(cs, device=device) < nv


def _padded(a: np.ndarray, cs: int, device) -> torch.Tensor:
    """A chunk's host state ``a [nv]`` on the device, zero-padded to ``cs``."""
    if a.shape[0] != cs:
        a = np.concatenate([a, np.zeros(cs - a.shape[0], a.dtype)])
    return torch.from_numpy(a).to(device)


# ------------------------------------------------------------ data passes
def _routing_pass(source: ChunkSource, part: Partition, stats: StreamStats, device):
    """Stream the dataset once: route every chunk into the current boxes,
    keep its memberships on the host, fold the tight block statistics."""
    m, d = part.capacity, source.dim
    # the live rows are the prefix [0, n_blocks): route against it, rounded
    # up to a multiple of 128, not against the whole capacity
    m_live = min(m, max(128, -(-int(part.n_blocks) // 128) * 128))
    lo, hi, active = part.lo[:m_live], part.hi[:m_live], part.active[:m_live]
    acc = part_mod.empty_block_stats(m, d, device)
    bids: list[np.ndarray] = []
    for x, nv in padded_device_chunks(source, device):
        bid = part_mod.route_into_boxes(x, lo, hi, active)
        st = part_mod.block_stats(x, bid, m, valid=_valid(x.shape[0], nv, device))
        acc = part_mod.combine_block_stats(acc, st)
        bids.append(bid[:nv].cpu().numpy())
        stats.points_streamed += nv
    stats.passes += 1
    return _with_stats(part, acc), bids


def _split_pass(
    source: ChunkSource,
    bids: list[np.ndarray],
    part: Partition,
    plan: SplitPlan,
    stats: StreamStats,
    device,
):
    """Stream the dataset once to carry out a split round: repair each
    chunk's memberships against ``plan`` and fold the block statistics."""
    m, d = part.capacity, source.dim
    acc = part_mod.empty_block_stats(m, d, device)
    new_bids: list[np.ndarray] = []
    for i, (x, nv) in enumerate(padded_device_chunks(source, device)):
        bid = part_mod.route_split(x, _padded(bids[i], x.shape[0], device), plan)
        st = part_mod.block_stats(x, bid, m, valid=_valid(x.shape[0], nv, device))
        acc = part_mod.combine_block_stats(acc, st)
        new_bids.append(bid[:nv].cpu().numpy())
        stats.points_streamed += nv
    stats.passes += 1
    return _with_stats(part_mod.apply_split_plan(part, plan), acc), new_bids


def _with_stats(part: Partition, st: BlockStats) -> Partition:
    # block_id stays empty: the memberships live on the host
    return part._replace(
        psum=st.psum, count=st.count, lo=st.lo, hi=st.hi,
        block_id=torch.zeros(0, dtype=torch.int32, device=st.psum.device),
    )


# ------------------------------------------------------------ initial sample
def default_init_sample_size(n: int, p: dict) -> int:
    """Rows of the first-pass sample: enough for every Algorithm 3/4
    subsample to be a genuine subsample."""
    return min(n, max(p["s"] * p["r"] * 4, 4 * p["m"]))


def streaming_initial_partition(
    key,
    source: ChunkSource,
    k: int,
    *,
    m: int,
    m_prime: int,
    s: int,
    r: int,
    capacity: int,
    sample_size: int,
    init: str = "kmeans++",
    device="cuda",
) -> Partition:
    """Algorithm 2 over a one-pass uniform sample of ``source``, drawn by the
    ``sample`` hook of the ``init`` strategy. The boxes describe the spatial
    partition; the statistics are the sample's, and the caller routes the
    whole stream through the boxes to replace them."""
    from repro_torch.api.inits import resolve_init

    key, k_seed = rnd.split(key)
    seed = int(rnd.randint(k_seed, (), 0, 2**31 - 1, device="cpu"))
    sample = resolve_init(init).sample(source, sample_size, seed)
    return init_partition.build_initial_partition(
        key, torch.from_numpy(sample).to(device), k,
        m=m, m_prime=m_prime, s=min(s, sample.shape[0]), r=r, capacity=capacity,
    )


# ------------------------------------------------------------------ plane
class StreamingPlane:
    """Chunked out-of-core plane (``engine="streaming"``) on ``device``."""

    name = "streaming"

    def __init__(self, source: ChunkSource, device="cuda"):
        self.source = source
        self.device = torch.device(device)
        self.stats = StreamStats(n_chunks=source.n_chunks, chunk_size=source.chunk_size)
        self.bids: list[np.ndarray] = []
        self.run_health = RunHealth()

    @property
    def n_points(self) -> int:
        return int(self.source.n_points)

    @property
    def dim(self) -> int:
        return int(self.source.dim)

    def split_key(self, key):
        key, k_init, k_pp = rnd.split(key, 3)
        return key, k_init, k_pp

    def build_partition(self, k_init, config, p) -> Partition:
        n = self.n_points
        part = streaming_initial_partition(
            k_init, self.source, config.k,
            m=p["m"], m_prime=p["m_prime"], s=p["s"], r=p["r"], capacity=p["capacity"],
            sample_size=config.init_sample_size or default_init_sample_size(n, p),
            init=config.init, device=self.device,
        )
        self.stats.passes += 1  # the sample's pass
        self.stats.points_streamed += n
        part, self.bids = _routing_pass(self.source, part, self.stats, self.device)
        return part

    def extent(self, part: Partition) -> float:
        return global_extent(part)

    def route_round(self, part: Partition, plan: SplitPlan, round_index: int) -> Partition:
        part, self.bids = _split_pass(self.source, self.bids, part, plan, self.stats, self.device)
        return part

    def on_iteration(self, it, c, part, distances) -> None:
        pass

    def trace_extra(self) -> dict:
        return {"passes": self.stats.passes}

    def make_result(self, **fields) -> StreamBWKMResult:
        # a ResilientChunkSource carries the fit's fault ledger; a bare
        # source is a clean run (any fault would have raised)
        health = getattr(self.source, "health", None)
        return StreamBWKMResult(
            stream=self.stats,
            health=health if isinstance(health, RunHealth) else RunHealth(),
            **fields,
        )


# ------------------------------------------------------- k-means|| session
def _pad_batch(cands: np.ndarray, cap: int, d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A ragged candidate batch in the fixed ``[cap, d]`` shape, unfilled
    rows parked at ``_FAR`` with validity 0."""
    batch = np.full((cap, d), core_ll._FAR, np.float32)
    valid = np.zeros((cap,), np.float32)
    m = min(len(cands), cap)
    if m:
        batch[:m] = cands[:m]
        valid[:m] = 1.0
    return torch.from_numpy(batch).to(device), torch.from_numpy(valid).to(device)


def _gather_rows(source: ChunkSource, wanted: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
    """``{chunk index: rows[idx]}`` from the source, by random access where
    the backend has it, else in one scan for all of them."""
    if not wanted:
        return {}
    if getattr(source, "chunk_at", None) is not None:
        return {i: np.asarray(source.chunk_at(i), np.float32)[idx] for i, idx in wanted.items()}
    out: dict[int, np.ndarray] = {}
    for i, chunk in enumerate(source.chunks()):
        if i in wanted:
            out[i] = np.asarray(chunk, np.float32)[wanted[i]]
    return out


class StreamLLSession:
    """Out-of-core k-means|| session.

    The min-d² state lives on the host, one f32 array per chunk. Each round
    first folds the previous round's candidates (one pass of kernel B5 over
    the data), which makes the accumulated cost the exact current
    normaliser φ; φ is summed in f64 in chunk order, on the device, and read
    once per pass. The accepted rows are gathered back by random access.
    Keys: the first seed under ``fold_in(key, 0)``, round ``rnd``'s uniforms
    under ``fold_in(fold_in(key, rnd + 1), i)`` for chunk ``i``, drawn on
    the host. ``rounds + 1`` passes in all: the weighting pass takes the
    last round's candidates without a fold of their own.
    """

    def __init__(self, key, source: ChunkSource, *, k, l, rounds, cap_round, device):  # noqa: E741
        self.key = key
        self.source = source
        self.k, self.l, self.rounds, self.cap_round = k, l, rounds, cap_round
        self.device = torch.device(device)
        self.d = source.dim
        self.cs = source.chunk_size
        self.mind2: list[np.ndarray] = []  # per-chunk host state
        self.phi = float("inf")
        self.distances = 0.0
        self.passes = 0
        key_seed, self.key_pp = rnd.split(rnd.fold_in(key, 0), 2)
        seed_int = int(rnd.randint(key_seed, (), 0, 2**31 - 1, device="cpu"))
        first = np.asarray(reservoir_sample(source, 1, seed_int), np.float32)
        self.cands: list[np.ndarray] = [first]
        self.pending: np.ndarray | None = first

    def _fold(self, batch_cands: np.ndarray, first_pass: bool) -> None:
        """One pass: fold ``batch_cands`` into every chunk's min-d²; ``phi``
        becomes the exact cost of all candidates so far."""
        dev = self.device
        batch, bvalid = _pad_batch(batch_cands, self.cap_round, self.d, dev)
        phi = torch.zeros((), dtype=torch.float64, device=dev)
        dist = torch.zeros((), dtype=torch.float64, device=dev)
        for i, (x, nv) in enumerate(padded_device_chunks(self.source, dev)):
            if first_pass:
                self.mind2.append(np.full((nv,), _BIG, np.float32))
            wv = _valid(self.cs, nv, dev).float()
            out = ops.min_sqdist_update_chunk(
                x, wv, batch, bvalid, _padded(self.mind2[i], self.cs, dev), chunk_size=self.cs
            )
            self.mind2[i] = out.mind2[:nv].cpu().numpy()
            phi += out.cost.double()
            dist += out.n_dist.double()
        self.phi = float(phi)
        self.distances += float(dist)
        self.passes += 1

    def seed(self) -> None:
        self._fold(self.pending, first_pass=True)
        self.pending = None

    def begin_round(self, rnd_index: int):
        if self.pending is not None and len(self.pending):
            self._fold(self.pending, first_pass=False)
        self.pending = None
        key_round = rnd.fold_in(self.key, rnd_index + 1)
        u = torch.cat([torch.zeros(0)] + [
            rnd.uniform(rnd.fold_in(key_round, i), (m_i.shape[0],), device="cpu")
            for i, m_i in enumerate(self.mind2)
        ])
        mind2 = torch.from_numpy(np.concatenate([np.zeros(0, np.float32)] + self.mind2))
        # φ as an f64 scalar: the Bernoulli draw divides in f32, as the
        # reference does with its Python float
        return u, torch.ones_like(mind2), mind2, torch.tensor(self.phi, dtype=torch.float64)

    def select(self, rnd_index: int, u, accept) -> None:
        accept = np.asarray(accept)
        u = np.asarray(u)
        wanted: dict[int, np.ndarray] = {}
        wanted_u: dict[int, np.ndarray] = {}
        off = 0
        for i, m_i in enumerate(self.mind2):
            nv = m_i.shape[0]
            idx = np.flatnonzero(accept[off : off + nv])
            if idx.size:
                wanted[i] = idx
                wanted_u[i] = u[off : off + nv][idx]
            off += nv
        rows = _gather_rows(self.source, wanted)
        if wanted:
            sel = np.concatenate([rows[i] for i in sorted(wanted)])
            sel_u = np.concatenate([wanted_u[i] for i in sorted(wanted)])
            if len(sel) > self.cap_round:  # rare: E[draws] <= ℓ
                sel = sel[np.argsort(sel_u)[: self.cap_round]]
            self.pending = sel
            self.cands.append(sel)
        else:
            self.pending = np.zeros((0, self.d), np.float32)

    def finish(self, normalisers: tuple) -> dict:
        # weighting pass: each candidate takes the rows closest to it; this
        # pass stands in for the last round's fold
        dev = self.device
        cand_all = torch.from_numpy(np.concatenate(self.cands)).to(dev)
        weights = torch.zeros(cand_all.shape[0], device=dev)
        dist = torch.zeros((), dtype=torch.float64, device=dev)
        for x, nv in padded_device_chunks(self.source, dev):
            wv = _valid(self.cs, nv, dev).float()
            au = ops.assign_update_chunk(x, wv, cand_all, chunk_size=self.cs)
            weights = weights + au.counts
            dist += au.n_dist.double()
        self.passes += 1
        self.distances += float(dist) + float(cand_all.shape[0]) * max(self.k - 1, 1)
        c = kmeanspp.weighted_kmeanspp(self.key_pp, cand_all, weights, self.k)
        return {
            "centroids": c,
            "n_candidates": int(cand_all.shape[0]),
            "distances": self.distances,
            "passes": self.passes,
            "normalisers": normalisers,
        }


# ------------------------------------------------ full-stream Lloyd session
class StreamingLloydSession:
    """Full-stream Lloyd with drift-bound pruning carried across chunk folds.

    The in-core pruned loop keeps (assignment, upper bound, lower bound) per
    row on the device; out of core the same state lives on the host, one
    i32/f32/f32 array per chunk (12 B/point), and goes to the device with
    its chunk each pass. The seed pass is kernel B2 per chunk; each step is
    B3 (pruned) or B2 (dense).
    """

    def __init__(self, source: ChunkSource, k: int, *, prune: bool, device):
        self.source = source
        self.k = k
        self.prune = prune
        self.device = torch.device(device)
        self.denom = max(k * source.n_points, 1)
        self.assigns: list[np.ndarray] = []
        self.ubs: list[np.ndarray] = []
        self.lbs: list[np.ndarray] = []

    def _keep(self, i: int, assign, ub, lb) -> None:
        state = (assign.cpu().numpy(), ub.cpu().numpy(), lb.cpu().numpy())
        if i == len(self.assigns):
            self.assigns.append(state[0])
            self.ubs.append(state[1])
            self.lbs.append(state[2])
        else:
            self.assigns[i], self.ubs[i], self.lbs[i] = state

    def seed(self, c: torch.Tensor):
        dev = self.device
        k, d = self.k, c.shape[1]
        sums = torch.zeros(k, d, device=dev)
        counts = torch.zeros(k, device=dev)
        err = torch.zeros((), device=dev)
        w2sum = torch.zeros((), device=dev)
        n_dist = torch.zeros((), dtype=torch.float64, device=dev)
        for i, (x, nv) in enumerate(padded_device_chunks(self.source, dev)):
            wv = _valid(x.shape[0], nv, dev).float()
            fu = ops.assign_update(x, wv, c)
            self._keep(i, fu.assign, lloyd_mod._sqrt0(fu.d1), lloyd_mod._sqrt0(fu.d2))
            sums, counts, err = sums + fu.sums, counts + fu.counts, err + fu.err
            w2sum = w2sum + (wv * (x * x).sum(-1)).sum()
            n_dist += fu.n_dist.double()
        return sums, counts, err, w2sum, float(n_dist)

    def step(self, c_new: torch.Tensor, drift: torch.Tensor):
        dev = self.device
        sums = torch.zeros(self.k, c_new.shape[1], device=dev)
        counts = torch.zeros(self.k, device=dev)
        n_dist = torch.zeros((), dtype=torch.float64, device=dev)
        for i, (x, nv) in enumerate(padded_device_chunks(self.source, dev)):
            valid = _valid(x.shape[0], nv, dev)
            wv = valid.float()
            assign = torch.from_numpy(self.assigns[i]).to(dev)
            if self.prune:
                ub = torch.from_numpy(self.ubs[i]).to(dev)
                lb = torch.from_numpy(self.lbs[i]).to(dev)
                ub, lb = lloyd_mod.drift_bound_update(ub, lb, assign, drift)
                active = (ub >= lb) & valid
                fu = ops.assign_update_pruned(x, wv, c_new, assign, active)
                ub = torch.where(active, lloyd_mod._sqrt0(fu.d1), ub)
                lb = torch.where(active, lloyd_mod._sqrt0(fu.d2), lb)
            else:
                fu = ops.assign_update(x, wv, c_new)
                ub, lb = lloyd_mod._sqrt0(fu.d1), lloyd_mod._sqrt0(fu.d2)
            self._keep(i, fu.assign, ub, lb)
            sums, counts = sums + fu.sums, counts + fu.counts
            n_dist += fu.n_dist.double()
        return sums, counts, float(n_dist)
