"""The port's streaming engine held against the JAX reference on the CPU:
chunk sources, the statistics fold, the chunk seams, the streamed fit,
k-means|| and full-stream Lloyd, fault tolerance, engine selection and
out-of-core inference.

Inputs come from numpy seeds. ``JaxKey`` (``test_torch_bwkm``) makes the
port draw the reference's numbers, so a streamed fit follows the
reference's trajectory iteration for iteration.
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bwkm import JaxKey

import repro
import repro_torch
from repro import streaming as jstreaming
from repro.core import bwkm as jbwkm
from repro.core import partition as jpart
from repro.data import chunks as jck
from repro.health import RunHealth as JRunHealth
from repro.kernels import ops as jops
from repro_torch import random as rnd
from repro_torch import streaming
from repro_torch.api import engines
from repro_torch.core import bwkm
from repro_torch.core import partition as part_mod
from repro_torch.data import chunks as ck
from repro_torch.data.resilient import ChunkLostError, ResilientChunkSource, RetryPolicy
from repro_torch.health import RunHealth
from repro_torch.kernels import ops
from repro_torch.testing.faults import (
    CorruptChunkSource,
    CrashingSource,
    FakeClock,
    FlakyIOSource,
    InjectedCrash,
    StragglerSource,
    seeded_fault_schedule,
)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "bwkm_fitresult.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread: with several test workers on the
    cores, each worker's intra-op pool spinning on every core slowed this
    file several times over (the tolerances hold at any thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(seed=0, n=3000, d=4, k=5, spread=8.0, noise=1.5):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * spread
    return (centers[rng.randint(0, k, n)] + noise * rng.randn(n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ chunk sources
def test_chunk_sources_yield_the_reference_chunks(tmp_path):
    x = _points(n=2017, d=3)
    p = str(tmp_path / "x.npy")
    np.save(p, x)
    paths = ck.write_npy_shards(x, tmp_path / "shards", rows_per_shard=500)
    assert [os.path.basename(q) for q in paths] == [
        os.path.basename(q) for q in jck.write_npy_shards(x, tmp_path / "jshards", rows_per_shard=500)
    ]
    pairs = [
        (ck.ArrayChunkSource(x, 256), jck.ArrayChunkSource(x, 256)),
        (ck.MemmapChunkSource(p, 256), jck.MemmapChunkSource(p, 256)),
        (ck.ShardedFileSource(paths, 256), jck.ShardedFileSource(paths, 256)),
        (ck.as_chunk_source(str(tmp_path / "shards"), 256), jck.as_chunk_source(str(tmp_path / "shards"), 256)),
    ]
    for got, want in pairs:
        assert (got.n_points, got.dim, got.chunk_size, got.n_chunks) == (2017, 3, 256, 8)
        g, w = list(got.chunks()), list(want.chunks())
        assert [c.shape[0] for c in g] == [256] * 7 + [225] == [c.shape[0] for c in w]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ck.chunk_at(got, 7), jck.chunk_at(want, 7))
        np.testing.assert_array_equal(np.concatenate(list(ck.chunks_from(got, 5))), x[5 * 256 :])
    assert ck.resolve_paths(str(tmp_path / "shards" / "*.npy")) == paths
    assert ck.is_path_list(paths) and not ck.is_path_list(x[:3].tolist())


@pytest.mark.parametrize("size,seed", [(1, 3), (100, 0), (5000, 7)])
def test_reservoir_sample_is_bit_equal_to_the_reference(size, seed):
    x = _points(seed=1, n=3001, d=3)
    got = ck.reservoir_sample(ck.ArrayChunkSource(x, 700), size, seed)
    want = jck.reservoir_sample(jck.ArrayChunkSource(x, 700), size, seed)
    np.testing.assert_array_equal(got, want)


def test_padded_device_chunks_match_the_reference():
    x = _points(n=1000, d=5)
    got = list(ck.padded_device_chunks(ck.ArrayChunkSource(x, 384), "cpu"))
    want = list(jck.padded_device_chunks(jck.ArrayChunkSource(x, 384)))
    assert [nv for _, nv in got] == [nv for _, nv in want] == [384, 384, 232]
    for (a, _), (b, _) in zip(got, want):
        assert a.shape == (384, 5) and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ statistics fold
def _boxes(seed, m, d, n_live):
    rng = np.random.RandomState(seed)
    lo = rng.randn(m, d).astype(np.float32) * 4
    hi = lo + rng.rand(m, d).astype(np.float32) * 3
    active = np.arange(m) < n_live
    return lo, hi, active


@pytest.mark.parametrize("tile_rows", [None, 7])
def test_route_into_boxes_matches_the_reference(tile_rows):
    x = _points(seed=2, n=900, d=3) * 0.6
    lo, hi, active = _boxes(3, 40, 3, 31)
    lo[5] = hi[5] = x[17]  # a degenerate box holding one row exactly
    kw = {} if tile_rows is None else {"tile_bytes": 2 * 4 * 40 * 3 * tile_rows}
    got = part_mod.route_into_boxes(_t(x), _t(lo), _t(hi), _t(active), **kw)
    want = jpart.route_into_boxes(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(active))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < 31


def test_block_stats_with_a_mask_and_combine_match_the_reference():
    rng = np.random.RandomState(4)
    m = 12
    parts = []
    for i, n in enumerate((500, 500, 213)):
        x = rng.randn(n, 3).astype(np.float32) * 5
        bid = rng.randint(0, m, n).astype(np.int32)
        bid[: n // 4] = 2  # a heavy block
        valid = np.arange(n) < n - 40 * i  # the padding of a ragged tail
        got = part_mod.block_stats(_t(x), _t(bid), m, valid=_t(valid))
        want = jpart.block_stats(jnp.asarray(x), jnp.asarray(bid), m, valid=jnp.asarray(valid))
        np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
        np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))
        np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
        np.testing.assert_allclose(got.psum.numpy(), np.asarray(want.psum), rtol=1e-5, atol=1e-4)
        # the masked rows are as if they were not there, bit for bit
        alone = part_mod.block_stats(_t(x[valid]), _t(bid[valid]), m)
        assert all(torch.equal(a, b) for a, b in zip(got, alone))
        parts.append(got)
    acc, jacc = part_mod.empty_block_stats(m, 3, "cpu"), jpart.empty_block_stats(m, 3)
    for st in parts:
        acc = part_mod.combine_block_stats(acc, st)
        jacc = jpart.combine_block_stats(jacc, jpart.BlockStats(*(jnp.asarray(t.numpy()) for t in st)))
    for a, b in zip(acc, jacc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_chunk_seams_with_a_ragged_tail_match_the_reference():
    rng = np.random.RandomState(5)
    n, cs, k = 333, 512, 7
    x = rng.randn(n, 4).astype(np.float32) * 3
    w = rng.rand(n).astype(np.float32)
    c = rng.randn(k, 4).astype(np.float32) * 3
    got = ops.assign_update_chunk(_t(x), _t(w), _t(c), chunk_size=cs)
    want = jops.assign_update_chunk(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), chunk_size=cs, impl="ref")
    dense = ops.assign_update(_t(x), _t(w), _t(c))
    assert got.assign.shape == (n,) and got.d1.shape == (n,)
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    for f in ("d1", "d2", "sums", "counts", "err"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(dense, f).numpy(), rtol=1e-5, atol=1e-4)
    assert float(got.n_dist) == float(want.n_dist) == float(dense.n_dist)
    cached = rng.randint(0, k, n).astype(np.int32)
    active = rng.rand(n) < 0.3
    got = ops.assign_update_pruned_chunk(_t(x), _t(w), _t(c), _t(cached), _t(active), chunk_size=cs)
    want = jops.assign_update_pruned_chunk(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), jnp.asarray(cached), jnp.asarray(active),
        chunk_size=cs, impl="ref",
    )
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    for f in ("sums", "counts"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.d1.numpy()[active], np.asarray(want.d1)[active], rtol=1e-5, atol=1e-4)
    assert float(got.n_dist) == float(want.n_dist) == float(active.sum() * k)


# ------------------------------------------------------------ streamed fits
def test_fit_streaming_follows_the_reference():
    x = _points(seed=0)
    key = jax.random.PRNGKey(1)
    want = jstreaming.fit_streaming(key, jck.ArrayChunkSource(x, 700), jbwkm.BWKMConfig(k=5, max_iters=5))
    got = streaming.fit_streaming(
        JaxKey(key), ck.ArrayChunkSource(x, 700), bwkm.BWKMConfig(k=5, max_iters=5), device="cpu"
    )
    assert got.stop_reason == want.stop_reason
    assert got.iterations == want.iterations
    assert got.n_blocks == want.n_blocks
    assert got.boundary_sizes == want.boundary_sizes
    assert (got.stream.passes, got.stream.points_streamed) == (want.stream.passes, want.stream.points_streamed)
    assert got.stream.points_streamed == got.stream.passes * x.shape[0]
    np.testing.assert_allclose(got.weighted_errors, want.weighted_errors, rtol=1e-3)
    assert got.partition.block_id.numel() == 0
    assert not got.health.degraded


def test_kmeans_parallel_streaming_follows_the_reference():
    x = _points(seed=6)
    key = jax.random.PRNGKey(2)
    want = jstreaming.kmeans_parallel_streaming(key, jck.ArrayChunkSource(x, 700), 5)
    got = streaming.kmeans_parallel_streaming(JaxKey(key), ck.ArrayChunkSource(x, 700), 5, device="cpu")
    assert got.n_candidates == want.n_candidates
    assert got.passes == want.passes == 6
    assert got.distances == want.distances
    np.testing.assert_allclose(got.normalisers, want.normalisers, rtol=1e-5)
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), rtol=1e-5, atol=1e-5)


def test_streaming_lloyd_pruned_is_dense_and_follows_the_reference():
    x = _points(seed=7)
    c0 = x[:5].copy()
    src = ck.ArrayChunkSource(x, 700)
    pruned = streaming.streaming_lloyd(src, c0, max_iters=20, prune=True, device="cpu")
    dense = streaming.streaming_lloyd(src, c0, max_iters=20, prune=False, device="cpu")
    assert pruned.iters == dense.iters
    assert torch.equal(pruned.centroids, dense.centroids)
    assert pruned.distances < dense.distances
    want = jstreaming.streaming_lloyd(jck.ArrayChunkSource(x, 700), jnp.asarray(c0), max_iters=20, prune=True)
    assert pruned.iters == want.iters
    np.testing.assert_allclose(pruned.centroids.numpy(), np.asarray(want.centroids), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pruned.error, want.error, rtol=1e-4)
    assert pruned.distances == want.distances
    c1, err = streaming.streaming_lloyd_step(src, c0, device="cpu")
    jc1, jerr = jstreaming.streaming_lloyd_step(jck.ArrayChunkSource(x, 700), jnp.asarray(c0))
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(err, jerr, rtol=1e-5)
    assert streaming.streaming_error(src, c0, device="cpu") == err


def test_streaming_engine_reproduces_the_golden_record():
    from helpers import error_f64, gmm

    x = np.asarray(gmm(jax.random.PRNGKey(5), 2000, 3, 4, spread=8.0, noise=2.0))
    golden = json.loads(GOLDEN.read_text())["streaming"]
    model = repro_torch.BWKM(k=4, device="cpu", engine="streaming", max_iters=5, chunk_size=512)
    res = model.fit(x, key=JaxKey(jax.random.PRNGKey(0))).result_
    assert model.engine_ == "streaming" and res.engine == "streaming"
    assert res.stop_reason == golden["stop_reason"]
    assert res.iterations == golden["iterations"]
    np.testing.assert_allclose(res.distances, golden["distances"], rtol=0.05)
    np.testing.assert_allclose(error_f64(x, res.centroids.numpy()), golden["error"], rtol=1e-3)
    c = res.centroids.numpy().astype(np.float64)
    np.testing.assert_allclose(
        c[np.lexsort(c.T[::-1])], np.asarray(golden["centroids"]), rtol=5e-3, atol=5e-2
    )
    assert res.metadata["n_chunks"] == 4 and res.metadata["chunk_size"] == 512
    assert res.metadata["points_streamed"] == res.metadata["passes"] * 2000


# ------------------------------------------------------------ fault tolerance
N_F, CS_F = 4096, 512  # 8 chunks
CFG_F = bwkm.BWKMConfig(k=4, max_iters=6, lloyd_max_iters=20)


def _resilient(inner, **kw):
    clock = FakeClock()
    kw.setdefault("policy", RetryPolicy(max_attempts=4, base_delay_s=0.001))
    return ResilientChunkSource(inner, sleep=clock.sleep, clock=clock.time, **kw)


def _fit(source, seed):
    return streaming.fit_streaming(rnd.key(seed), source, CFG_F, device="cpu")


def test_streaming_fit_is_bit_identical_under_transient_faults():
    x = _points(seed=11, n=N_F, k=4, spread=6.0, noise=1.0)
    clean = _fit(ck.ArrayChunkSource(x, CS_F), 3)
    schedule = {0: 1, 3: 2, 6: 1}
    injected = _fit(_resilient(FlakyIOSource(ck.ArrayChunkSource(x, CS_F), schedule)), 3)
    assert torch.equal(clean.centroids, injected.centroids)
    assert injected.stop_reason == clean.stop_reason
    assert injected.health.retries == sum(schedule.values())
    assert injected.health.lost_chunks == 0
    assert not injected.health.degraded and not clean.health.degraded


def test_streaming_fit_reruns_the_same_under_the_same_fault_schedule():
    x = _points(seed=12, n=N_F, k=4, spread=6.0, noise=1.0)
    schedule = {1: 1, 5: 3}

    def run():
        res = _fit(_resilient(FlakyIOSource(ck.ArrayChunkSource(x, CS_F), schedule)), 9)
        return res.centroids, res.health.as_dict()

    (c1, h1), (c2, h2) = run(), run()
    assert torch.equal(c1, c2) and h1 == h2
    assert h1["retries"] == sum(schedule.values())


def test_streaming_skip_and_reweight_completes_and_accounts():
    x = _points(seed=13, n=N_F, k=4, spread=6.0, noise=1.0)
    res = _fit(_resilient(FlakyIOSource(ck.ArrayChunkSource(x, CS_F), {2: 10**6}), on_exhausted="skip"), 5)
    assert bool(torch.isfinite(res.centroids).all())
    assert res.health.lost_chunks == 1
    assert res.health.lost_points == CS_F
    assert res.health.degraded
    clean = _fit(ck.ArrayChunkSource(x, CS_F), 5)
    assert res.weighted_errors[-1] <= clean.weighted_errors[-1] * 1.5


def test_streaming_quarantine_counts_corrupt_rows():
    x = _points(seed=14, n=N_F, k=4, spread=6.0, noise=1.0)
    res = _fit(_resilient(CorruptChunkSource(ck.ArrayChunkSource(x, CS_F), {4: 7})), 7)
    assert bool(torch.isfinite(res.centroids).all())
    # counted on every pass: a multiple of the 7 poisoned rows
    assert res.health.quarantined_rows >= 7 and res.health.quarantined_rows % 7 == 0
    assert res.health.degraded


def test_deadlines_crashes_and_lost_chunks_surface_as_the_reference_says(tmp_path):
    from repro.testing import faults as jfaults

    x = _points(seed=15, n=2000, d=3)
    clock = FakeClock()
    slow = StragglerSource(ck.ArrayChunkSource(x, 512), {1: 5.0}, sleep=clock.sleep)
    src = ResilientChunkSource(
        slow, policy=RetryPolicy(max_attempts=3, base_delay_s=0.01, deadline_s=1.0),
        sleep=clock.sleep, clock=clock.time,
    )
    np.testing.assert_array_equal(np.concatenate(list(src.chunks())), x)
    assert (src.health.deadline_hits, src.health.retries) == (1, 1)
    assert clock.sleeps == [5.0, RetryPolicy(base_delay_s=0.01).delay_s(1, 0)]
    with pytest.raises(InjectedCrash):
        list(CrashingSource(ck.ArrayChunkSource(x, 512), 2).chunks())
    lost = ResilientChunkSource(FlakyIOSource(ck.ArrayChunkSource(x, 512), {3: 9}), sleep=clock.sleep)
    with pytest.raises(ChunkLostError):
        list(lost.chunks())
    assert seeded_fault_schedule(40, rate=0.3, seed=4) == jfaults.seeded_fault_schedule(40, rate=0.3, seed=4)
    paths = ck.write_npy_shards(x, tmp_path, rows_per_shard=700)
    sharded = ck.ShardedFileSource(paths, 512)
    os.remove(paths[2])
    with pytest.raises(ck.ChunkReadError, match="shard_00002"):
        list(sharded.chunks())


def test_run_health_merges_as_the_reference_does():
    a = {"retries": 2, "lost_points": 5, "lost_mass_frac": 0.25, "degraded": True}
    b = {"retries": 1, "quarantined_rows": 3, "lost_mass_frac": 0.5}
    got = RunHealth.from_dict(a).merged(RunHealth.from_dict(b))
    want = JRunHealth.from_dict(a).merged(JRunHealth.from_dict(b))
    assert got.as_dict() == want.as_dict()
    assert RunHealth.from_dict(None).merged(None) == RunHealth()


# ------------------------------------------------------------ the estimator
def test_engine_selection_follows_the_reference(tmp_path):
    x = _points(n=600, d=3)
    p = str(tmp_path / "x.npy")
    np.save(p, x)
    paths = ck.write_npy_shards(x, tmp_path / "shards", rows_per_shard=250)
    cases = [
        p, pathlib.Path(p), str(tmp_path / "shards" / "*.npy"), str(tmp_path / "shards"), paths,
        ck.ArrayChunkSource(x, 256), x, x.tolist(), torch.from_numpy(x),
    ]
    for data in cases:
        want = repro.api.engines.select_engine(
            jck.ArrayChunkSource(x, 256) if isinstance(data, ck.ArrayChunkSource)
            else data.numpy() if isinstance(data, torch.Tensor) else data
        )
        assert engines.select_engine(data) == want
    assert engines.select_engine(x, incore_limit_bytes=x.nbytes - 1) == "streaming"
    assert engines.select_engine(torch.from_numpy(x), incore_limit_bytes=x.nbytes - 1) == "streaming"
    assert engines.select_engine(x, incore_limit_bytes=x.nbytes) == "incore"
    assert engines.select_engine(p, "incore") == "incore"
    model = repro_torch.BWKM(k=3, device="cpu", max_iters=2, incore_limit_bytes=1000, chunk_size=256)
    assert model.fit(x).engine_ == "streaming"
    assert model.result_.metadata["n_chunks"] == 3
    with pytest.warns(UserWarning, match="init_sample_size"):
        repro_torch.BWKM(k=3, device="cpu", max_iters=1, init_sample_size=100).fit(x)


def test_out_of_core_predict_score_transform_match_float64(tmp_path):
    x = _points(seed=3, n=3000, k=4)
    p = str(tmp_path / "x.npy")
    np.save(p, x)
    m = repro_torch.BWKM(k=4, device="cpu", max_iters=6, chunk_size=700).fit(p)
    assert m.engine_ == "streaming"
    c = m.centroids_.numpy().astype(np.float64)
    d2 = ((x.astype(np.float64)[:, None, :] - c[None]) ** 2).sum(-1)
    labels = m.predict(p)  # 5 chunks, the last ragged
    assert labels.shape == (3000,) and labels.dtype == torch.int32
    top2 = np.sort(d2, axis=1)[:, :2]
    clear = top2[:, 1] - top2[:, 0] > 1e-5 * top2[:, 1]  # leave out the near-ties
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(labels.numpy()[clear], d2.argmin(1)[clear])
    np.testing.assert_allclose(m.score(p), d2.min(1).sum(), rtol=1e-4)
    assert m.score(p) == m.score(x) == m.score(torch.from_numpy(x))
    assert torch.equal(m.predict(ck.MemmapChunkSource(p, 1000)), labels)  # its own chunk size
    t = m.transform(p)
    assert t.shape == (3000, 4)
    np.testing.assert_allclose(t.numpy(), d2, rtol=1e-3, atol=1e-2)
    with pytest.raises(RuntimeError, match="not fitted"):
        repro_torch.BWKM(k=4, device="cpu").predict(p)


def test_nested_list_fits_in_core():
    x = _points(seed=8, n=200, d=2, k=2)
    want = repro.BWKM(k=2, max_iters=1).fit(x.tolist())
    got = repro_torch.BWKM(k=2, device="cpu", max_iters=1).fit(x.tolist())
    assert got.engine_ == want.engine_ == "incore"
    assert got.centroids_.shape == (2, 2) and got.predict(x.tolist()).shape == (200,)


def test_reservoir_init_is_kmeanspp_on_a_reservoir_sample():
    x = _points(seed=9)
    fits = [
        repro_torch.BWKM(k=5, device="cpu", engine=e, init=i, max_iters=3, chunk_size=700).fit(x)
        for e in ("streaming", "incore") for i in ("reservoir", "kmeans++")
    ]
    assert torch.equal(fits[0].centroids_, fits[1].centroids_)
    assert torch.equal(fits[2].centroids_, fits[3].centroids_)


def test_fold_in_is_deterministic_and_apart_from_split():
    k = rnd.key(5)
    assert k.fold_in(3).seed == rnd.fold_in(k, 3).seed
    seeds = {k.fold_in(i).seed for i in range(4)} | {s.seed for s in rnd.split(k, 4)}
    assert len(seeds) == 8


def test_streaming_entry_points_raise_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _points(seed=10, n=600, d=2, k=2)
    src = ck.ArrayChunkSource(x, 256)
    calls = [
        lambda **kw: streaming.fit_streaming(rnd.key(0), src, bwkm.BWKMConfig(k=2, max_iters=1), **kw),
        lambda **kw: streaming.kmeans_parallel_streaming(rnd.key(0), src, 2, **kw),
        lambda **kw: streaming.streaming_lloyd(src, x[:2], max_iters=1, **kw),
        lambda **kw: streaming.streaming_lloyd_step(src, x[:2], **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
