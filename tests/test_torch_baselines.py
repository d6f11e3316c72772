"""The paper's baselines and trade-off metrics in the port, held against the
JAX reference draw for draw.

Every port function runs on the CPU under ``JaxKey`` (the port's key
protocol over ``jax.random``), so it takes the reference's random numbers;
the reference functions themselves are the oracle. Data: n = 2,000, d = 4,
K = 5 from ``np.random.RandomState(0)``. Tolerances: seeds bit-equal; the
Lloyd baselines' iterations, stop reasons and distance counts equal,
centroids within 1e-5 and errors within rtol 1e-5; mini-batch and
grid-RPKM centroids within 1e-4 (their sums accumulate in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bwkm import JaxKey, _weighted_points

from repro.core import baselines as jbase
from repro.core import kmeanspp as jkpp
from repro.core import lloyd as jlloyd
from repro.core import metrics as jmetrics
from repro_torch.core import baselines, kmeanspp, lloyd, metrics

K = 5


def _data(n=2000, d=4, k=K, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 8
    return (centers[rng.randint(0, k, n)] + rng.randn(n, d)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


SEEDERS = {
    "forgy": (lambda key, x: kmeanspp.forgy(key, x, K), lambda key, x: jkpp.forgy(key, x, K)),
    "kmeanspp": (lambda key, x: kmeanspp.kmeanspp(key, x, K),
                 lambda key, x: jkpp.kmeanspp(key, x, K)),
    "afkmc2": (lambda key, x: kmeanspp.afkmc2(key, x, K, chain_length=20),
               lambda key, x: jkpp.afkmc2(key, x, K, chain_length=20)),
}


@pytest.mark.parametrize("name", sorted(SEEDERS))
def test_seeding_picks_the_reference_rows(name):
    x = _data()
    port, ref = SEEDERS[name]
    key = jax.random.PRNGKey(7)
    got = port(JaxKey(key), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref(key, jnp.asarray(x))))


LLOYD_BASELINES = {
    "forgy": (baselines.forgy_kmeans, jbase.forgy_kmeans, {}),
    "kmeans++": (baselines.kmeanspp_kmeans, jbase.kmeanspp_kmeans, {}),
    "kmeans++_init": (baselines.kmeanspp_kmeans, jbase.kmeanspp_kmeans, {"init_only": True}),
    "kmc2": (baselines.kmc2_kmeans, jbase.kmc2_kmeans, {"chain_length": 20}),
}


@pytest.mark.parametrize("name", sorted(LLOYD_BASELINES))
def test_lloyd_baselines_match_the_reference(name):
    x = _data()
    port, ref, kw = LLOYD_BASELINES[name]
    key = jax.random.PRNGKey(3)
    got = port(JaxKey(key), torch.from_numpy(x), K, **kw)
    want = ref(key, jnp.asarray(x), K, **kw)
    assert got.engine == want.engine == f"baseline:{name}"
    assert (got.iterations, got.stop_reason) == (want.iterations, want.stop_reason)
    assert got.distances == want.distances
    _close(got.centroids, want.centroids, 1e-5)
    assert got.metadata.keys() == want.metadata.keys()
    if "error" in want.metadata:
        np.testing.assert_allclose(got.metadata["error"], want.metadata["error"], rtol=1e-5)


def test_minibatch_matches_the_reference():
    x = _data()
    key = jax.random.PRNGKey(4)
    got = baselines.minibatch_kmeans(JaxKey(key), torch.from_numpy(x), K, batch=50, iters=30)
    want = jbase.minibatch_kmeans(key, jnp.asarray(x), K, batch=50, iters=30)
    assert (got.engine, got.distances, got.iterations, got.stop_reason) == (
        want.engine, want.distances, want.iterations, want.stop_reason)
    assert got.metadata == want.metadata
    _close(got.centroids, want.centroids, 1e-4)


def _np_cells(x, level):
    """The reference's quantisation and cells, in numpy."""
    lo, hi = x.min(axis=0), x.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    bins = 1 << level
    q = np.minimum(((x - lo) / span * bins).astype(np.int64), bins - 1)
    return np.unique(q, axis=0, return_inverse=True, return_counts=True)


@pytest.mark.parametrize("x,max_level,reason", [
    (_data(), 4, "max-level"),
    (np.random.RandomState(1).rand(500, 6).astype(np.float32), 6, "grid-exhausted"),
], ids=["gmm", "uniform"])
def test_grid_rpkm_matches_the_reference(x, max_level, reason):
    key = jax.random.PRNGKey(5)
    got = baselines.grid_rpkm(JaxKey(key), torch.from_numpy(x), K, max_level=max_level)
    want = jbase.grid_rpkm(key, jnp.asarray(x), K, max_level=max_level)
    assert got.stop_reason == want.stop_reason == reason
    assert (got.engine, got.iterations, got.distances) == (
        want.engine, want.iterations, want.distances)
    assert got.metadata["cells"] == [
        len(_np_cells(x, level)[2]) for level in range(1, got.iterations + 1)]
    _close(got.centroids, want.centroids, 1e-4)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_grid_cells_are_numpys_unique_cells(level):
    x = _data()
    tx = torch.from_numpy(x)
    lo, hi = tx.min(0).values, tx.max(0).values
    cells, inverse, counts = baselines.grid_cells(tx, lo, torch.where(hi > lo, hi - lo, 1.0), level)
    want_cells, want_inverse, want_counts = _np_cells(x, level)
    np.testing.assert_array_equal(cells.numpy(), want_cells)
    np.testing.assert_array_equal(inverse.numpy(), want_inverse.reshape(-1))
    np.testing.assert_array_equal(counts.numpy(), want_counts)


def test_kmeans_error_across_a_chunk_edge_and_relative_errors():
    rng = np.random.RandomState(2)
    x = (rng.randn(70_000, 4) * 3).astype(np.float32)
    c = x[:K].copy()
    got = metrics.kmeans_error(torch.from_numpy(x), torch.from_numpy(c))
    want = jmetrics.kmeans_error(jnp.asarray(x), jnp.asarray(c))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    errors = {"a": 3.0, "b": 2.0, "c": 2.5}
    assert metrics.relative_errors(errors) == jmetrics.relative_errors(errors)


@pytest.mark.parametrize("prune", [False, True])
def test_lloyd_and_its_trace_match_the_reference(prune):
    x, w = _weighted_points(seed=1)
    c0 = x[:K].copy()
    kw = dict(max_iters=50, epsilon=1e-6, prune=prune)
    got = lloyd.lloyd(torch.from_numpy(x), torch.from_numpy(c0), **kw)
    want = jlloyd.lloyd(jnp.asarray(x), jnp.asarray(c0), impl="ref", **kw)
    assert got.iters == int(want.iters) and float(got.distances) == float(want.distances)
    _close(got.centroids, want.centroids, 1e-5)

    got, trace = lloyd.weighted_lloyd_trace(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c0), **kw)
    want, want_trace = jlloyd.weighted_lloyd_trace(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(c0), impl="ref", **kw)
    assert got.iters == int(want.iters) and float(got.distances) == float(want.distances)
    _close(got.centroids, want.centroids, 1e-5)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-5)
    assert len(trace) == len(want_trace)
    assert trace[-1].get("finishing_pass", False) is prune
    for row, want_row in zip(trace, want_trace):
        assert row.keys() == want_row.keys()
        for f in ("iteration", "active_rows", "rows", "pruned_fraction", "n_dist"):
            assert row[f] == want_row[f], f
        np.testing.assert_allclose(row["error"], want_row["error"], rtol=1e-5)
