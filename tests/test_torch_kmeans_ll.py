"""The port's k-means|| seeding held against the JAX reference.

Inputs are made with numpy from a seed. With the test-only ``JaxKey``
(``test_torch_bwkm.py``) the port takes the reference's random draws, so
its seeds are the reference's seeds exactly — they are copies of rows — and
its candidate, distance and pass counts are the same. The folds run on the
CPU through the plain versions; the kernels B4/B5 run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import error_f64
from test_torch_bwkm import JaxKey, _golden_data

import repro
import repro_torch
from repro.core import kmeans_ll as jll
from repro.engine import driver as jdriver
from repro_torch import random as rnd
from repro_torch.api.inits import resolve_init
from repro_torch.core import kmeans_ll
from repro_torch.engine import driver


def _points(seed=0, n=2240, d=3, k=6):
    """By default the shape of ``BWKM(k=4)``'s representatives of the golden
    data, so the reference compiles its k-means|| steps once per file."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 8
    x = (centers[rng.randint(0, k, n)] + rng.randn(n, d)).astype(np.float32)
    w = rng.randint(0, 4, n).astype(np.float32)  # about a quarter zero-weight
    return x, w


def test_seeds_are_the_reference_seeds():
    k = 4  # ℓ = 2K, 5 rounds, about a quarter of the weights zero
    x, w = _points(seed=k)
    key = jax.random.PRNGKey(k)
    want = jll.kmeans_parallel(
        key, jnp.asarray(x), jnp.asarray(w), k, impl="ref", return_info=True
    )
    got = kmeans_ll.kmeans_parallel(
        JaxKey(key), torch.from_numpy(x), torch.from_numpy(w), k, return_info=True
    )
    np.testing.assert_array_equal(got.centroids.numpy(), np.asarray(want.centroids))
    assert float(got.n_candidates) == float(want.n_candidates)
    assert float(got.distances) == float(want.distances)
    assert got.passes == want.passes == 7
    rows = {tuple(r) for r in x[w > 0]}  # zero-weight rows are never seeds
    assert all(tuple(c) in rows for c in got.centroids.numpy())


def test_round_parameters_and_the_bernoulli_draw_follow_the_reference():
    for k, over, rounds in ((27, None, None), (100, None, None), (3, 1, 1), (4, 7, 2)):
        assert driver.resolve_ll_params(k, over, rounds) == jdriver.resolve_ll_params(k, over, rounds)
    rng = np.random.RandomState(0)
    u = rng.rand(5000).astype(np.float32)
    w = (rng.rand(5000) * (rng.rand(5000) > 0.2)).astype(np.float32)
    mind2 = (rng.rand(5000) * 10).astype(np.float32)
    phi = np.float32((w * mind2).sum())
    got = driver.ll_bernoulli(*map(torch.from_numpy, (u, w, mind2)), 54, torch.tensor(phi))
    want = jdriver.ll_bernoulli(u, w, mind2, 54, jnp.float32(phi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool(got[torch.from_numpy(w) == 0].any())


def test_rounds_and_oversampling_must_be_positive():
    x, w = _points()
    with pytest.raises(ValueError, match=">= 1"):
        kmeans_ll.kmeans_parallel(rnd.key(0), torch.from_numpy(x), None, 3, rounds=0)
    with pytest.raises(ValueError, match=">= 1"):
        kmeans_ll.kmeans_parallel(rnd.key(0), torch.from_numpy(x), None, 3, oversampling=0)


def test_production_key_seeds_from_positive_weights_on_the_callers_device():
    x, w = _points(seed=3, n=400, d=5)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    out = kmeans_ll.kmeans_parallel(rnd.key(7), tx, tw, 6, return_info=True)
    again = kmeans_ll.kmeans_parallel(rnd.key(7), tx, tw, 6)
    assert out.centroids.device.type == "cpu" and out.centroids.shape == (6, 5)
    assert torch.equal(out.centroids, again)
    rows = {tuple(r) for r in x[w > 0]}
    assert all(tuple(c) in rows for c in out.centroids.numpy())
    assert 1 <= float(out.n_candidates) <= 1 + 5 * 24 and out.passes == 7
    # unweighted, with ℓ and the rounds given: every row may be drawn
    out = kmeans_ll.kmeans_parallel(rnd.key(8), tx, None, 4, oversampling=3, rounds=2,
                                    return_info=True)
    assert out.passes == 4 and 1 <= float(out.n_candidates) <= 1 + 2 * 8
    # each candidate is folded once and weighed once against all 400 rows,
    # then the K-means++ reduction pays K − 1 per candidate
    assert float(out.distances) == float(out.n_candidates) * (2 * 400 + 3)
    for alias in ("kmeans||", "kmeansll", "kmeans-parallel", "scalable-kmeans++"):
        assert resolve_init(alias).seed_centroids is kmeans_ll.kmeans_parallel


def test_float64_input_gives_the_f32_seeds():
    x, w = _points(seed=3, n=400, d=5)
    want = kmeans_ll.kmeans_parallel(rnd.key(7), torch.from_numpy(x), torch.from_numpy(w), 6)
    got = kmeans_ll.kmeans_parallel(
        rnd.key(7), torch.from_numpy(x.astype(np.float64)), torch.from_numpy(w.astype(np.float64)), 6
    )
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_bwkm_with_kmeans_ll_init_matches_the_reference_fit():
    x = _golden_data()
    live = repro.BWKM(k=4, engine="incore", init="kmeans||", max_iters=5, chunk_size=512,
                      seed=0).fit(x)
    model = repro_torch.BWKM(k=4, device="cpu", init="kmeans||", max_iters=5).fit(
        x, key=JaxKey(jax.random.PRNGKey(0))
    )
    res, want = model.result_, live.result_
    assert res.stop_reason == want.stop_reason
    assert res.iterations == want.iterations
    assert res.metadata["n_blocks"] == want.metadata["n_blocks"]
    np.testing.assert_allclose(res.distances, want.distances, rtol=0.05)
    np.testing.assert_allclose(
        error_f64(x, model.centroids_.numpy()), error_f64(x, live.centroids_), rtol=1e-3
    )
