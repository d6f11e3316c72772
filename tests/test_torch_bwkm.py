"""The port's main path held against the JAX reference: seeding, Lloyd, the
whole fit, state carried across, and the package's hygiene.

``JaxKey`` is a test-only implementation of the port's RNG seam
(``repro_torch.random``) that calls ``jax.random`` with the reference's
keys, so the port follows the reference's draws one for one; the numbers a
key draws are handed to torch as numpy. With it the port reproduces the
golden in-core fit of ``tests/test_golden.py``. With the production
``TorchKey`` the draws differ, and on well-separated data both packages
must still reach ``boundary-empty`` at the same centroids.
"""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import assign_f64, error_f64, gmm

import repro
import repro_torch
from repro.core import kmeanspp as jkpp
from repro.core import lloyd as jlloyd
from repro.core import misassignment as jmis
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import kmeanspp, lloyd
from repro_torch.core import misassignment as mis
from repro_torch.core import partition as part_mod
from repro_torch.kernels import ops

GOLDEN = pathlib.Path(__file__).parent / "golden" / "bwkm_fitresult.json"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


class JaxKey:
    """The port's key protocol over ``jax.random`` (test-only)."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return tuple(JaxKey(k) for k in jax.random.split(self.key, num))

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def randint(self, shape, minval, maxval, device):
        out = jax.random.randint(self.key, tuple(shape), minval, maxval)
        return torch.as_tensor(np.array(out), device=device).long()

    def categorical(self, logits, shape=None):
        lg = jnp.asarray(logits.detach().cpu().numpy())
        out = jax.random.categorical(self.key, lg, shape=shape)
        return torch.as_tensor(np.array(out), device=logits.device).long()

    def uniform(self, shape, device):
        return torch.as_tensor(np.array(jax.random.uniform(self.key, tuple(shape))), device=device)

    def gumbel(self, shape, device):
        return torch.as_tensor(np.array(jax.random.gumbel(self.key, tuple(shape))), device=device)

    def choice(self, n, shape, device):
        out = jax.random.choice(self.key, n, shape=tuple(shape), replace=False)
        return torch.as_tensor(np.array(out), device=device).long()


def _weighted_points(seed=0, n=300, d=4, k=5):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 6
    x = (centers[rng.randint(0, k, n)] + rng.randn(n, d)).astype(np.float32)
    w = rng.randint(0, 5, n).astype(np.float32)  # some zero-weight rows
    return x, w


def test_seeding_follows_the_reference_draw_for_draw():
    x, w = _weighted_points()
    key = jax.random.PRNGKey(3)
    got = kmeanspp.weighted_kmeanspp(JaxKey(key), torch.from_numpy(x), torch.from_numpy(w), 6)
    want = jkpp.weighted_kmeanspp(key, jnp.asarray(x), jnp.asarray(w), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = kmeanspp.forgy(JaxKey(key), torch.from_numpy(x), 6, torch.from_numpy(w))
    want = jkpp.forgy(key, jnp.asarray(x), 6, w=jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("prune", [False, True])
def test_weighted_lloyd_matches_the_reference(prune):
    x, w = _weighted_points(seed=1)
    c0 = x[:5].copy()
    want = jlloyd.weighted_lloyd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(c0), max_iters=50, epsilon=1e-6,
        impl="ref", prune=prune,
    )
    got = lloyd.weighted_lloyd(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(c0), max_iters=50,
        epsilon=1e-6, prune=prune,
    )
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-5)
    assert float(got.distances) == float(want.distances)
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    np.testing.assert_allclose(got.d1.numpy(), np.asarray(want.d1), rtol=1e-5, atol=1e-4)


def test_pruned_lloyd_reaches_the_dense_centroids_bit_for_bit():
    x, w = _weighted_points(seed=2)
    tx, tw, c0 = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(x[:5].copy())
    dense = lloyd.weighted_lloyd(tx, tw, c0, prune=False)
    pruned = lloyd.weighted_lloyd(tx, tw, c0, prune=True)
    assert dense.iters == pruned.iters
    assert torch.equal(dense.centroids, pruned.centroids)
    assert float(pruned.distances) < float(dense.distances) + float((tw > 0).sum()) * 5


def _golden_data():
    return np.asarray(gmm(jax.random.PRNGKey(5), 2000, 3, 4, spread=8.0, noise=2.0))


def _sorted(c):
    c = np.asarray(c, np.float64)
    return c[np.lexsort(c.T[::-1])]


def test_golden_fit_with_the_reference_draws():
    x = _golden_data()
    golden = json.loads(GOLDEN.read_text())["incore"]
    live = repro.BWKM(k=4, engine="incore", max_iters=5, chunk_size=512, seed=0).fit(x)
    model = repro_torch.BWKM(k=4, device="cpu", max_iters=5).fit(
        x, key=JaxKey(jax.random.PRNGKey(0))
    )
    res = model.result_
    for want in (golden, {
        "stop_reason": live.result_.stop_reason, "iterations": live.result_.iterations,
        "distances": live.result_.distances, "centroids": _sorted(live.centroids_),
        "error": error_f64(x, live.centroids_),
    }):
        assert res.stop_reason == want["stop_reason"]
        assert res.iterations == want["iterations"]
        np.testing.assert_allclose(res.distances, want["distances"], rtol=0.05)
        np.testing.assert_allclose(error_f64(x, model.centroids_.numpy()), want["error"], rtol=1e-3)
        np.testing.assert_allclose(
            _sorted(model.centroids_.numpy()), np.asarray(want["centroids"]), rtol=5e-3, atol=5e-2
        )
    assert res.metadata["n_blocks"] == live.result_.metadata["n_blocks"]


def test_fit_predict_gives_the_labels_of_fit_then_predict():
    x = _golden_data()
    key = jax.random.PRNGKey(0)
    want = repro.BWKM(k=4, engine="incore", max_iters=5, chunk_size=512, seed=0).fit_predict(
        x, key=key
    )
    model = repro_torch.BWKM(k=4, device="cpu", max_iters=5)
    got = model.fit_predict(x, key=JaxKey(key))
    assert got.dtype == torch.int32 and torch.equal(got, model.predict(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("init", [None, "kmeans++", "kmeans||", "forgy", "kmeans-parallel"])
def test_init_property_matches_the_reference(init):
    assert repro_torch.BWKM(k=3, device="cpu", init=init).init == repro.BWKM(k=3, init=init).init


def test_production_rng_reaches_the_reference_fixed_point():
    x = np.asarray(gmm(jax.random.PRNGKey(1), 3000, 2, 3, spread=20.0, noise=0.5))
    want = repro.BWKM(k=3, engine="incore", seed=0).fit(x)
    got = repro_torch.BWKM(k=3, device="cpu", seed=0).fit(x)
    assert want.result_.stop_reason == "boundary-empty"
    assert got.result_.stop_reason == "boundary-empty"
    np.testing.assert_allclose(
        _sorted(got.centroids_.numpy()), _sorted(want.centroids_), rtol=1e-4, atol=1e-4
    )
    assert got.result_.metadata["health"]["degraded"] is False


def test_state_carried_across_serves_the_same_answers():
    x = _golden_data()
    ref_model = repro.BWKM(k=4, engine="incore", max_iters=3, seed=1).fit(x)
    c = np.asarray(ref_model.centroids_)
    model = repro_torch.BWKM.from_centroids(c, device="cpu", chunk_size=512)
    np.testing.assert_array_equal(model.predict(x).numpy(), assign_f64(x, c))
    np.testing.assert_allclose(model.score(x), error_f64(x, c), rtol=1e-5)
    np.testing.assert_allclose(
        model.transform(x[:7]).numpy(), ((x[:7, None] - c[None]) ** 2).sum(-1), rtol=1e-4, atol=1e-3
    )
    # the fitted Partition, as numpy, gives the same misassignment in the port
    jpart = ref_model.result_.metadata["partition"]
    part = convert.partition_from_numpy(jpart, device="cpu")
    back = convert.partition_to_numpy(part)
    for f, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jpart, f)))
    reps, w = part_mod.representatives(part)
    _, d1, d2 = ops.assign_top2(reps, torch.from_numpy(c))
    from repro.core import partition as jpart_mod

    jreps, _ = jpart_mod.representatives(jpart)
    _, jd1, jd2 = jops.assign_top2(jreps, jnp.asarray(c), impl="ref")
    np.testing.assert_allclose(
        mis.misassignment(part, d1, d2).numpy(), np.asarray(jmis.misassignment(jpart, jd1, jd2)),
        rtol=1e-5, atol=1e-5,
    )


def test_package_imports_neither_jax_nor_the_reference():
    bad = []
    paths = sorted(SRC.rglob("*.py"))
    scanned = {p.relative_to(SRC).parts[0] for p in paths}
    assert {"api", "core", "engine", "kernels", "service", "streaming", "train"} <= scanned
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(SRC)}: {name}")
    assert not bad, bad


def test_entry_point_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.RandomState(0).randn(50, 2).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.BWKM(k=2).fit(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.BWKM.from_centroids(x[:2])
    assert repro_torch.BWKM(k=2, device="cpu", max_iters=1).fit(x).centroids_.device.type == "cpu"


def test_unported_options_name_their_roadmap_item():
    assert repro_torch.BWKM(k=2, device="cpu", init="kmeans||").config.init == "kmeans||"
    # queue A item 10 brought AFK-MC² (both names resolve now)
    assert repro_torch.BWKM(k=2, device="cpu", init="afkmc2").init == "afkmc2"
    assert repro_torch.BWKM(k=2, device="cpu", init="kmc2").init == "kmc2"
    assert repro_torch.BWKM(k=2, device="cpu", engine="streaming").engine == "streaming"
    assert repro_torch.BWKM(k=2, device="cpu", init="reservoir").init == "reservoir"
    # queue A item 13 brought the distributed engine
    assert repro_torch.BWKM(k=2, device="cpu", engine="distributed").engine == "distributed"
    with pytest.raises(ValueError, match="unknown engine"):
        repro_torch.BWKM(k=2, device="cpu", engine="nope")
    with pytest.raises(ValueError, match="unknown init"):
        repro_torch.BWKM(k=2, device="cpu", init="nope")


@pytest.mark.parametrize("overrides,reason", [
    ({"distance_budget": 1.0}, "distance-budget"),
    ({"displacement_epsilon": 1e9}, "displacement"),
    ({"gap_bound_threshold": 1e30}, "gap-bound"),
    ({"capacity": 30}, "capacity"),
    ({"max_iters": 1}, "max-iters"),
])
def test_each_stop_criterion_ends_the_fit(overrides, reason):
    x = _golden_data()
    res = repro_torch.BWKM(k=4, device="cpu", m=20, **overrides).fit(x).result_
    assert res.stop_reason == reason
    assert res.iterations == len(res.metadata["n_blocks"])


def test_non_finite_rows_are_quarantined():
    x = _golden_data()
    dirty = x.copy()
    dirty[[3, 50, 700]] = [np.nan, np.inf, -np.inf]
    got = repro_torch.BWKM(k=4, device="cpu", max_iters=3).fit(dirty).result_
    clean = repro_torch.BWKM(k=4, device="cpu", max_iters=3).fit(np.delete(x, [3, 50, 700], 0)).result_
    assert got.metadata["health"]["quarantined_rows"] == 3
    assert got.metadata["health"]["degraded"] is True
    assert torch.equal(got.centroids, clean.centroids)
