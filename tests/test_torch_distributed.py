"""The port's distributed engine on the CPU: one rank against the JAX
reference, and two and four ranks over gloo against one rank.

Without a mesh the port's distributed functions are held against the
reference's unmeshed path in this process, under ``JaxKey`` where they
draw. The ranks of W = 2 and W = 4 (``_torch_dist_ranks``, spawned once
each for the whole module and run side by side) import only the port; each
saves what it saw, and the tests here compare: block statistics bit-equal
to one ``block_stats`` over all rows, fits bit-equal to one rank, the same
centroids on every rank, pruned ≡ dense, k-means|| repeating, shard loss
reweighted as the reference's own functions do, and ``ShardLossError``
raised on every rank (the ranks' deadline fails a hang).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_ranks import D, K, M, MAX_ITERS, N, N_EVEN, collect, memberships, points, spawn
from helpers import error_f64
from test_torch_bwkm import JaxKey

from repro.api import engines as jengines
from repro.core import bwkm as jbwkm
from repro.core import partition as jpart
from repro.distributed import dist_bwkm as jdist
from repro.distributed import dist_kmeans_ll as jdll
from repro.engine import sharded as jsharded
from repro.health import RunHealth as JRunHealth
from repro.testing import faults as jfaults
import repro_torch
from repro_torch import random as rnd
from repro_torch.core import bwkm
from repro_torch.core import partition as part_mod
from repro_torch.distributed import dist_bwkm, dist_kmeans_ll
from repro_torch.distributed import sharding as sh
from repro_torch.engine import driver, sharded
from repro_torch.engine.incore import InCoreLLSession
from repro_torch.testing.faults import shard_loss_rows_mask
from repro_torch.train import checkpoint

TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_kernels_properties.py's f32 tolerance
WORLDS = (2, 4)
RANK_SECONDS = 75.0  # the ranks' deadline: a hang fails the module


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    started = {w: spawn(w, root / f"w{w}", RANK_SECONDS) for w in WORLDS}
    return {w: collect(s, root / f"w{w}") for w, s in started.items()}


@pytest.fixture(scope="module")
def one_rank_fit():
    return dist_bwkm.fit_distributed(rnd.key(0), torch.from_numpy(points(N)), _cfg())


def _cfg():
    return bwkm.BWKMConfig(k=K, max_iters=MAX_ITERS)


# ------------------------------------------------- one rank: the reference
def test_unmeshed_fit_follows_the_reference():
    x = points(N)
    key = jax.random.PRNGKey(0)
    want = jdist.fit_distributed(key, jnp.asarray(x), jbwkm.BWKMConfig(k=K, max_iters=MAX_ITERS))
    got = dist_bwkm.fit_distributed(JaxKey(key), torch.from_numpy(x), _cfg())
    assert got.stop_reason == want.stop_reason
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.distances, want.distances, rtol=0.05)
    np.testing.assert_allclose(error_f64(x, got.centroids.numpy()), error_f64(x, want.centroids), rtol=1e-3)
    assert not got.health.degraded


@pytest.mark.parametrize("prune", [True, False])
def test_unmeshed_lloyd_follows_the_reference(prune):
    x = points(N)
    c0 = x[:K].copy()
    want = jdist.dist_lloyd(jnp.asarray(x), jnp.asarray(c0), max_iters=MAX_ITERS, epsilon=1e-6,
                            prune=prune)
    got = dist_bwkm.dist_lloyd(torch.from_numpy(x), torch.from_numpy(c0), max_iters=MAX_ITERS,
                               epsilon=1e-6, prune=prune)
    assert got.iters == want.iters
    np.testing.assert_allclose(got.error, want.error, rtol=1e-3)
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(got.distances, want.distances, rtol=0.05)


def test_unmeshed_assign_step_and_statistics_follow_the_reference():
    x, bid = points(N), memberships(N)
    c0 = x[:K].copy()
    want_c, want_err = jdist.dist_assign_step(jnp.asarray(x), jnp.asarray(c0))
    got_c, got_err = dist_bwkm.dist_assign_step(torch.from_numpy(x), torch.from_numpy(c0))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(float(got_err), float(want_err), rtol=1e-5)
    alive = shard_loss_rows_mask(N_EVEN, 4, [1])
    for n, a in ((N, None), (N_EVEN, alive)):
        jp = jpart.create_partition(jnp.zeros((1, D)), M)
        want = jdist.dist_recompute_stats(jp, jnp.asarray(x[:n]), jnp.asarray(bid[:n]),
                                          None if a is None else jnp.asarray(a))
        got = dist_bwkm.dist_recompute_stats(
            part_mod.create_partition(torch.zeros(1, D), M), torch.from_numpy(x[:n]),
            torch.from_numpy(bid[:n]), None if a is None else torch.from_numpy(a),
        )
        np.testing.assert_allclose(got.psum.numpy(), np.asarray(want.psum), **TOL)
        for f in ("count", "lo", "hi"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_unmeshed_kmeans_parallel_is_the_references():
    x = points(N)
    key = jax.random.PRNGKey(3)
    want = jdll.dist_kmeans_parallel(key, jnp.asarray(x), K)
    got = dist_kmeans_ll.dist_kmeans_parallel(JaxKey(key), torch.from_numpy(x), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_non_finite_rows_abort_the_one_shard():
    x = points(N)  # the shapes of the first test: the reference's compiled steps are reused
    x[5] = np.inf
    with pytest.raises(jdist.ShardLossError):
        jdist.fit_distributed(jax.random.PRNGKey(0), jnp.asarray(x),
                              jbwkm.BWKMConfig(k=K, max_iters=MAX_ITERS))
    with pytest.raises(dist_bwkm.ShardLossError, match="aborting"):
        dist_bwkm.fit_distributed(rnd.key(0), torch.from_numpy(x), _cfg())


# -------------------------------------------------- W ranks: one pass, one rank
@pytest.mark.parametrize("world", WORLDS)
def test_block_statistics_are_bit_equal_to_one_pass(ranks, world):
    out = ranks[world]
    for n in (N, N_EVEN):
        assert sum(r[f"rows{n}"] for r in out) == n
        assert max(r[f"rows{n}"] for r in out) - min(r[f"rows{n}"] for r in out) <= 1
        want = part_mod.block_stats(torch.from_numpy(points(n)), torch.from_numpy(memberships(n)), M)
        for r in out:
            for got, ref in zip(r[f"stats{n}"], want):
                assert torch.equal(got, ref)
    # every statistics round of the fit, against one pass over all rows
    x = torch.from_numpy(points(N))
    n_rounds = len(out[0]["fit_rounds"])
    assert n_rounds == out[0]["fit"]["iterations"]  # round 0, then one a split
    for i in range(n_rounds):
        bid = torch.cat([r["fit_rounds"][i][0] for r in out])
        m = out[0]["fit_rounds"][i][5]
        want = part_mod.block_stats(x, bid, m)
        for r in out:
            for got, ref in zip(r["fit_rounds"][i][1:5], want):
                assert torch.equal(got, ref)


@pytest.mark.parametrize("world", WORLDS)
def test_fit_is_bit_equal_to_one_rank_on_every_rank(ranks, world, one_rank_fit):
    one = one_rank_fit
    for r in ranks[world]:
        assert r["n_shards"] == world
        got = r["fit"]
        assert torch.equal(got["centroids"], one.centroids)
        assert got["stop_reason"] == one.stop_reason
        assert got["iterations"] == one.iterations
        assert got["n_blocks"] == one.n_blocks
        assert got["distances"] == one.distances
        assert got["weighted_errors"] == one.weighted_errors
        assert not got["health"]["degraded"]
        # engine="auto" takes the distributed engine under a mesh
        assert r["selected"] == "distributed"
        assert r["facade"][0] == "distributed"
        assert torch.equal(r["facade"][1], one.centroids)
    spread = torch.stack([r["fit"]["centroids"] for r in ranks[world]])
    assert float((spread.amax(0) - spread.amin(0)).abs().max()) == 0.0


@pytest.mark.parametrize("world", WORLDS)
def test_lloyd_pruned_is_dense_bit_for_bit(ranks, world):
    x = points(N)
    one_c, one_err = dist_bwkm.dist_assign_step(torch.from_numpy(x), torch.from_numpy(x[:K].copy()))
    for r in ranks[world]:
        pruned, dense = r["lloyd_True"], r["lloyd_False"]
        assert torch.equal(pruned[0], dense[0])
        assert pruned[2] == dense[2]
        assert pruned[3] < dense[3]
        assert torch.equal(pruned[0], ranks[world][0]["lloyd_True"][0])
        np.testing.assert_allclose(r["assign_step"][0].numpy(), one_c.numpy(), **TOL)
        np.testing.assert_allclose(float(r["assign_step"][1]), float(one_err), rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_kmeans_parallel_repeats_and_keeps_the_cost_of_one_rank(ranks, world):
    x = torch.from_numpy(points(N))
    l, r_, cap = driver.resolve_ll_params(K, None, None)  # noqa: E741
    sess = InCoreLLSession(rnd.key(3), x, torch.ones(N), k=K, l=l, rounds=r_, cap_round=cap)
    driver.plane_kmeans_parallel(sess, rounds=r_)
    for r in ranks[world]:
        assert torch.equal(r["ll"][0], r["ll"][1])
        assert torch.equal(r["ll"][0], ranks[world][0]["ll"][0])
        assert r["ll_phi"][0] == r["ll_phi"][1]
        np.testing.assert_allclose(r["ll_phi"][0], float(sess.phi), rtol=1e-5)


def test_shard_loss_reweights_as_the_reference_does(ranks):
    out = ranks[4]
    x = points(N_EVEN)
    part_in = out[0]["fault_round"][0]
    bid = torch.cat([r["fault_round"][1] for r in out]).numpy()
    alive = jfaults.shard_loss_rows_mask(N_EVEN, 4, [2])
    jp = jpart.Partition(*(jnp.asarray(t.numpy()) for t in part_in))
    want, n_ok = jsharded._recompute_stats_ok(jp, jnp.asarray(x), jnp.asarray(bid), jnp.asarray(alive))
    want = jsharded._apply_shard_loss(
        want, n=N_EVEN, n_ok=4 * n_ok, n_shards=4, n_injected=1, health=JRunHealth(),
        max_shard_loss_frac=0.5, round_index=1,
    )
    for r in out:
        got = r["fault_round"][2]
        np.testing.assert_allclose(got.psum.numpy(), np.asarray(want.psum), **TOL)
        np.testing.assert_allclose(got.count.numpy(), np.asarray(want.count), **TOL)
        for f in ("lo", "hi", "active", "n_blocks"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        h = r["fault"]["health"]
        assert (h["lost_shards"], h["degraded_rounds"], h["lost_mass_frac"]) == (1, 1, 0.25)
        assert torch.equal(r["fault"]["centroids"], out[0]["fault"]["centroids"])


@pytest.mark.parametrize("world", WORLDS)
def test_shard_loss_above_the_limit_raises_on_every_rank(ranks, world):
    for r in ranks[world]:
        assert r["abort"] is not None and "aborting" in r["abort"]
        assert f"1 of {world} shards" in r["abort"]


def test_a_non_finite_row_drops_one_shard_of_four(ranks):
    for r in ranks[4]:
        got = r["inf"]
        assert got["health"]["lost_mass_frac"] == 0.25
        assert got["health"]["lost_shards"] == got["health"]["degraded_rounds"] == got["iterations"]
        assert bool(torch.isfinite(got["centroids"]).all())
        assert torch.equal(got["centroids"], ranks[4][0]["inf"]["centroids"])


# --------------------------------------------------------------- facade
def test_checkpoints_restore_the_final_state(tmp_path):
    x = points(N)
    model = repro_torch.BWKM(k=K, device="cpu", engine="distributed", max_iters=MAX_ITERS,
                             checkpoint_dir=str(tmp_path)).fit(x)
    assert model.engine_ == "distributed"
    part = model.result_.metadata["partition"]
    step = checkpoint.latest_step(tmp_path)
    assert step == model.result_.iterations
    template = {"centroids": model.centroids_,
                "boxes": {"lo": part.lo, "hi": part.hi, "active": part.active,
                          "n_blocks": part.n_blocks}}
    cpu = torch.device("cpu")
    state, extra = checkpoint.restore(
        tmp_path, step, template,
        shardings={"centroids": cpu, "boxes": {"lo": cpu, "hi": "cpu", "active": cpu, "n_blocks": cpu}},
        device="cpu",
    )
    assert torch.equal(state["centroids"], model.centroids_)
    for f in ("lo", "hi", "active", "n_blocks"):
        assert torch.equal(state["boxes"][f], getattr(part, f))
    assert extra["iteration"] == step and extra["distances"] == model.result_.distances
    # numpy leaves placed by shardings= come back as tensors on that device
    state, _ = checkpoint.restore(tmp_path, step, {"centroids": model.centroids_.numpy()},
                                  shardings={"centroids": cpu}, device="cpu")
    assert torch.equal(state["centroids"], model.centroids_)


def test_checkpoint_dir_warns_where_the_reference_warns():
    x = points(512)
    for engine in ("incore", "streaming"):
        with pytest.warns(UserWarning) as got:
            repro_torch.BWKM(k=3, device="cpu", engine=engine, max_iters=1,
                             checkpoint_dir="unused").fit(x)
        with pytest.warns(UserWarning) as want:  # the reference's own message
            jengines._warn_dropped(engine, checkpoint_dir="unused")
        assert [str(w.message) for w in got] == [str(w.message) for w in want]
    with pytest.warns(UserWarning, match="trace_centroids"):
        repro_torch.BWKM(k=3, device="cpu", engine="distributed", max_iters=1, trace=True).fit(x)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        repro_torch.BWKM(k=3, device="cpu", engine="distributed", max_iters=1).fit(x)


def test_mesh_context_and_shard_loss_mask_are_the_references():
    assert sh.current_mesh() is None and sh.axis_size("data") == 1 and sh.batch_axes() == ()
    assert dist_bwkm.n_data_shards() == jdist.n_data_shards() == 1
    with pytest.raises(ValueError, match="one dimension named 'data'"):
        with sh.use_mesh(type("Mesh", (), {"mesh_dim_names": ("pod", "data")})()):
            pass
    for n, s, lost in ((4000, 4, [2]), (12, 3, [0, 2]), (8, 2, [])):
        np.testing.assert_array_equal(shard_loss_rows_mask(n, s, lost),
                                      jfaults.shard_loss_rows_mask(n, s, lost))
    for bad in ((10, 4, [1]), (8, 4, [4])):
        with pytest.raises(ValueError):
            shard_loss_rows_mask(*bad)
    assert sharded._block(10, 4, 0) == (0, 3) and sharded._block(10, 4, 3) == (8, 10)
