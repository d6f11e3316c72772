"""The port's partition, misassignment and bounds held against the reference.

Both packages get the same numpy inputs. Min/max/compare results must be
exact: boxes, counts, split plans, routing, activation, the boundary draw
(through the test-only ``JaxKey``, so both take the same random numbers).
Sums (``psum``) and the misassignment ε agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bwkm import JaxKey

from repro.core import bounds as jbounds
from repro.core import init_partition as jinit
from repro.core import misassignment as jmis
from repro.core import partition as jpart
from repro_torch import convert
from repro_torch.core import bounds, init_partition
from repro_torch.core import misassignment as mis
from repro_torch.core import partition as part

EXACT = ("lo", "hi", "count", "active", "block_id", "n_blocks")


def _points(n=600, d=3, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * np.linspace(5.0, 1.0, d)).astype(np.float32)
    x[::9] *= 1e-3  # values near zero sort next to each other's signs
    return x


def _ref_partition(x, rounds=3, capacity=40, seed=0):
    """A multi-block reference partition grown with random splits."""
    p = jpart.create_partition(jnp.asarray(x), capacity)
    rng = np.random.RandomState(seed)
    for _ in range(rounds):
        p = jpart.split_blocks(p, jnp.asarray(x), jnp.asarray(rng.rand(capacity) < 0.6))
    return p


def _assert_partition(got, want):
    g = convert.partition_to_numpy(got)
    for f in EXACT:
        np.testing.assert_array_equal(g[f], np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(g["psum"], np.asarray(want.psum), rtol=1e-5, atol=1e-5)


def test_create_partition_and_block_stats_match_exactly():
    x = _points()
    _assert_partition(part.create_partition(torch.from_numpy(x), 16),
                      jpart.create_partition(jnp.asarray(x), 16))
    rng = np.random.RandomState(1)
    bid = rng.randint(0, 13, x.shape[0]).astype(np.int32)  # rows 13..19 empty
    got = part.block_stats(torch.from_numpy(x), torch.from_numpy(bid), 20)
    want = jpart.block_stats(jnp.asarray(x), jnp.asarray(bid), 20)
    for f in ("count", "lo", "hi"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got.psum.numpy(), np.asarray(want.psum), rtol=1e-5, atol=1e-5)


def test_block_stats_is_bit_identical_across_runs_and_row_orders():
    x = _points(n=5000, d=4, seed=3)
    bid = np.random.RandomState(2).randint(0, 50, 5000).astype(np.int32)
    a = part.block_stats(torch.from_numpy(x), torch.from_numpy(bid), 64)
    perm = np.random.RandomState(4).permutation(5000)
    b = part.block_stats(torch.from_numpy(x[perm]), torch.from_numpy(bid[perm]), 64)
    for u, v in zip(a, b):
        assert torch.equal(u, v)  # fixed-point sums do not depend on the order


def test_split_plan_route_and_apply_match_exactly():
    x = _points(seed=5)
    want_p = _ref_partition(x)
    p = convert.partition_from_numpy(want_p, device="cpu")
    chosen = np.random.RandomState(6).rand(40) < 0.5
    want = jpart.split_plan(want_p, jnp.asarray(chosen))
    got = part.split_plan(p, torch.from_numpy(chosen))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    want_bid = jpart.route_split(jnp.asarray(x), want_p.block_id, want)
    got_bid = part.route_split(torch.from_numpy(x), p.block_id, got)
    np.testing.assert_array_equal(got_bid.numpy(), np.asarray(want_bid))
    want_a = jpart.apply_split_plan(want_p._replace(block_id=want_bid), want)
    got_a = part.apply_split_plan(p._replace(block_id=got_bid), got)
    np.testing.assert_array_equal(got_a.active.numpy(), np.asarray(want_a.active))
    assert int(got_a.n_blocks) == int(want_a.n_blocks)
    _assert_partition(
        part.split_blocks(p, torch.from_numpy(x), torch.from_numpy(chosen)),
        jpart.split_blocks(want_p, jnp.asarray(x), jnp.asarray(chosen)),
    )


def test_representatives_diagonals_misassignment_and_gap_bound():
    x = _points(seed=7)
    want_p = _ref_partition(x, rounds=4, seed=8)
    p = convert.partition_from_numpy(want_p, device="cpu")
    reps, w = part.representatives(p)
    jreps, jw = jpart.representatives(want_p)
    np.testing.assert_allclose(reps.numpy(), np.asarray(jreps), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_allclose(
        part.diagonals(p).numpy(), np.asarray(jpart.diagonals(want_p)), rtol=1e-5, atol=1e-5
    )
    rng = np.random.RandomState(9)
    d1 = (rng.rand(40) * 4).astype(np.float32)
    d2 = d1 + (rng.rand(40) * 30).astype(np.float32)
    eps = mis.misassignment(p, torch.from_numpy(d1), torch.from_numpy(d2))
    jeps = jmis.misassignment(want_p, jnp.asarray(d1), jnp.asarray(d2))
    np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), rtol=1e-5, atol=1e-5)
    assert bool((eps > 0).any()) and bool((eps == 0).any())
    np.testing.assert_allclose(
        float(bounds.thm2_gap_bound(p, eps, torch.from_numpy(d1))),
        float(jbounds.thm2_gap_bound(want_p, jeps, jnp.asarray(d1))), rtol=1e-5,
    )
    # the reference takes sqrt(l² + ε²/n²) − l in f32, where the difference
    # cancels; the port's value is the exact one, within that rounding of it
    exact = (0.5 / 100) ** 2 / (np.sqrt(9.0 + (0.5 / 100) ** 2) + 3.0)
    assert bounds.displacement_threshold(3.0, 100, 0.5) == pytest.approx(exact, rel=1e-12)
    assert abs(jbounds.displacement_threshold(3.0, 100, 0.5) - exact) <= 4 * 3.0 * 2.0**-24


@pytest.mark.parametrize("num_draws", [0, 3, 40])
def test_boundary_draw_takes_the_reference_blocks(num_draws):
    eps = np.where(np.random.RandomState(10).rand(40) < 0.4, np.random.RandomState(11).rand(40), 0.0)
    eps = eps.astype(np.float32)
    key = jax.random.PRNGKey(12)
    got = mis.sample_boundary(JaxKey(key), torch.from_numpy(eps), num_draws)
    want = jmis.sample_boundary(key, jnp.asarray(eps), num_draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    none = mis.sample_boundary(JaxKey(key), torch.zeros(40), 5)
    assert not bool(none.any())


def test_initial_partition_follows_the_reference():
    x = _points(n=800, d=3, seed=13)
    key = jax.random.PRNGKey(14)
    kw = dict(m=24, m_prime=6, s=30, r=2, capacity=64)
    want = jinit.build_initial_partition(key, jnp.asarray(x), 3, **kw)
    got = init_partition.build_initial_partition(JaxKey(key), torch.from_numpy(x), 3, **kw)
    _assert_partition(got, want)
    assert init_partition.default_params(5_000_000, 27, 19) == jinit.default_params(5_000_000, 27, 19)
