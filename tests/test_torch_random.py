"""The port's production key: categorical draws over any number of
categories, and draws without replacement.

``torch.multinomial`` takes at most 2^24 categories; past that
``TorchKey.categorical`` draws by inverse CDF over a prefix sum in a fixed
order, as ``jax.random.categorical`` has no such limit. On the CPU, draws
over at most 2^24 categories stay ``torch.multinomial``'s, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_bwkm import JaxKey

from repro_torch import random as rnd
from repro_torch.scan import prefix_sum

LIMIT = 1 << 24


@pytest.mark.parametrize("n", [7, LIMIT])
@pytest.mark.parametrize("shape", [None, (5,), (2, 3)])
def test_draws_up_to_the_limit_are_multinomials(n, shape):
    logits = torch.from_numpy(np.random.RandomState(n % 97).randn(n).astype(np.float32))
    key = rnd.key(1234)
    num = 1 if shape is None else int(np.prod(shape))
    gen = torch.Generator().manual_seed(key.seed >> 1)
    want = torch.multinomial(torch.softmax(logits, -1), num, replacement=True, generator=gen)
    got = key.categorical(logits, shape)
    want = want[0] if shape is None else want.reshape(shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [None, (64,)])
def test_draws_past_the_limit(shape):
    n = LIMIT + 1
    got = rnd.key(3).categorical(torch.zeros(n), shape)
    assert got.shape == (() if shape is None else shape) and got.dtype == torch.int64
    assert 0 <= int(got.min()) and int(got.max()) < n
    one_hot = torch.full((n,), float("-inf"))
    one_hot[LIMIT] = 0.0
    assert (rnd.key(4).categorical(one_hot, shape) == LIMIT).all()


def test_inverse_cdf_draw_follows_its_distribution(monkeypatch):
    monkeypatch.setattr(rnd, "_MULTINOMIAL_MAX", 4)  # take the inverse-CDF path at n = 10
    p = np.array([0.1, 0, 0.3, 0, 0, 0.2, 0.05, 0.35, 0, 0], np.float64)
    logits = torch.from_numpy(np.log(np.where(p > 0, p, 1e-300)).astype(np.float32))
    logits[p == 0] = float("-inf")
    draws = rnd.key(9).categorical(logits, (200_000,)).numpy()
    freq = np.bincount(draws, minlength=10) / draws.size
    assert (freq[p == 0] == 0).all()
    np.testing.assert_allclose(freq, p, atol=0.005)
    assert torch.equal(rnd.key(9).categorical(logits, (200_000,)), torch.from_numpy(draws))


@pytest.mark.parametrize("n", [1, 5, 1024, 1025, 3000, 1024 * 1024 + 7])
def test_prefix_sum_is_the_cumulative_sum(n):
    p = torch.from_numpy(np.random.RandomState(n).rand(3, n))
    want = np.cumsum(p.numpy(), axis=-1)
    got = prefix_sum(p[0])
    assert got.shape == (n,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want[0], rtol=1e-12)
    np.testing.assert_allclose(prefix_sum(p, width=4).numpy(), want, rtol=1e-12)


def test_choice_draws_distinct_indices_like_the_reference():
    got = rnd.choice(rnd.key(5), 1000, (40,), device="cpu")
    assert got.shape == (40,) and len(set(got.tolist())) == 40
    assert 0 <= int(got.min()) and int(got.max()) < 1000
    assert torch.equal(got, rnd.choice(rnd.key(5), 1000, (40,), device="cpu"))
    assert not torch.equal(got, rnd.choice(rnd.key(6), 1000, (40,), device="cpu"))
    with pytest.raises(ValueError, match="distinct"):
        rnd.choice(rnd.key(5), 3, (4,), device="cpu")
    key = jax.random.PRNGKey(2)
    want = jax.random.choice(key, 1000, shape=(40,), replace=False)
    np.testing.assert_array_equal(rnd.choice(JaxKey(key), 1000, (40,), device="cpu").numpy(),
                                  np.asarray(want))
