"""The port's kernel seams held against the JAX reference on the same inputs.

Inputs are made with numpy from a seed and go through ``repro.kernels.ref``
/ ``repro.kernels.ops.*(impl="ref")`` (and, in one small case per kernel,
the reference's Pallas kernel in interpret mode) and through
``repro_torch.kernels.ops`` on the CPU, where each seam takes its plain
version. Tolerances are those of ``tests/test_kernels_properties.py``:
f32 1e-5, bf16 1e-3; labels are compared through the distance matrix so
legal fp ties do not flake. The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` (marker ``cuda``) and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-3, atol=1e-3)}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _data(n, d, k, seed=0, wmode="uniform"):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 3).astype(np.float32)
    c = (rng.randn(k, d) * 3).astype(np.float32)
    u = rng.rand(n).astype(np.float32)
    w = {"ones": np.ones(n, np.float32), "zeros-some": np.where(u < 0.5, 0.0, 1.5),
         "uniform": 3.0 * u}[wmode].astype(np.float32)
    return x, w, c


def _pair(a, dtype):
    """The same values as a jnp array and a CPU torch tensor."""
    return jnp.asarray(a).astype(_JDT[dtype]), torch.from_numpy(a).to(_TDT[dtype])


def _np(t):
    return t.detach().float().numpy() if t.dtype != torch.int32 else t.numpy()


def _assert_labels(x, c, labels, tol):
    dd = np.asarray(jref.pairwise_sqdist(x, c))
    n = dd.shape[0]
    np.testing.assert_allclose(dd[np.arange(n), labels], dd.min(axis=1), **tol)


CASES = [  # n % 128 != 0, K over several 32-wide tiles, K < one tile, K == 1, zero weights
    (70, 10, 40, "uniform"),
    (33, 7, 3, "uniform"),
    (64, 5, 1, "ones"),
    (128, 19, 27, "zeros-some"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k,wmode", CASES)
def test_assign_update_matches_reference(n, d, k, wmode, dtype):
    x, w, c = _data(n, d, k, seed=11, wmode=wmode)
    jx, tx = _pair(x, dtype)
    jc, tc = _pair(c, dtype)
    tol = TOL[dtype]
    r = jops.assign_update(jx, jnp.asarray(w), jc, impl="ref")
    out = ops.assign_update(tx, torch.from_numpy(w), tc)
    _assert_labels(jx, jc, _np(out.assign), tol)
    for f in ("d1", "d2", "sums", "counts"):
        np.testing.assert_allclose(_np(getattr(out, f)), np.asarray(getattr(r, f)), **tol)
    np.testing.assert_allclose(float(out.err), float(r.err), rtol=max(tol["rtol"], 1e-5))
    assert float(out.n_dist) == float(r.n_dist)
    # B1 on its own
    a, d1, d2 = ops.assign_top2(tx, tc)
    _assert_labels(jx, jc, _np(a), tol)
    ra, rd1, rd2 = jops.assign_top2(jx, jc, impl="ref")
    np.testing.assert_allclose(_np(d1), np.asarray(rd1), **tol)
    np.testing.assert_allclose(_np(d2), np.asarray(rd2), **tol)
    if k == 1:
        assert bool(torch.isinf(d2).all()) and bool(torch.isinf(out.d2).all())


@pytest.mark.parametrize("frac", [0.0, 0.4, 1.0])
def test_assign_update_pruned_matches_reference_and_dense(frac):
    x, w, c = _data(150, 19, 27, seed=3, wmode="zeros-some")
    rng = np.random.RandomState(4)
    cached = rng.randint(0, 27, 150).astype(np.int32)
    active = rng.rand(150) < frac
    r = jops.assign_update_pruned(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(c), jnp.asarray(cached),
        jnp.asarray(active), impl="ref",
    )
    tx, tw, tc = map(torch.from_numpy, (x, w, c))
    out = ops.assign_update_pruned(tx, tw, tc, torch.from_numpy(cached), torch.from_numpy(active))
    np.testing.assert_array_equal(_np(out.assign)[~active], cached[~active])
    if active.any():
        _assert_labels(x[active], c, _np(out.assign)[active], TOL["float32"])
        for f in ("d1", "d2"):
            np.testing.assert_allclose(
                _np(getattr(out, f))[active], np.asarray(getattr(r, f))[active], **TOL["float32"]
            )
    for f in ("sums", "counts"):
        np.testing.assert_allclose(_np(getattr(out, f)), np.asarray(getattr(r, f)), **TOL["float32"])
    np.testing.assert_allclose(float(out.err), float(r.err), rtol=1e-5, atol=1e-6)
    assert float(out.n_dist) == float(r.n_dist)
    # pruned ≡ dense bit for bit when the assignments agree
    dense = ops.assign_update(tx, tw, tc)
    same = ops.assign_update_pruned(tx, tw, tc, dense.assign, torch.from_numpy(active))
    assert torch.equal(same.assign, dense.assign)
    assert torch.equal(same.sums, dense.sums) and torch.equal(same.counts, dense.counts)


def test_zero_weight_rows_are_inert():
    x, w, c = _data(96, 6, 5, seed=8, wmode="zeros-some")
    tx, tw, tc = map(torch.from_numpy, (x, w, c))
    base = ops.assign_update(tx, tw, tc)
    moved = tx.clone()
    moved[tw == 0] += 1000.0  # far away, but weightless
    out = ops.assign_update(moved, tw, tc)
    assert torch.equal(out.counts, base.counts)
    torch.testing.assert_close(out.sums, base.sums, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(out.err, base.err)
    assert float(out.n_dist) == float((tw > 0).sum()) * 5


def test_chunk_seams_pad_and_slice_like_the_reference():
    x, _, c = _data(45, 4, 6, seed=2)
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    ra, rd1, rd2 = jops.assign_top2_chunk(jx, jc, chunk_size=64, impl="ref")
    a, d1, d2 = ops.assign_top2_chunk(tx, tc, chunk_size=64)
    assert a.shape == (45,) and d1.shape == (45,)
    np.testing.assert_array_equal(_np(a), np.asarray(ra))
    np.testing.assert_allclose(_np(d1), np.asarray(rd1), **TOL["float32"])
    np.testing.assert_allclose(_np(d2), np.asarray(rd2), **TOL["float32"])
    dd = ops.pairwise_sqdist_chunk(tx, tc, chunk_size=64)
    np.testing.assert_allclose(
        _np(dd), np.asarray(jops.pairwise_sqdist_chunk(jx, jc, chunk_size=64)), **TOL["float32"]
    )
    n, padded = ops._pad_to_chunk(tx, 64)
    assert n == 45 and padded.shape == (64, 4) and bool((padded[45:] == 0).all())
    with pytest.raises(ValueError, match="exceeds chunk_size"):
        ops.assign_top2_chunk(tx, tc, chunk_size=16)


def test_interpret_mode_pallas_kernels_agree_with_the_port():
    """One small case per kernel against the reference's Pallas kernels."""
    from repro.kernels.distance_assign import assign_top2_pallas
    from repro.kernels.fused_assign_update import (
        fused_assign_update_pallas,
        fused_assign_update_pruned_pallas,
    )

    x, w, c = _data(40, 5, 6, seed=21, wmode="zeros-some")
    jx, jw, jc = map(jnp.asarray, (x, w, c))
    tx, tw, tc = map(torch.from_numpy, (x, w, c))
    tol = TOL["float32"]
    got = ops.assign_top2(tx, tc)
    for g, r in zip(got, assign_top2_pallas(jx, jc, interpret=True)):
        np.testing.assert_allclose(_np(g), np.asarray(r), **tol)
    got = ops.assign_update(tx, tw, tc)
    for g, r in zip(got[:6], fused_assign_update_pallas(jx, jw, jc, interpret=True, bn=32, bk=16)):
        np.testing.assert_allclose(_np(g), np.asarray(r), **tol)
    active = np.arange(40) < 20  # row block 0 partly active, row block 1 skipped
    cached = np.asarray(got.assign.numpy())
    got = ops.assign_update_pruned(tx, tw, tc, torch.from_numpy(cached), torch.from_numpy(active))
    r = fused_assign_update_pruned_pallas(
        jx, jw, jc, jnp.asarray(cached), jnp.asarray(active), interpret=True, bn=32, bk=16
    )
    np.testing.assert_array_equal(_np(got.assign), np.asarray(r[0]))
    for j in (3, 4, 5):
        np.testing.assert_allclose(_np(got[j]), np.asarray(r[j]), **tol)
    np.testing.assert_allclose(_np(got.d1)[active], np.asarray(r[1])[active], **tol)


def test_fused_limit_names_the_missing_two_pass_kernel():
    from repro_torch.kernels import fused_assign_update as fau

    assert fau.fused_supported(19, 27) and fau.fused_supported(19, 300)
    assert not fau.fused_supported(8191, 3)
    fau.check_fused(19, 27)
    with pytest.raises(ValueError, match="B4 cluster_sums"):
        fau.check_fused(8191, 3)


def test_seams_take_the_plain_path_only_for_cpu_tensors():
    from repro_torch.kernels import distance_assign, fused_assign_update as fau

    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        distance_assign.assign_top2_cuda(x, x[:2])
    with pytest.raises(ValueError, match="CUDA"):
        fau.fused_assign_update_cuda(x, torch.ones(4), x[:2])
    with pytest.raises(ValueError, match="operands on"):
        ops.assign_top2(x, x[:2].to("meta"))
