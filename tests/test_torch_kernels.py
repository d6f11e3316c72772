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


MSD_CASES = [  # (n, d, L, first fold, wmode): L == 1, L over several 32-wide tiles
    # and not a multiple of one, invalid candidates, half the weights zero, n % 128 != 0
    (70, 10, 1, True, "uniform"),
    (150, 19, 112, True, "zeros-some"),
    (33, 7, 40, False, "zeros-some"),
]


def _fold_inputs(n, d, l, first, seed):
    rng = np.random.RandomState(seed)
    cand = (rng.randn(l, d) * 3).astype(np.float32)
    cvalid = (rng.rand(l) > 0.3).astype(np.float32)
    cvalid[0] = 1.0
    mind2 = np.full(n, 3.0e38, np.float32) if first else (rng.rand(n) * 60).astype(np.float32)
    return cand, cvalid, mind2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,l,first,wmode", MSD_CASES)
def test_min_sqdist_update_matches_reference(n, d, l, first, wmode, dtype):
    x, w, _ = _data(n, d, 1, seed=n + l, wmode=wmode)
    cand, cvalid, mind2 = _fold_inputs(n, d, l, first, seed=l)
    jx, tx = _pair(x, dtype)
    jcand, tcand = _pair(cand, dtype)
    tol = TOL[dtype]
    r = jops.min_sqdist_update(jx, jnp.asarray(w), jcand, jnp.asarray(cvalid),
                               jnp.asarray(mind2), impl="ref")
    out = ops.min_sqdist_update(tx, torch.from_numpy(w), tcand, torch.from_numpy(cvalid),
                                torch.from_numpy(mind2))
    np.testing.assert_allclose(_np(out.mind2), np.asarray(r.mind2), **tol)
    np.testing.assert_allclose(float(out.cost), float(r.cost), rtol=max(tol["rtol"], 1e-5))
    assert float(out.n_dist) == float(r.n_dist) == float((w > 0).sum() * (cvalid > 0).sum())
    # the fold only lowers the state, and zero-weight rows update it too
    assert bool((out.mind2 <= torch.from_numpy(mind2)).all())
    assert bool((out.mind2[torch.from_numpy(w) == 0] < 3.0e38).all())


def test_min_sqdist_update_chunk_padding_is_inert():
    x, w, _ = _data(45, 6, 1, seed=5, wmode="uniform")
    cand, cvalid, mind2 = _fold_inputs(45, 6, 9, False, seed=6)
    args = [torch.from_numpy(a) for a in (x, w, cand, cvalid, mind2)]
    full = ops.min_sqdist_update(*args)
    chunk = ops.min_sqdist_update_chunk(*args, chunk_size=64)
    assert chunk.mind2.shape == (45,)
    assert torch.equal(chunk.mind2, full.mind2)
    torch.testing.assert_close(chunk.cost, full.cost, rtol=1e-6, atol=0.0)
    assert float(chunk.n_dist) == float(full.n_dist)
    r = jops.min_sqdist_update_chunk(*map(jnp.asarray, (x, w, cand, cvalid, mind2)),
                                     chunk_size=64, impl="ref")
    np.testing.assert_allclose(_np(chunk.mind2), np.asarray(r.mind2), **TOL["float32"])
    np.testing.assert_allclose(float(chunk.cost), float(r.cost), rtol=1e-5)
    assert float(chunk.n_dist) == float(r.n_dist)
    with pytest.raises(ValueError, match="exceeds chunk_size"):
        ops.min_sqdist_update_chunk(*args, chunk_size=16)


CS_CASES = [  # (n, d, K, wmode): K == 1, empty clusters (K > n), zero weights, ragged n
    (64, 5, 1, "ones"),
    (70, 19, 27, "zeros-some"),
    (300, 19, 900, "uniform"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k,wmode", CS_CASES)
def test_cluster_sums_matches_reference(n, d, k, wmode, dtype):
    x, w, _ = _data(n, d, 1, seed=n + k, wmode=wmode)
    assign = np.random.RandomState(k).randint(0, k, n).astype(np.int32)
    jx, tx = _pair(x, dtype)
    tol = TOL[dtype]
    rs, rc = jops.cluster_sums(jx, jnp.asarray(w), jnp.asarray(assign), k, impl="ref")
    sums, counts = ops.cluster_sums(tx, torch.from_numpy(w), torch.from_numpy(assign), k)
    assert sums.shape == (k, d) and counts.shape == (k,)
    np.testing.assert_allclose(_np(sums), np.asarray(rs), **tol)
    np.testing.assert_allclose(_np(counts), np.asarray(rc), **tol)


def test_two_pass_regime_matches_reference_and_pruned_equals_dense():
    """K·(d+1) = 18,000 > 16,384: B1, then B4, on the CPU through the plain
    versions, as the reference's two-pass fallback."""
    from repro_torch.kernels.fused_assign_update import fused_supported

    n, d, k = 300, 19, 900
    assert not fused_supported(d, k)
    x, w, c = _data(n, d, k, seed=9, wmode="zeros-some")
    jx, jw, jc = map(jnp.asarray, (x, w, c))
    tx, tw, tc = map(torch.from_numpy, (x, w, c))
    tol = TOL["float32"]
    r = jops.assign_update(jx, jw, jc, impl="ref")
    dense = ops.assign_update(tx, tw, tc)
    _assert_labels(x, c, _np(dense.assign), tol)
    for f in ("d1", "d2", "sums", "counts"):
        np.testing.assert_allclose(_np(getattr(dense, f)), np.asarray(getattr(r, f)), **tol)
    np.testing.assert_allclose(float(dense.err), float(r.err), rtol=1e-5)
    assert float(dense.n_dist) == float(r.n_dist)
    rng = np.random.RandomState(4)
    cached = rng.randint(0, k, n).astype(np.int32)
    for frac in (0.0, 0.1, 1.0):
        active = rng.rand(n) < frac
        rp = jops.assign_update_pruned(jx, jw, jc, jnp.asarray(cached), jnp.asarray(active),
                                       impl="ref")
        p = ops.assign_update_pruned(tx, tw, tc, torch.from_numpy(cached), torch.from_numpy(active))
        np.testing.assert_array_equal(_np(p.assign)[~active], cached[~active])
        for f in ("sums", "counts"):
            np.testing.assert_allclose(_np(getattr(p, f)), np.asarray(getattr(rp, f)), **tol)
        np.testing.assert_allclose(float(p.err), float(rp.err), rtol=1e-5, atol=1e-6)
        assert float(p.n_dist) == float(rp.n_dist)
        # pruned ≡ dense bit for bit when the assignments agree
        same = ops.assign_update_pruned(tx, tw, tc, dense.assign, torch.from_numpy(active))
        assert torch.equal(same.assign, dense.assign)
        assert torch.equal(same.sums, dense.sums) and torch.equal(same.counts, dense.counts)


def test_interpret_mode_b4_b5_kernels_agree_with_the_port():
    """One small case each against the reference's Pallas kernels."""
    from repro.kernels.cluster_update import cluster_sums_pallas

    tol = TOL["float32"]
    x, w, _ = _data(40, 5, 1, seed=22, wmode="zeros-some")
    cand, cvalid, mind2 = _fold_inputs(40, 5, 9, True, seed=23)
    out = ops.min_sqdist_update(*map(torch.from_numpy, (x, w, cand, cvalid, mind2)))
    r = jops.min_sqdist_update(*map(jnp.asarray, (x, w, cand, cvalid, mind2)), impl="pallas")
    np.testing.assert_allclose(_np(out.mind2), np.asarray(r.mind2), **tol)
    np.testing.assert_allclose(float(out.cost), float(r.cost), rtol=1e-5)
    assign = np.random.RandomState(24).randint(0, 6, 40).astype(np.int32)
    got = ops.cluster_sums(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(assign), 6)
    want = cluster_sums_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(assign), 6,
                               interpret=True)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), **tol)


def test_fused_limit_names_the_missing_two_pass_kernel():
    from repro_torch.kernels import fused_assign_update as fau

    assert fau.fused_supported(19, 27) and fau.fused_supported(19, 300)
    assert not fau.fused_supported(8191, 3)
    fau.check_fused(19, 27)
    with pytest.raises(ValueError, match="B4 cluster_sums"):
        fau.check_fused(8191, 3)


def test_fused_scratch_does_not_grow_with_n():
    """B2/B3's scratch is one ``K·(d+1) + 1`` partial per fold CTA, at most
    128 CTAs of 256-row tiles, whatever n is."""
    from repro_torch.kernels.fused_assign_update import fused_scratch_floats

    per_cta = 561 * 20 + 1
    assert fused_scratch_floats(5_000_000, 19, 561) == 128 * per_cta
    assert fused_scratch_floats(128 * 256, 19, 561) == 128 * per_cta
    assert fused_scratch_floats(50_000_000, 19, 561) == 128 * per_cta
    assert fused_scratch_floats(127 * 256, 19, 561) == 127 * per_cta
    assert fused_scratch_floats(1, 19, 27) == 27 * 20 + 1
    assert fused_scratch_floats(0, 19, 27) == 0
    assert 4 * fused_scratch_floats(5_000_000, 19, 561) < 6e6  # 5.7 MB, from 1.75 GB


def test_seams_take_the_plain_path_only_for_cpu_tensors():
    from repro_torch.kernels import cluster_update, distance_assign, fused_assign_update as fau
    from repro_torch.kernels import min_sqdist_update as msu

    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        distance_assign.assign_top2_cuda(x, x[:2])
    with pytest.raises(ValueError, match="CUDA"):
        fau.fused_assign_update_cuda(x, torch.ones(4), x[:2])
    with pytest.raises(ValueError, match="CUDA"):
        cluster_update.cluster_sums_cuda(x, torch.ones(4), torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA"):
        msu.min_sqdist_update_cuda(x, torch.ones(4), x[:2], torch.ones(2), torch.ones(4))
    with pytest.raises(ValueError, match="operands on"):
        ops.assign_top2(x, x[:2].to("meta"))


# Past both widths the port's kernels once refused: the scan's four resident
# candidates (d > 14,432) and B4's shared partial (d + 1 > 40,960). On the CPU
# each seam takes its plain version; tests/test_torch_cuda.py holds the
# kernels at these widths on the card.
WIDE_D = [14_433, 40_960]
WIDE_SEAMS = ["assign_top2", "assign_update", "assign_update_pruned", "cluster_sums",
              "min_sqdist_update"]


@pytest.mark.parametrize("seam", WIDE_SEAMS)
@pytest.mark.parametrize("d", WIDE_D)
def test_seams_take_rows_past_the_old_width_limits(d, seam):
    n, k = 48, 5
    x, w, c = _data(n, d, k, seed=d % 101, wmode="zeros-some")
    jx, jw, jc = map(jnp.asarray, (x, w, c))
    tx, tw, tc = map(torch.from_numpy, (x, w, c))
    tol = TOL["float32"]
    rng = np.random.RandomState(d % 103)
    if seam == "assign_top2":
        a, d1, d2 = ops.assign_top2(tx, tc)
        _, rd1, rd2 = jops.assign_top2(jx, jc, impl="ref")
        _assert_labels(x, c, _np(a), tol)
        np.testing.assert_allclose(_np(d1), np.asarray(rd1), **tol)
        np.testing.assert_allclose(_np(d2), np.asarray(rd2), **tol)
    elif seam == "assign_update":
        out = ops.assign_update(tx, tw, tc)
        r = jops.assign_update(jx, jw, jc, impl="ref")
        _assert_labels(x, c, _np(out.assign), tol)
        for f in ("d1", "d2", "sums", "counts"):
            np.testing.assert_allclose(_np(getattr(out, f)), np.asarray(getattr(r, f)), **tol)
        np.testing.assert_allclose(float(out.err), float(r.err), rtol=1e-5)
        assert float(out.n_dist) == float(r.n_dist)
    elif seam == "assign_update_pruned":
        cached = rng.randint(0, k, n).astype(np.int32)
        active = rng.rand(n) < 0.5
        out = ops.assign_update_pruned(tx, tw, tc, torch.from_numpy(cached),
                                       torch.from_numpy(active))
        r = jops.assign_update_pruned(jx, jw, jc, jnp.asarray(cached), jnp.asarray(active),
                                      impl="ref")
        np.testing.assert_array_equal(_np(out.assign)[~active], cached[~active])
        _assert_labels(x[active], c, _np(out.assign)[active], tol)
        for f in ("d1", "d2"):
            np.testing.assert_allclose(_np(getattr(out, f))[active],
                                       np.asarray(getattr(r, f))[active], **tol)
        for f in ("sums", "counts"):
            np.testing.assert_allclose(_np(getattr(out, f)), np.asarray(getattr(r, f)), **tol)
        np.testing.assert_allclose(float(out.err), float(r.err), rtol=1e-5)
        assert float(out.n_dist) == float(r.n_dist)
    elif seam == "cluster_sums":
        assign = rng.randint(0, k, n).astype(np.int32)
        sums, counts = ops.cluster_sums(tx, tw, torch.from_numpy(assign), k)
        rs, rc = jops.cluster_sums(jx, jw, jnp.asarray(assign), k, impl="ref")
        assert sums.shape == (k, d)
        np.testing.assert_allclose(_np(sums), np.asarray(rs), **tol)
        np.testing.assert_allclose(_np(counts), np.asarray(rc), **tol)
    else:
        cand, cvalid, mind2 = _fold_inputs(n, d, k, False, seed=d % 107)
        args = (x, w, cand, cvalid, mind2)
        out = ops.min_sqdist_update(*map(torch.from_numpy, args))
        r = jops.min_sqdist_update(*map(jnp.asarray, args), impl="ref")
        np.testing.assert_allclose(_np(out.mind2), np.asarray(r.mind2), **tol)
        np.testing.assert_allclose(float(out.cost), float(r.cost), rtol=1e-5)
        assert float(out.n_dist) == float(r.n_dist)


def test_predict_and_score_past_the_old_scan_width():
    """A model at d = 14,433, in chunks of 32 rows (the last one ragged):
    labels at the minimum distance, and ``score`` the sum of the minima."""
    from repro_torch import BWKM

    x, _, c = _data(70, 14_433, 4, seed=17)
    model = BWKM.from_centroids(c, device="cpu", chunk_size=32)
    labels = model.predict(x)
    dd = np.asarray(jref.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c)))
    assert labels.shape == (70,) and labels.dtype == torch.int32
    np.testing.assert_allclose(dd[np.arange(70), labels.numpy()], dd.min(1), **TOL["float32"])
    np.testing.assert_allclose(model.score(x), float(dd.min(1).astype(np.float64).sum()),
                               rtol=1e-5)
