"""The CUDA kernels B1–B5 against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU, since a CUDA kernel
has no CPU mode. The file imports neither JAX nor the reference package, so
it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=1e-3, atol=1e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import distance_assign, fused_assign_update

    return distance_assign, fused_assign_update


def _data(n, d, k, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(n, d) * 3).astype(np.float32)).to("cuda", dtype)
    c = torch.from_numpy((rng.randn(k, d) * 3).astype(np.float32)).to("cuda", dtype)
    w = torch.from_numpy(np.where(rng.rand(n) < 0.5, 0.0, 1.5).astype(np.float32)).cuda()
    return x, w, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", [(1000, 19, 27), (777, 19, 1), (300, 40, 70)])
def test_kernels_match_plain_versions(cuda, n, d, k, dtype):
    da, fau = cuda
    x, w, c = _data(n, d, k, dtype, seed=n + k)
    tol = TOL[dtype]
    _, d1, d2 = da.assign_top2_cuda(x, c)
    _, rd1, rd2 = ref.assign_top2(x, c)
    torch.testing.assert_close(d1, rd1, **tol)
    torch.testing.assert_close(d2, rd2, **tol)
    if k == 1:
        assert bool(torch.isinf(d2).all())
    dd = ref.pairwise_sqdist(x, c)
    out = fau.fused_assign_update_cuda(x, w, c)
    torch.testing.assert_close(dd.gather(1, out[0].long()[:, None])[:, 0], dd.min(1).values, **tol)
    r = ref.assign_update(x, w, c)
    torch.testing.assert_close(out[1], r.d1, **tol)
    torch.testing.assert_close(out[2], r.d2, **tol)
    # statistics under the kernel's own labels, so a legal near-tie cannot move a row
    sums, counts = ref.cluster_sums(x, w, out[0], k)
    torch.testing.assert_close(out[3], sums, rtol=tol["rtol"], atol=tol["atol"] * 100)
    torch.testing.assert_close(out[4], counts, **tol)
    torch.testing.assert_close(out[5], (w * out[1]).sum(), rtol=tol["rtol"], atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [561, 2001])
def test_assign_with_parked_candidates_matches_plain_version(cuda, k, dtype):
    """The k-means|| weighting pass's widths, with about half the candidates
    parked at 1e15 as its unfilled slots are: no row goes to a parked one."""
    da, fau = cuda
    x, w, c = _data(3000, 19, k, dtype, seed=k)
    parked = torch.from_numpy(np.random.RandomState(k).rand(k) < 0.5).cuda()
    parked[0] = False
    c[parked] = 1.0e15
    tol = TOL[dtype]
    a, d1, d2 = da.assign_top2_cuda(x, c)
    _, rd1, rd2 = ref.assign_top2(x, c)
    assert not bool(parked[a.long()].any())
    torch.testing.assert_close(d1, rd1, **tol)
    torch.testing.assert_close(d2, rd2, **tol)
    if fau.fused_supported(19, k):
        out = fau.fused_assign_update_cuda(x, w, c)
        assert not bool(parked[out[0].long()].any())
        torch.testing.assert_close(out[1], rd1, **tol)
        assert float(out[4][parked].abs().sum()) == 0.0


@pytest.mark.cuda
def test_pruned_statistics_are_bit_identical_to_dense(cuda):
    _, fau = cuda
    x, w, c = _data(5000, 19, 27, torch.float32, seed=1)
    dense = fau.fused_assign_update_cuda(x, w, c)
    for frac in (0.0, 0.3, 1.0):
        act = torch.rand(5000, device="cuda") < frac
        p = fau.fused_assign_update_pruned_cuda(x, w, c, dense[0], act)
        assert torch.equal(p[0], dense[0])
        assert torch.equal(p[3], dense[3]) and torch.equal(p[4], dense[4])
    again = fau.fused_assign_update_cuda(x, w, c)
    assert all(torch.equal(a, b) for a, b in zip(dense, again))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [561, 800])
def test_fused_pass_over_many_fold_tiles_matches_plain_version(cuda, k):
    """The k-means|| weighting pass's width (561) and the widest K the fused
    seam takes at d = 19 (800: K·(d+1) = 16,000), over more than 128·256
    rows, so every fold CTA adds two or more 256-row tiles."""
    _, fau = cuda
    n = 70_001
    x, w, c = _data(n, 19, k, torch.float32, seed=k + 1)
    tol = TOL[torch.float32]
    out = fau.fused_assign_update_cuda(x, w, c)
    dd = ref.pairwise_sqdist(x, c)
    torch.testing.assert_close(dd.gather(1, out[0].long()[:, None])[:, 0], dd.min(1).values, **tol)
    r = ref.assign_update(x, w, c)
    torch.testing.assert_close(out[1], r.d1, **tol)
    # statistics under the kernel's own labels, within TOL of Σ|terms|
    sums, counts = ref.cluster_sums(x, w, out[0], k)
    scale, cscale = ref.cluster_sums(x.abs(), w, out[0], k)
    assert bool(((out[3] - sums).abs() <= tol["atol"] + tol["rtol"] * scale).all())
    assert bool(((out[4] - counts).abs() <= tol["atol"] + tol["rtol"] * cscale).all())
    torch.testing.assert_close(out[5], (w * out[1]).sum(), rtol=tol["rtol"], atol=0.0)
    again = fau.fused_assign_update_cuda(x, w, c)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    for frac in (0.0, 0.1, 1.0):
        act = torch.from_numpy(np.random.RandomState(3).rand(n) < frac).cuda()
        p = fau.fused_assign_update_pruned_cuda(x, w, c, out[0], act)
        assert torch.equal(p[0], out[0])
        assert torch.equal(p[3], out[3]) and torch.equal(p[4], out[4])
        torch.testing.assert_close(p[5], (w * out[1])[act].sum(), rtol=tol["rtol"], atol=1e-6)


@pytest.fixture
def cuda_b45():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import cluster_update, min_sqdist_update

    return cluster_update, min_sqdist_update


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,l,first", [(1000, 19, 1, True), (777, 19, 112, False),
                                          (300, 40, 70, True)])
def test_min_sqdist_update_matches_plain_version(cuda_b45, n, d, l, first, dtype):
    _, msu = cuda_b45
    x, w, cand = _data(n, d, l, dtype, seed=n + l)
    rng = np.random.RandomState(l)
    cvalid = torch.from_numpy((rng.rand(l) > 0.3).astype(np.float32)).cuda()
    cvalid[0] = 1.0
    mind2 = (torch.full((n,), 3.0e38) if first else torch.rand(n) * 60).cuda()
    tol = TOL[dtype]
    new, cost = msu.min_sqdist_update_cuda(x, w, cand, cvalid, mind2)
    r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
    torch.testing.assert_close(new, r.mind2, **tol)
    torch.testing.assert_close(cost, r.cost, rtol=tol["rtol"], atol=0.0)
    again = msu.min_sqdist_update_cuda(x, w, cand, cvalid, mind2)
    assert torch.equal(again[0], new) and torch.equal(again[1], cost)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", [(777, 19, 1), (1000, 19, 27), (3000, 19, 2001), (300, 40, 70)])
def test_cluster_sums_matches_plain_version(cuda_b45, n, d, k, dtype):
    cu, _ = cuda_b45
    x, w, _ = _data(n, d, 1, dtype, seed=n + k)
    assign = torch.randint(0, k, (n,), device="cuda", dtype=torch.int32)
    sums, counts = cu.cluster_sums_cuda(x, w, assign, k)
    rs, rc = ref.cluster_sums(x, w, assign, k)
    scale, _ = ref.cluster_sums(x.float().abs(), w, assign, k)  # Σ|w·x|: the rounding's scale
    assert bool(((sums - rs).abs() <= TOL[dtype]["atol"] + TOL[dtype]["rtol"] * scale).all())
    torch.testing.assert_close(counts, rc, **TOL[dtype])
    again = cu.cluster_sums_cuda(x, w, assign, k)
    assert torch.equal(again[0], sums) and torch.equal(again[1], counts)


@pytest.mark.cuda
def test_two_pass_pruned_statistics_are_bit_identical_to_dense(cuda_b45):
    from repro_torch.kernels import ops

    x, w, c = _data(5000, 19, 900, torch.float32, seed=2)  # K·(d+1) = 18,000: two-pass
    dense = ops.assign_update(x, w, c)
    for frac in (0.0, 0.1, 1.0):
        act = torch.rand(5000, device="cuda") < frac
        p = ops.assign_update_pruned(x, w, c, dense.assign, act)
        assert torch.equal(p.assign, dense.assign)
        assert torch.equal(p.sums, dense.sums) and torch.equal(p.counts, dense.counts)


# The shared scan of B1–B3 and B5 (csrc/top2.cuh): candidates resident in
# shared memory (walked in chunks beyond its budget), rows blocked in
# registers (four a thread from 131,072 rows on), x tiles copied
# asynchronously over their enclosing 16-byte-aligned span, and B5 loading
# only its valid candidates.


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,k", [(3000, 19, 4000), (150_001, 19, 4000), (2000, 128, 561), (600, 300, 400)]
)
def test_scan_walks_candidates_beyond_shared_memory_in_chunks(cuda, cuda_b45, n, d, k):
    """K past the resident budget, with one row a thread and (n = 150,001)
    four; at d = 300 the x tile is too wide to stage as well, so rows are
    read from global memory."""
    da, _ = cuda
    _, msu = cuda_b45
    x, w, c = _data(n, d, k, torch.float32, seed=k)
    tol = TOL[torch.float32]
    a, d1, d2 = da.assign_top2_cuda(x, c)
    dd = ref.pairwise_sqdist(x, c)
    torch.testing.assert_close(dd.gather(1, a.long()[:, None])[:, 0], dd.min(1).values, **tol)
    _, rd1, rd2 = ref.assign_top2(x, c)
    torch.testing.assert_close(d1, rd1, **tol)
    torch.testing.assert_close(d2, rd2, **tol)
    cvalid = torch.from_numpy((np.random.RandomState(k).rand(k) < 0.7).astype(np.float32)).cuda()
    mind2 = torch.full((n,), 3.0e38, device="cuda")
    new, cost = msu.min_sqdist_update_cuda(x, w, c, cvalid, mind2)
    r = ref.min_sqdist_update(x, w, c, cvalid, mind2)
    torch.testing.assert_close(new, r.mind2, **tol)
    torch.testing.assert_close(cost, r.cost, rtol=tol["rtol"], atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 150_001])
def test_fold_over_valid_candidates_only_is_bit_exact(cuda_b45, n):
    """B5 compacts its valid candidates: the fold equals, bit for bit, the
    fold over ``cand[valid]`` with every slot valid, and with no valid
    candidate ``mind2`` passes through unchanged."""
    _, msu = cuda_b45
    x, w, cand = _data(n, 19, 400, torch.float32, seed=n)
    rng = np.random.RandomState(n)
    cvalid = torch.from_numpy((rng.rand(400) < 0.5).astype(np.float32)).cuda()
    mind2 = torch.from_numpy((rng.rand(n) * 300).astype(np.float32)).cuda()
    new, cost = msu.min_sqdist_update_cuda(x, w, cand, cvalid, mind2)
    sub = cand[cvalid > 0].contiguous()
    only = msu.min_sqdist_update_cuda(x, w, sub, torch.ones(sub.shape[0], device="cuda"), mind2)
    assert torch.equal(only[0], new) and torch.equal(only[1], cost)
    r = ref.min_sqdist_update(x, w, cand, cvalid, mind2)
    torch.testing.assert_close(new, r.mind2, **TOL[torch.float32])
    torch.testing.assert_close(cost, r.cost, rtol=1e-5, atol=0.0)
    none = msu.min_sqdist_update_cuda(x, w, cand, torch.zeros_like(cvalid), mind2)
    assert torch.equal(none[0], mind2)
    torch.testing.assert_close(none[1], (w * mind2).sum(), rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 150_001])
def test_duplicate_centroids_go_to_the_smallest_id(cuda, n):
    da, fau = cuda
    x, w, c = _data(n, 19, 27, torch.float32, seed=n + 1)
    c[7] = c[3]
    c[20] = c[3]
    for a, d1, d2 in (da.assign_top2_cuda(x, c), fau.fused_assign_update_cuda(x, w, c)[:3]):
        on = (a == 3) | (a == 7) | (a == 20)
        assert bool(on.any()) and bool((a[on] == 3).all())
        assert torch.equal(d2[on], d1[on])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(1001, 1), (1001, 27), (150_001, 1), (150_001, 27)])
def test_scan_at_ragged_n_from_a_misaligned_view(cuda, cuda_b45, n, k, dtype):
    """n not a multiple of the row tile, K = 1 (d2 = +inf), and x a view one
    row into its storage, so its base is not 16-byte aligned: the kernels
    give the bits they give on an aligned copy."""
    da, fau = cuda
    _, msu = cuda_b45
    base, wb, c = _data(n + 1, 19, k, dtype, seed=n + k)
    x, w = base[1:], wb[1:]
    assert x.data_ptr() % 16 != 0
    xc = x.clone()
    out = da.assign_top2_cuda(x, c)
    assert all(torch.equal(u, v) for u, v in zip(out, da.assign_top2_cuda(xc, c)))
    _, rd1, rd2 = ref.assign_top2(xc, c)
    torch.testing.assert_close(out[1], rd1, **TOL[dtype])
    torch.testing.assert_close(out[2], rd2, **TOL[dtype])
    if k == 1:
        assert bool(torch.isinf(out[2]).all())
    f = fau.fused_assign_update_cuda(x, w, c)
    assert all(torch.equal(u, v) for u, v in zip(f, fau.fused_assign_update_cuda(xc, w, c)))
    assert torch.equal(f[0], out[0]) and torch.equal(f[1], out[1])
    mind2 = torch.full((n,), 3.0e38, device="cuda")
    ones = torch.ones(k, device="cuda")
    fold = msu.min_sqdist_update_cuda(x, w, c, ones, mind2)
    assert all(torch.equal(u, v) for u, v in zip(fold, msu.min_sqdist_update_cuda(xc, w, c, ones, mind2)))
    assert torch.equal(fold[0], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [14_432, 14_433, 41_000])
def test_kernels_take_rows_of_any_width(cuda, cuda_b45, d):
    """At d = 14,432 four candidates still stay resident in the scan; from
    14,433 on B1 and B5 take the scan's wide-row form, and at 41,000 B4's
    fold tiles its columns (d + 1 > 40,960). B2 and B3 run at K = 1 past the
    scan's old limit: their fused partial, K·(d + 1) <= 16,384, stays."""
    da, fau = cuda
    cu, msu = cuda_b45
    tol = TOL[torch.float32]
    n, k = 300, 5
    x, w, c = _data(n, d, k, torch.float32, seed=d % 1009)
    a, d1, d2 = da.assign_top2_cuda(x, c)
    dd = ref.pairwise_sqdist(x, c)
    torch.testing.assert_close(dd.gather(1, a.long()[:, None])[:, 0], dd.min(1).values, **tol)
    _, rd1, rd2 = ref.assign_top2(x, c)
    torch.testing.assert_close(d1, rd1, **tol)
    torch.testing.assert_close(d2, rd2, **tol)
    rng = np.random.RandomState(d % 1013)
    ids = torch.from_numpy(rng.randint(0, k, n).astype(np.int32)).cuda()
    sums, counts = cu.cluster_sums_cuda(x, w, ids, k)
    rs, rc = ref.cluster_sums(x, w, ids, k)
    scale, _ = ref.cluster_sums(x.abs(), w, ids, k)
    assert bool(((sums - rs).abs() <= tol["atol"] + tol["rtol"] * scale).all())
    torch.testing.assert_close(counts, rc, **tol)
    cvalid = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0], device="cuda")
    mind2 = torch.from_numpy((rng.rand(n) * 1e6).astype(np.float32)).cuda()
    new, cost = msu.min_sqdist_update_cuda(x, w, c, cvalid, mind2)
    r = ref.min_sqdist_update(x, w, c, cvalid, mind2)
    torch.testing.assert_close(new, r.mind2, **tol)
    torch.testing.assert_close(cost, r.cost, rtol=tol["rtol"], atol=0.0)
    if d != 14_433:
        return
    c1 = c[:1].contiguous()
    out = fau.fused_assign_update_cuda(x, w, c1)
    r = ref.assign_update(x, w, c1)
    assert bool((out[0] == 0).all()) and bool(torch.isinf(out[2]).all())
    torch.testing.assert_close(out[1], r.d1, **tol)
    scale, _ = ref.cluster_sums(x.abs(), w, out[0], 1)
    assert bool(((out[3] - r.sums).abs() <= tol["atol"] + tol["rtol"] * scale).all())
    torch.testing.assert_close(out[4], r.counts, **tol)
    torch.testing.assert_close(out[5], r.err, rtol=tol["rtol"], atol=0.0)
    act = torch.from_numpy(rng.rand(n) < 0.5).cuda()
    p = fau.fused_assign_update_pruned_cuda(x, w, c1, out[0], act)
    assert torch.equal(p[0], out[0])
    assert torch.equal(p[3], out[3]) and torch.equal(p[4], out[4])
    torch.testing.assert_close(p[1][act], out[1][act], **tol)
    torch.testing.assert_close(p[5], (w * out[1])[act].sum(), rtol=tol["rtol"], atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [19, 300])
def test_fold_tiling_leaves_the_bits_as_they_are(cuda_b45, d, dtype):
    """A smaller shared partial (the private ``_part_floats``) tiles B4's
    clusters and then its columns more finely; each element is still summed
    by one thread in row order, so the sums and counts keep their bits. More
    than 128·256 rows, so each fold CTA streams two or more tiles, and ids
    outside [0, K) among them."""
    cu, _ = cuda_b45
    n, k = 70_001, 40
    x, w, _ = _data(n, d, 1, dtype, seed=d)
    ids = torch.from_numpy(np.random.RandomState(d).randint(-1, k + 1, n).astype(np.int32)).cuda()
    base = cu.cluster_sums_cuda(x, w, ids, k)
    for cap in (3 * (d + 1), d + 1, 40, 7):
        out = cu.cluster_sums_cuda(x, w, ids, k, _part_floats=cap)
        assert torch.equal(out[0], base[0]) and torch.equal(out[1], base[1]), cap


# ------------------------------------------------------------ streaming
class _CpuDrawKey:
    """The production key with every draw made on the CPU and moved to the
    device asked for, so a fit on the card and one on the CPU draw the same
    numbers (CPU and CUDA generators differ)."""

    def __init__(self, key):
        self.key = key

    def split(self, num):
        return tuple(_CpuDrawKey(k) for k in self.key.split(num))

    def fold_in(self, data):
        return _CpuDrawKey(self.key.fold_in(data))

    def randint(self, shape, minval, maxval, device):
        return self.key.randint(shape, minval, maxval, "cpu").to(device)

    def categorical(self, logits, shape=None):
        return self.key.categorical(logits.cpu(), shape).to(logits.device)

    def uniform(self, shape, device):
        return self.key.uniform(shape, "cpu").to(device)

    def gumbel(self, shape, device):
        return self.key.gumbel(shape, "cpu").to(device)

    def choice(self, n, shape, device):
        return self.key.choice(n, shape, "cpu").to(device)


def _separated(n, d, k, seed):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 30.0
    return (centers[rng.randint(0, k, n)] + 0.5 * rng.randn(n, d)).astype(np.float32)


@pytest.mark.cuda
def test_streaming_fit_on_the_card_is_the_fit_on_the_cpu(cuda):
    from repro_torch import random as rnd
    from repro_torch import streaming
    from repro_torch.core.bwkm import BWKMConfig
    from repro_torch.data.chunks import ArrayChunkSource

    x = _separated(20_000, 6, 5, seed=4)
    cfg = BWKMConfig(k=5, max_iters=8)
    fits = [
        streaming.fit_streaming(_CpuDrawKey(rnd.key(2)), ArrayChunkSource(x, 3000), cfg, device=dev)
        for dev in ("cuda", "cpu")
    ]
    gpu, cpu = fits
    assert gpu.stop_reason == cpu.stop_reason and gpu.iterations == cpu.iterations
    assert gpu.n_blocks == cpu.n_blocks
    assert gpu.stream.points_streamed == gpu.stream.passes * x.shape[0] == cpu.stream.points_streamed
    torch.testing.assert_close(gpu.centroids.cpu(), cpu.centroids, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_streaming_chunk_seams_match_plain_versions(cuda):
    from repro_torch.data.chunks import ArrayChunkSource, padded_device_chunks
    from repro_torch.kernels import ops

    x, w, c = _data(1000, 19, 27, torch.float32, seed=8)
    cs, n = 1024, 1000  # a ragged tail chunk
    tol = TOL[torch.float32]
    got = ops.assign_update_chunk(x, w, c, chunk_size=cs)
    r = ref.assign_update(x, w, c)
    dd = ref.pairwise_sqdist(x, c)
    assert got.assign.shape == (n,)
    torch.testing.assert_close(dd.gather(1, got.assign.long()[:, None])[:, 0], dd.min(1).values, **tol)
    torch.testing.assert_close(got.d1, r.d1, **tol)
    sums, counts = ref.cluster_sums(x, w, got.assign, 27)
    torch.testing.assert_close(got.sums, sums, rtol=tol["rtol"], atol=tol["atol"] * 100)
    torch.testing.assert_close(got.counts, counts, **tol)
    act = torch.from_numpy(np.random.RandomState(8).rand(n) < 0.3).cuda()
    pr = ops.assign_update_pruned_chunk(x, w, c, got.assign, act, chunk_size=cs)
    assert torch.equal(pr.assign, got.assign)
    assert torch.equal(pr.sums, got.sums) and torch.equal(pr.counts, got.counts)
    assert float(pr.n_dist) == float((act & (w > 0)).sum()) * 27
    xs = _separated(2500, 5, 3, seed=9)
    on_card = list(padded_device_chunks(ArrayChunkSource(xs, 1024), "cuda"))
    on_cpu = list(padded_device_chunks(ArrayChunkSource(xs, 1024), "cpu"))
    assert [nv for _, nv in on_card] == [nv for _, nv in on_cpu] == [1024, 1024, 452]
    for (a, _), (b, _) in zip(on_card, on_cpu):
        assert a.is_cuda and torch.equal(a.cpu(), b)


# ------------------------------------------------------------ the service
def _drifting_stream(n_chunks=8, rows=256, d=4, k=3):
    """The reference crash suite's drifting stream (centres jump halfway)."""
    rng = np.random.RandomState(11)
    centers = rng.randn(k, d).astype(np.float32) * 4.0
    chunks = []
    for i in range(n_chunks):
        c = centers + (2.5 if i >= n_chunks // 2 else 0.0)
        lab = rng.randint(0, k, rows)
        chunks.append((c[lab] + 0.3 * rng.randn(rows, d)).astype(np.float32))
    return np.concatenate(chunks)


def _service_config():
    from repro_torch.core.bwkm import BWKMConfig
    from repro_torch.service import ServiceConfig

    return ServiceConfig(base=BWKMConfig(k=3, max_iters=4, lloyd_max_iters=20), decay=0.9,
                         refit_boundary_frac=0.02, seed=5)


@pytest.mark.cuda
def test_service_on_the_card_is_the_service_on_the_cpu(cuda, monkeypatch):
    from repro_torch import random as rnd
    from repro_torch.data.chunks import ArrayChunkSource
    from repro_torch.service import BWKMSession, run_service
    from repro_torch.service import session as smod

    monkeypatch.setattr(smod, "_session_key", lambda seed: _CpuDrawKey(rnd.key(seed)))
    x = _drifting_stream()
    runs = {dev: run_service(BWKMSession(_service_config(), device=dev), ArrayChunkSource(x, 256))
            for dev in ("cuda", "cpu")}
    assert any(m["refit"] for m in runs["cpu"][1:])
    for g, c in zip(runs["cuda"], runs["cpu"]):
        assert (g["refit"], g["n_splits"], g["n_blocks"]) == (c["refit"], c["n_splits"], c["n_blocks"])
        assert abs(g["boundary_frac"] - c["boundary_frac"]) <= 1e-5
        assert abs(g["error"] - c["error"]) <= 1e-3 * abs(c["error"])


@pytest.mark.cuda
@pytest.mark.parametrize("crash_at", [1, 3, 6])
def test_service_resume_is_bit_identical_on_the_card(cuda, crash_at, tmp_path):
    from repro_torch.data.chunks import ArrayChunkSource
    from repro_torch.service import BWKMSession, resume_service, run_service
    from repro_torch.testing.faults import CrashingSource, InjectedCrash

    src = ArrayChunkSource(_drifting_stream(), 256)
    whole = BWKMSession(_service_config())
    want = run_service(whole, src)
    with pytest.raises(InjectedCrash):
        run_service(BWKMSession(_service_config()), CrashingSource(src, crash_at),
                    checkpoint_dir=str(tmp_path), checkpoint_every=2)
    resumed, got = resume_service(str(tmp_path), src, config=_service_config())
    assert got == want[(crash_at // 2) * 2 :]
    a, b = whole.state, resumed.state
    assert resumed.device.type == "cuda" and b.centroids.is_cuda
    for f in a.partition._fields:
        assert torch.equal(getattr(a.partition, f), getattr(b.partition, f)), f
    for f in ("centroids", "d1", "d2", "batches", "points"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.key.seed == b.key.seed


@pytest.mark.cuda
def test_batched_predictor_labels_are_assign_top2_on_the_card(cuda):
    import threading

    from repro_torch.kernels import ops
    from repro_torch.service import BatchedPredictor

    rng = np.random.RandomState(3)
    c = torch.from_numpy((rng.randn(27, 19) * 3).astype(np.float32)).cuda()
    reqs = [(rng.randn(s, 19) * 3).astype(np.float32) for s in rng.randint(1, 3000, 24)]
    predictor = BatchedPredictor(c, chunk_size=2048)
    tickets = [None] * len(reqs)

    def submit(j):
        for i in range(j, len(reqs), 4):
            tickets[i] = predictor.submit(reqs[i])

    threads = [threading.Thread(target=submit, args=(j,)) for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    launches = cuda[0].assign_top2_cuda.launches
    predictor.flush()
    total = sum(r.shape[0] for r in reqs)
    assert predictor.stats["n_kernel_calls"] == -(-total // 2048)
    assert cuda[0].assign_top2_cuda.launches - launches == -(-total // 2048)
    for r, t in zip(reqs, tickets):
        want = ops.assign_top2(torch.from_numpy(r).cuda(), c)[0].cpu().numpy()
        np.testing.assert_array_equal(t.result(timeout=0), want)


def _gmm(n=2000, d=4, k=5, seed=0):
    """The data of ``tests/test_torch_baselines.py``."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 8
    return (centers[rng.randint(0, k, n)] + rng.randn(n, d)).astype(np.float32)


def _baseline_cases():
    from repro_torch.core import baselines

    return {
        "forgy": lambda key, x: baselines.forgy_kmeans(key, x, 5),
        "kmeans++": lambda key, x: baselines.kmeanspp_kmeans(key, x, 5),
        "kmeans++_init": lambda key, x: baselines.kmeanspp_kmeans(key, x, 5, init_only=True),
        "kmc2": lambda key, x: baselines.kmc2_kmeans(key, x, 5, chain_length=20),
        "minibatch": lambda key, x: baselines.minibatch_kmeans(key, x, 5, batch=50, iters=30),
        "grid-rpkm": lambda key, x: baselines.grid_rpkm(key, x, 5, max_level=4),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["forgy", "kmeans++", "kmeans++_init", "kmc2", "minibatch",
                                  "grid-rpkm"])
def test_baselines_on_the_card_are_the_baselines_on_the_cpu(cuda, name):
    """Each baseline on the card against the same baseline on the CPU, with
    the draws made on the CPU, on the data, keys and tolerances of
    ``tests/test_torch_baselines.py``, where the port is held against the
    reference draw for draw. The two devices take the same decisions only
    away from f32 near-ties of the kernels' and the plain distances (on
    ``_separated(2000, 4, 5, seed=0)`` grid-RPKM meets one at level 4, where
    B1 and B2 agree with float64 and the plain version does not).
    Mini-batch and grid-RPKM also run twice on the card, bit-equal."""
    from repro_torch import random as rnd

    x = _gmm()
    fit = _baseline_cases()[name]
    key = {"minibatch": 4, "grid-rpkm": 5}.get(name, 3)
    want = fit(_CpuDrawKey(rnd.key(key)), torch.from_numpy(x))
    got = fit(_CpuDrawKey(rnd.key(key)), torch.from_numpy(x).cuda())
    assert got.centroids.is_cuda
    assert (got.engine, got.iterations, got.stop_reason, got.distances) == (
        want.engine, want.iterations, want.stop_reason, want.distances)
    tol = 1e-4 if name in ("minibatch", "grid-rpkm") else 1e-5
    torch.testing.assert_close(got.centroids.cpu(), want.centroids, rtol=tol, atol=tol)
    if name in ("minibatch", "grid-rpkm"):
        assert got.metadata == want.metadata
        again = fit(_CpuDrawKey(rnd.key(key)), torch.from_numpy(x).cuda())
        assert torch.equal(again.centroids, got.centroids)


@pytest.mark.cuda
def test_kmeans_error_on_the_card_is_the_error_on_the_cpu(cuda):
    from repro_torch.core import metrics

    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.randn(70_000, 4) * 3).astype(np.float32))
    c = x[:5].clone()
    got = metrics.kmeans_error(x.cuda(), c.cuda())
    assert got.is_cuda and got.dtype == torch.float32 and got.dim() == 0
    torch.testing.assert_close(got.cpu(), metrics.kmeans_error(x, c), rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5_000_000, (1 << 24) + 1])
def test_categorical_draws_repeat_on_the_card(cuda, n):
    """The same key draws the same numbers on the card: several draws take
    a prefix sum, whose 1-D CUDA form (``torch.cumsum``, and
    ``torch.multinomial``'s) varies its bits from run to run past about
    10^5 elements; the port's runs along rows."""
    from repro_torch import random as rnd

    logits = torch.rand(n, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    first = rnd.key(5).categorical(logits, shape=(100,))
    for _ in range(10):
        assert torch.equal(rnd.key(5).categorical(logits, shape=(100,)), first)
    from repro_torch.scan import prefix_sum

    p = logits.double()
    assert torch.equal(prefix_sum(p), prefix_sum(p))
    rows = p[: 19 * 100_000].view(19, -1)
    assert torch.equal(prefix_sum(rows), prefix_sum(rows))


# ------------------------------------------------------- launch plans and autotune
PLAN_N = (1, 127, 131_071, 131_072, 5_000_000)
PLAN_D = (1, 19, 20, 14_432, 14_433)
PLAN_K = (1, 27, 561, 2_001)


@pytest.fixture
def plans():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels' libraries build only beside one")
    from repro_torch.kernels import cluster_update, distance_assign
    from repro_torch.roofline import analysis

    return analysis, distance_assign, cluster_update


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_python_plans_are_the_kernels_plans(plans, dtype_bytes):
    """``roofline.analysis``'s plans against ``bwkm_scan_plan`` and
    ``bwkm_fold_plan`` over the grid of shapes, for the analytic plan and
    every candidate of every seam; plans the one refuses the other refuses."""
    from repro_torch.kernels import autotune

    analysis, da, cu = plans
    scan_keys = ("wide", "rows_per_thread", "bn", "xbytes", "smem_bytes", "scan_dx", "tiles")
    fold_keys = ("kt", "cw", "stages", "xstaged", "sbytes", "pbytes", "smem_bytes", "ctas", "tiles")
    checked = 0
    for n in PLAN_N:
        for d in PLAN_D:
            for k in PLAN_K:
                for seam in autotune.SEAMS:
                    tile = "bl" if seam == "min_sqdist_update" else "bk"
                    for cand in autotune.candidate_blockings(seam, d, k, n=n,
                                                             dtype_bytes=dtype_bytes):
                        got = da.kernel_scan_plan(n, d, k, dtype_bytes=dtype_bytes,
                                                  rows_per_thread=cand["rows_per_thread"],
                                                  kc=cand[tile])
                        assert got["bk"] == cand[tile], (seam, n, d, k, cand["knobs"])
                        for key in scan_keys:
                            assert got[key] == cand[key], (key, seam, n, d, k, cand["knobs"])
                        if "fold" in cand:
                            f = cand["fold"]
                            got = cu.kernel_fold_plan(
                                n, d, k, dtype_bytes=dtype_bytes, err=True,
                                act=seam == "assign_update_pruned", kt=f["kt"], cw=f["cw"],
                                stages=f["stages"])
                            for key in fold_keys:
                                assert got[key] == f[key], (key, seam, n, d, k, cand["knobs"])
                        checked += 1
                # the kernels' own choices (zeros) are the analytic plans
                ana = analysis.scan_plan(n, d, k, dtype_bytes=dtype_bytes)
                got = da.kernel_scan_plan(n, d, k, dtype_bytes=dtype_bytes)
                assert all(got[key] == ana[key] for key in scan_keys) and got["bk"] == ana["bk"]
                for err, act in ((True, False), (True, True), (False, False)):
                    ana = analysis.fold_plan(n, d, k, dtype_bytes=dtype_bytes, err=err, act=act)
                    got = cu.kernel_fold_plan(n, d, k, dtype_bytes=dtype_bytes, err=err, act=act)
                    assert all(got[key] == ana[key] for key in fold_keys), (n, d, k, err, act)
    assert checked > 1000
    # refused on both sides
    bad_scans = [dict(rows_per_thread=2), dict(kc=6), dict(kc=4096 * 4)]
    for kw in bad_scans:
        with pytest.raises(ValueError):
            analysis.scan_plan(200_000, 19, 2001, **kw)
        with pytest.raises(da.PlanError):
            da.kernel_scan_plan(200_000, 19, 2001, **kw)
    with pytest.raises(da.PlanError):
        da.kernel_scan_plan(1000, 40, 27, rows_per_thread=4)  # no R = 4 past d = 19
    for kw in (dict(stages=1), dict(stages=5), dict(kt=2001, cw=21), dict(kt=5, cw=0)):
        with pytest.raises(ValueError):
            analysis.fold_plan(5_000_000, 19, 2001, **kw)
        with pytest.raises(da.PlanError):
            cu.kernel_fold_plan(5_000_000, 19, 2001, **kw)


def _seam_outputs(seam, cand, x, w, c, cached, active):
    from repro_torch.kernels import distance_assign as da
    from repro_torch.kernels import fused_assign_update as fau
    from repro_torch.kernels import min_sqdist_update as msu

    if seam == "min_sqdist_update":
        valid = (torch.arange(c.shape[0], device="cuda") % 3 != 1).float()
        mind2 = torch.full((x.shape[0],), 3e38, device="cuda")
        return msu.min_sqdist_update_cuda(x, w, c, valid, mind2, plan=cand)
    if seam == "assign_update_pruned":
        return fau.fused_assign_update_pruned_cuda(x, w, c, cached, active, plan=cand)
    out = da.assign_top2_cuda(x, c, plan=cand)
    if fau.fused_supported(x.shape[1], c.shape[0]):
        out = out + fau.fused_assign_update_cuda(x, w, c, plan=cand)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", [(14_528, 19, 27), (200_000, 19, 561), (70_001, 19, 2001),
                                   (3_000, 40, 70), (300, 14_433, 1)])
def test_every_candidate_is_bit_equal_to_the_analytic_plan(cuda, n, d, k, dtype):
    """Each candidate plan of each seam gives the analytic plan's outputs bit
    for bit: ids, d1, d2, sums, counts, err (B1–B3), min-d² and φ (B5)."""
    from repro_torch.kernels import autotune

    x, w, c = _data(n, d, k, dtype, seed=n % 1000 + k)
    rng = np.random.RandomState(k)
    cached = torch.from_numpy(rng.randint(0, k, n).astype(np.int32)).cuda()
    active = torch.from_numpy(rng.rand(n) < 0.3).cuda()
    active[: 3 * 512] = False  # whole tiles with no active row skip the scan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for seam in autotune.SEAMS:
        if seam == "assign_update_pruned" and not cuda[1].fused_supported(d, k):
            continue
        cands = autotune.candidate_blockings(seam, d, k, n=n,
                                             dtype_bytes=x.element_size(), sms=sms)
        base = _seam_outputs(seam, cands[0], x, w, c, cached, active)
        assert len(cands) > 1
        for cand in cands[1:]:
            out = _seam_outputs(seam, cand, x, w, c, cached, active)
            for i, (a, b) in enumerate(zip(out, base)):
                assert torch.equal(a, b), (seam, cand["knobs"], i)


@pytest.mark.cuda
def test_a_refused_plan_raises_and_launches_nothing(cuda):
    from repro_torch.roofline import analysis

    da, fau = cuda
    x, w, c = _data(1000, 19, 27, torch.float32, seed=1)
    plan = analysis.assign_update_blocking(19, 27, n=1000)
    before = (da.assign_top2_cuda.launches, fau.fused_assign_update_cuda.launches)
    for bad in ({"bk": 6}, {"rows_per_thread": 2}, {"ctas": -1}):
        with pytest.raises(da.PlanError):
            da.assign_top2_cuda(x, c, plan=plan | bad)
    with pytest.raises(da.PlanError):
        fau.fused_assign_update_cuda(x, w, c, plan=plan | {"fold": plan["fold"] | {"stages": 9}})
    # B3's rows a thread are not a knob
    with pytest.raises(da.PlanError):
        fau.fused_assign_update_pruned_cuda(
            x, w, c, torch.zeros(1000, dtype=torch.int32, device="cuda"),
            torch.ones(1000, dtype=torch.bool, device="cuda"),
            plan=plan | {"rows_per_thread": 4, "bn": 512})
    assert (da.assign_top2_cuda.launches, fau.fused_assign_update_cuda.launches) == before


@pytest.mark.cuda
def test_autotune_on_the_card_keeps_the_fit_bit_equal(cuda, tmp_path, monkeypatch):
    """A measured cache (its timing runs leave the launch counts alone),
    then the same in-core fit with the cache warm and with
    ``REPRO_AUTOTUNE=0``: the centroids are bit-equal."""
    import repro_torch
    from repro_torch.kernels import autotune

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.clear_memo()
    try:
        rng = np.random.RandomState(3)
        x = (rng.randn(40_000, 19) * 3).astype(np.float32)
        da, fau = cuda
        counts = (da.assign_top2_cuda.launches, fau.fused_assign_update_cuda.launches)
        blk = autotune.blocking("assign_update", n=40_000, d=19, k=27)
        assert blk["source"] == "measured" and blk["candidates_timed"] > 1
        # timing runs are not launches of the caller's path
        assert (da.assign_top2_cuda.launches, fau.fused_assign_update_cuda.launches) == counts
        # past the fused limit the seams time the scan (B1) alone
        for seam in ("assign_update", "assign_update_pruned"):
            wide = autotune.blocking(seam, n=70_001, d=19, k=2001)
            assert wide["source"] == "measured" and not wide["fused_ok"]
        assert autotune.blocking("assign_update", n=40_000, d=19, k=27,
                                 measure=lambda p: pytest.fail("a hit must not time"))["source"] \
            == "cache"
        tuned = repro_torch.BWKM(k=27, max_iters=6).fit(x).centroids_
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        plain = repro_torch.BWKM(k=27, max_iters=6).fit(x).centroids_
        assert torch.equal(tuned, plain)
    finally:
        autotune.clear_memo()


# ------------------------------------------------------- models and vq (A15)
def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _reduced(arch):
    from repro_torch import configs
    from repro_torch import random as rnd
    from repro_torch.models import transformer

    cfg = configs.reduced_config(configs.get_config(arch))
    params = transformer.init_params(cfg, rnd.key(0), device="cpu")
    return cfg, params, _tree_to(params, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x22b"])
def test_reduced_prefill_and_decode_on_the_card_follow_the_cpu(cuda, arch):
    from repro_torch.models import transformer as tf

    cfg, cpu, gpu = _reduced(arch)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (2, 64)).astype(np.int32))
    outs = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        last, cache = tf.prefill(cfg, params, toks.to(dev), max_seq_len=67)
        steps = [last]
        tok = torch.zeros(2, dtype=torch.int32, device=dev)
        for i in range(3):
            logits, cache = tf.decode(cfg, params, cache, tok, 64 + i)
            steps.append(logits)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        outs[dev] = [s.cpu() for s in steps]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_quantize_rows_on_the_card_gives_the_cpus_codes(cuda):
    from repro_torch import vq

    rng = np.random.RandomState(1)
    rows = rng.randn(5000, 128).astype(np.float32)  # two 4,096-row launches, the last ragged
    for k in (256, 300):
        c = rng.randn(k, 128).astype(np.float32)
        gpu = vq.quantize_rows(torch.from_numpy(rows).cuda(), c)
        cpu = vq.quantize_rows(rows, c, device="cpu")
        assert gpu.dtype == cpu.dtype == vq.code_dtype_for(k)
        assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.cuda
def test_moe_combine_on_the_card_is_bit_equal_run_to_run(cuda):
    from repro_torch.models import moe

    cfg, _, gpu = _reduced("deepseek-moe-16b")
    blk = {k: v[0] for k, v in gpu["layers"]["moe"].items() if k != "shared"}
    blk["shared"] = {k: v[0] for k, v in gpu["layers"]["moe"]["shared"].items()}
    x = torch.randn(4, 128, cfg.d_model, generator=torch.Generator().manual_seed(2)).cuda()
    a, aux_a = moe.moe_ffn(cfg, blk, x)
    b, aux_b = moe.moe_ffn(cfg, blk, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.cuda
def test_decode_quantized_on_the_card_is_bit_equal_run_to_run(cuda):
    from repro_torch import vq
    from repro_torch.models import transformer as tf

    cfg, _, gpu = _reduced("granite-8b")
    rng = np.random.RandomState(3)
    prompts = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 16)).astype(np.int32)).cuda()
    cb = vq.KVCodebook(rng.randn(cfg.n_layers, 64, cfg.hd), rng.randn(cfg.n_layers, 64, cfg.hd))
    _, cache = tf.prefill(cfg, gpu, prompts, max_seq_len=24)
    qcache = vq.quantize_cache(cb, cache)
    kcb, vcb = (torch.from_numpy(c).cuda() for c in (cb.k_centroids, cb.v_centroids))
    tok = torch.zeros(2, dtype=torch.int32, device="cuda")
    runs = [vq.decode_quantized(cfg, gpu, kcb, vcb, qcache, tok, 16) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for key in ("k_codes", "v_codes", "slot_pos"):
        assert torch.equal(runs[0][1][key], runs[1][1][key])


# ------------------------------------------ the ssm, hybrid and vlm families
def _stressed(cfg, params, seed):
    """``params`` with the decay rates, step biases, in-projections, convs
    and gates the reference's initialisation leaves inert set to seeded
    values, and no skip term (the CPU tests' stress, in torch)."""
    g = torch.Generator().manual_seed(seed)
    scale = 0.3 * (64 / cfg.d_model) ** 0.5
    draw = {
        "in_proj": lambda v: torch.randn(v.shape, generator=g) * scale,
        "conv_w": lambda v: torch.randn(v.shape, generator=g) * 0.4,
        "conv_b": lambda v: torch.randn(v.shape, generator=g) * 0.1,
        "a_log": lambda v: torch.rand(v.shape, generator=g) * 2 - 3,
        "dt_bias": lambda v: torch.rand(v.shape, generator=g) * 2 - 3,
        "d_skip": lambda v: torch.zeros(v.shape),
        "gate_attn": lambda v: torch.rand(v.shape, generator=g) + 0.5,
        "gate_mlp": lambda v: torch.rand(v.shape, generator=g) + 0.5,
    }
    return {k: _stressed(cfg, v, seed) if isinstance(v, dict)
            else draw[k](v).to(v.dtype) if k in draw else v for k, v in params.items()}


FAMILIES = {"mamba2-130m": None, "zamba2-1.2b": None, "zamba2-tail": 5,
            "llama-3.2-vision-90b": None}


def _family(name):
    from repro_torch import configs
    from repro_torch import random as rnd
    from repro_torch.models import transformer

    arch = "zamba2-1.2b" if name == "zamba2-tail" else name
    cfg = configs.reduced_config(configs.get_config(arch))
    if FAMILIES[name]:
        cfg = cfg.replace(n_layers=FAMILIES[name])
    params = _stressed(cfg, transformer.init_params(cfg, rnd.key(0), device="cpu"), 1)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 64)).astype(np.int32))
    img = (torch.from_numpy(rng.randn(2, cfg.n_image_tokens, cfg.d_model).astype(np.float32))
           if cfg.family == "vlm" else None)
    return cfg, params, toks, img


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILIES))
def test_recurrent_and_vision_families_on_the_card_follow_the_cpu(cuda, name):
    from repro_torch.models import transformer as tf

    cfg, cpu, toks, img = _family(name)
    outs = {}
    for dev, params in (("cpu", cpu), ("cuda", _tree_to(cpu, "cuda"))):
        im = None if img is None else img.to(dev)
        last, cache = tf.prefill(cfg, params, toks.to(dev), im, max_seq_len=67)
        steps = [last]
        tok = torch.zeros(2, dtype=torch.int32, device=dev)
        for i in range(3):
            logits, cache = tf.decode(cfg, params, cache, tok, 64 + i)
            steps.append(logits)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        outs[dev] = [s.cpu() for s in steps]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILIES))
def test_recurrent_and_vision_decode_on_the_card_is_bit_equal_run_to_run(cuda, name):
    from repro_torch.models import transformer as tf

    cfg, cpu, toks, img = _family(name)
    gpu = _tree_to(cpu, "cuda")
    _, cache = tf.prefill(cfg, gpu, toks.cuda(), None if img is None else img.cuda(),
                          max_seq_len=67)
    tok = torch.zeros(2, dtype=torch.int32, device="cuda")
    (a, ca), (b, cb) = (tf.decode(cfg, gpu, cache, tok, 64) for _ in range(2))
    assert torch.equal(a, b)
    flat = [(x, y) for x, y in zip(_leaves(ca), _leaves(cb))]
    assert flat and all(torch.equal(x, y) for x, y in flat)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)
