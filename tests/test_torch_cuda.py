"""The CUDA kernels B1–B3 against their plain versions, on the card.

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
