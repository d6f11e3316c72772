"""The port's roofline module against the reference's, on the CPU.

``repro_torch.roofline.analysis`` keeps the reference's cost models with the
reference's arithmetic, on H100 constants: each shared function must equal
the reference's on the same arguments (within 1e-12 relative), with ``bn``
passed where the reference would take its TPU plan. The seam bounds must
reproduce the numbers ``PERF.md`` §6 prints, and the CUDA plans the choices
``csrc/top2.cuh`` and ``csrc/cluster_fold.cuh`` make (the card holds the
plans against the C side itself: ``tests/test_torch_cuda.py``).
"""

import dataclasses
import math

import pytest
import torch

from repro import configs
from repro.roofline import analysis as ref
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.roofline import analysis

SHAPES = [(5_000_000, 19, 27), (65_536, 19, 561), (14_528, 19, 2_001), (1_000, 300, 70),
          (1, 1, 1)]


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _close(a[key], b[key])
        return
    assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (a, b)


def test_h100_constants_and_budget():
    assert analysis.PEAK_FLOPS == 989e12 and analysis.F32_FLOPS == 67e12
    assert analysis.TF32_FLOPS == 495e12 and analysis.HBM_BW == 3.35e12
    assert analysis.NVLINK_BW == 450e9 and analysis.REGISTERS_PER_SM == 65_536
    assert analysis.KERNEL_BUDGET_BYTES == {"cuda": 232_448}
    assert analysis.kernel_budget_bytes() == 232_448
    for backend in ("tpu", "gpu", "cpu"):
        with pytest.raises(ValueError, match="cuda"):
            analysis.kernel_budget_bytes(backend)
        with pytest.raises(ValueError, match="cuda"):
            analysis.assign_update_blocking(19, 27, backend=backend)
        with pytest.raises(ValueError, match="cuda"):
            analysis.min_sqdist_blocking(19, 27, backend=backend)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_cost_models_equal_the_references(n, d, k):
    for fused in (True, False):
        for bn in (8, 128, 512):
            for db in (2, 4):
                _close(analysis.assign_update_hbm_bytes(n, d, k, fused=fused, bn=bn, dtype_bytes=db),
                       ref.assign_update_hbm_bytes(n, d, k, fused=fused, bn=bn, dtype_bytes=db))
    ref_bn = ref.min_sqdist_blocking(d, k)["bn"]
    _close(analysis.min_sqdist_hbm_bytes(n, d, k, bn=ref_bn),
           ref.min_sqdist_hbm_bytes(n, d, k))
    for rounds in (1, 5):
        for over in (None, 3):
            ref_bn = ref.min_sqdist_blocking(d, max(over or 2 * k, 1))["bn"]
            _close(analysis.kmeans_ll_cost(n, d, k, oversampling=over, rounds=rounds, bn=ref_bn),
                   ref.kmeans_ll_cost(n, d, k, oversampling=over, rounds=rounds))
    ref_bn = ref.assign_update_blocking(d, k)["bn"]
    for skip in (0.0, 0.25):
        _close(analysis.assign_update_pruned_cost(n, d, k, n // 3, bn=ref_bn,
                                                  skipped_block_fraction=skip),
               ref.assign_update_pruned_cost(n, d, k, n // 3, skipped_block_fraction=skip))
    # the port's own defaults: B5's and B3's plans at this n
    bn5 = analysis.min_sqdist_blocking(d, k, n=n)["bn"]
    assert analysis.min_sqdist_hbm_bytes(n, d, k) == analysis.min_sqdist_hbm_bytes(n, d, k, bn=bn5)


def test_roofline_terms_and_extrapolation_equal_the_references():
    flops, hbm, coll = 3.7e15, 2.9e12, 4.1e10
    mine = analysis.terms_from_costs(flops, hbm, coll, peak=ref.PEAK_FLOPS)
    theirs = ref.terms_from_costs(flops, hbm, coll)
    _close(mine.compute_s, theirs.compute_s)
    _close(mine.memory_s, hbm / analysis.HBM_BW)
    _close(mine.collective_s, coll / analysis.NVLINK_BW)
    assert analysis.terms_from_costs(flops, 0, 0).compute_s == flops / 989e12
    assert analysis.terms_from_costs(flops, 0, 0, peak=analysis.F32_FLOPS).compute_s \
        == flops / 67e12
    # the same terms give the same verdicts
    same = ref.RooflineTerms(**dataclasses.asdict(mine))
    assert mine.to_dict() == same.to_dict()
    assert mine.dominant == same.dominant and mine.bound_s == same.bound_s
    p1 = {"flops": 10.0, "bytes": 7.0}
    p2 = {"flops": 18.0, "bytes": 9.5}
    assert analysis.extrapolate_linear(p1, p2, 3, 40) == ref.extrapolate_linear(p1, p2, 3, 40)


def test_model_flops_equal_the_references_over_the_configs():
    checked = 0
    for arch, shape_name in configs.runnable_cells():
        cfg, shape = configs.get_config(arch), configs.SHAPES[shape_name]
        for n_params, n_active in ((7_000_000_000, 7_000_000_000), (16_000_000_000, 2_800_000_000)):
            _close(analysis.model_flops(cfg, shape, n_params, n_active),
                   ref.model_flops(cfg, shape, n_params, n_active))
            checked += 1
    assert checked >= 2 * len(configs.ARCHS) * 3


# the bounds of PERF.md §6, to their printed digits: (function, args, printed ms, by)
PERF_BOUNDS = [
    (analysis.assign_top2_bound, (5_000_000, 19, 2001), "6.122", "operations"),
    (analysis.assign_update_bound, (5_000_000, 19, 561), "1.719", "operations"),
    (analysis.min_sqdist_bound, (5_000_000, 19, 400, 202), "0.618", "operations"),
    (analysis.assign_top2_bound, (65_536, 19, 27), "0.00172", "bytes"),
    (analysis.min_sqdist_bound, (5_000_000, 19, 112, 112), "0.343", "operations"),
    (analysis.assign_update_pruned_bound, (14_528, 19, 27, 1_471), "0.00042", "bytes"),
    (analysis.assign_update_bound, (14_528, 19, 27), "0.00040", "bytes"),
    (analysis.cluster_sums_bound, (5_000_000, 19, 2001), "0.125", "bytes"),
    (analysis.min_sqdist_bound, (5_000_000, 19, 1, 1), "0.131", "bytes"),
    (analysis.assign_top2_bound, (1_000, 19, 27), "0.000027", "bytes"),
    (analysis.cluster_sums_bound, (1_000, 19, 27), "0.000026", "bytes"),
    (analysis.assign_update_bound, (1_236, 19, 27), "0.000035", "bytes"),
]


@pytest.mark.parametrize("fn,args,printed,by", PERF_BOUNDS)
def test_seam_bounds_reproduce_perf_md(fn, args, printed, by):
    b = fn(*args)
    digits = len(printed.split(".")[1])
    assert f"{b.ms:.{digits}f}" == printed and b.by == by
    assert b.ms == max(b.bytes / analysis.HBM_BW, b.flops / analysis.F32_FLOPS) * 1e3


def test_seam_bounds_count_the_kernels_work():
    n, d, k = 65_536, 19, 27
    b1 = analysis.assign_top2_bound(n, d, k)
    assert b1.flops == n * k * (2 * d + 3) and b1.bytes == 4 * n * d + 4 * k * d + 12 * n
    assert analysis.assign_top2_bound(n, d, k, dtype_bytes=2).bytes == 2 * n * d + 2 * k * d + 12 * n
    b2 = analysis.assign_update_bound(n, d, k)
    b3 = analysis.assign_update_pruned_bound(n, d, k, n)
    assert b3.flops == b2.flops and b3.bytes == b2.bytes + 5 * n
    assert analysis.min_sqdist_bound(n, d, 400, 0).flops == 0


def test_cuda_plans_follow_the_kernels_choices():
    # four rows a thread from 131,072 rows on, at d <= 19 only
    for n, d, r in ((131_071, 19, 1), (131_072, 19, 4), (5_000_000, 1, 4), (5_000_000, 20, 1)):
        p = analysis.assign_update_blocking(d, 27, n=n)
        assert (p["rows_per_thread"], p["bn"]) == (r, 128 * r), (n, d)
        assert analysis.min_sqdist_blocking(d, 27, n=n)["bn"] == 128 * r
    # the wide-row form past d = 14,432 (four resident candidates no longer fit)
    assert not analysis.scan_plan(1_000, 14_432, 4)["wide"]
    wide = analysis.scan_plan(1_000, 14_433, 4)
    assert wide["wide"] and (wide["bn"], wide["bk"], wide["smem_bytes"]) == (128, 4, 16_384)
    # K = 2,001 at d = 19 stays resident: 160 KB of candidates beside the x tile
    p = analysis.assign_update_blocking(19, 2001, n=5_000_000)
    assert p["bk"] == 2004 and p["smem_bytes"] - p["xbytes"] == 2004 * 80
    assert p["smem_bytes"] <= analysis.SCAN_SMEM
    # fused_ok <=> K·(d + 1) <= 16,384
    for d, k in ((19, 819), (19, 820), (19, 561), (19, 2001), (14_433, 1), (16_383, 1),
                 (16_384, 1)):
        assert analysis.assign_update_blocking(d, k)["fused_ok"] == (k * (d + 1) <= 16_384)
    # the fold: the whole [2,001, 20] partial in one CTA, 128 CTAs over 5M rows
    f = analysis.cluster_sums_blocking(19, 2001, n=5_000_000)
    assert (f["kt"], f["cw"], f["ctas"], f["k_tiles"], f["col_chunks"]) == (2001, 20, 128, 1, 1)
    assert analysis.fold_plan(14_528, 19, 27)["stages"] == 2  # one tile a CTA: two stages
    f = analysis.fold_plan(10, 41_000, 3)  # columns tiled past d + 1 = 40,960
    assert f["cw"] == 40_960 and f["col_chunks"] == 2 and not f["xstaged"]
    # a smaller cap tiles the clusters, then the columns
    assert analysis.fold_plan(100, 19, 27, part_floats=200)[("kt")] == 10


def test_plans_the_kernels_refuse_raise():
    for kw in (dict(rows_per_thread=2), dict(kc=6), dict(kc=2008), dict(ctas=-1)):
        with pytest.raises(ValueError):
            analysis.scan_plan(200_000, 19, 2001, **kw)
    with pytest.raises(ValueError):
        analysis.scan_plan(100, 40, 27, rows_per_thread=4)  # no R = 4 past d = 19
    with pytest.raises(ValueError):
        analysis.scan_plan(100, 14_433, 4, kc=8)  # the wide-row form takes four
    with pytest.raises(ValueError):
        analysis.assign_update_blocking(19, 27, bn=256)
    for kw in (dict(stages=1), dict(stages=5), dict(kt=2001, cw=21), dict(kt=3),
               dict(kt=3000, cw=20)):
        with pytest.raises(ValueError):
            analysis.fold_plan(5_000_000, 19, 2001, **kw)


def test_collective_bytes_count_the_port_s_collectives():
    analysis.collective_bytes(reset=True)
    with make_smoke_mesh("cpu") as mesh, sh.use_mesh(mesh):
        sh._all_reduce(torch.ones(10, dtype=torch.float32))
        sh._all_reduce(torch.ones(3, dtype=torch.int64), "max")
        sh._sum_over_ranks(torch.ones(4), torch.ones(2, 3))  # one gather of 10 f32
        got = analysis.collective_bytes(reset=True)
    assert got == {"all-gather": {"bytes": 40, "count": 1},
                   "reduce-scatter": {"bytes": 0, "count": 0},
                   "all-reduce": {"bytes": 64, "count": 2},
                   "all-to-all": {"bytes": 0, "count": 0}, "total_bytes": 104}
    assert analysis.collective_bytes()["total_bytes"] == 0
    sh._all_reduce(torch.ones(10))  # without a mesh nothing is issued or counted
    assert analysis.collective_bytes()["total_bytes"] == 0
