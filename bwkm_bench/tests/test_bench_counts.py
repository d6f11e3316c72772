"""The benchmark's kernel counts against hand-worked shapes, the TF32
rounding of the control, and the reference's judges on made-up answers."""

from __future__ import annotations

import pytest
import torch

from bwkm_bench import counts, data
from bwkm_bench.reference import control as ctl
from bwkm_bench.reference import kmeans as ref
from bwkm_bench.reference import partition as refp


def test_b1_predict_chunk_by_hand():
    # x [65,536, 128] f32 against 256 centres: 2·65,536·256·128 operations;
    # 32 MiB of rows, 128 KiB of centres, 12 bytes a row out
    flops, nbytes = counts.b1(65_536, 256, 128)
    assert flops == 4_294_967_296.0
    assert nbytes == 65_536 * 128 * 4 + 256 * 128 * 4 + 65_536 * 12
    # bound by bytes: 34.5 MB at 3.35 TB/s
    assert counts.bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_other_kernels_by_hand():
    assert counts.b2(10, 3, 2) == (2 * 10 * 3 * 2 + 2 * 10 * 2 + 10,
                                   10 * 2 * 4 + 40 + 3 * 2 * 4 + 10 * 12 + 3 * 3 * 4 + 4)
    assert counts.b3(10, 3, 2, active=4)[0] == 2 * 4 * 3 * 2 + 2 * 10 * 2 + 10
    assert counts.b4(10, 3, 2) == (50, 10 * 2 * 4 + 10 * 8 + 3 * 3 * 4)
    assert counts.b5(10, 5, 2)[0] == 2 * 10 * 5 * 2 + 20
    # bf16 rows halve the row bytes
    assert counts.b1(8, 2, 4, xsize=2)[1] == 8 * 4 * 2 + 2 * 4 * 4 + 8 * 12
    # a compute-bound shape: 5,000,000 rows against 2,001 centres at d = 19
    f, b = counts.b1(5_000_000, 2_001, 19)
    assert counts.bound_s(f, b) == pytest.approx(f / 989e12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -2.5, 0.0])
    got = ctl.tf32(x)
    # ties to even at the 10th mantissa bit
    assert got.tolist() == [1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10, -2.5, 0.0]


def test_label_gap_reads_a_wrong_label_and_forgives_a_tie():
    c = torch.tensor([[0.0, 0.0], [1.0, 0.0]])
    x = torch.tensor([[0.1, 0.0], [0.5, 0.0], [0.9, 0.0]])
    good = torch.tensor([0, 1, 1], dtype=torch.int32)  # row 1 is a tie
    assert ref.label_gaps(x, c, good)[0] == 0.0
    bad = torch.tensor([0, 0, 0], dtype=torch.int32)
    assert ref.label_gaps(x, c, bad)[0] == pytest.approx((0.81 - 0.01) / (0.81 + 1.0))
    assert ref.label_gaps(x, c, torch.tensor([0, 2, 1]))[0] == float("inf")


def test_member_stats_overlaps_and_route():
    x = torch.tensor([[0.0, 0.0], [1.0, 1.0], [3.0, 0.0], [4.0, 1.0]])
    bid = torch.tensor([0, 0, 1, 1])
    count, psum, lo, hi = refp.member_stats(x, bid, 3)
    assert count.tolist() == [2, 2, 0]
    assert psum[1].tolist() == [7.0, 1.0]
    assert lo[0].tolist() == [0.0, 0.0] and hi[1].tolist() == [4.0, 1.0]
    occ = count > 0
    assert refp.overlaps(lo, hi, occ) == 0
    assert refp.overlaps(torch.tensor([[0.0, 0.0], [1.0, 1.0]]),
                         torch.tensor([[1.0, 1.0], [2.0, 2.0]]), torch.tensor([True, True])) == 1
    active = torch.tensor([True, True, False])
    rows = torch.tensor([[0.5, 0.5], [2.0, 0.5], [10.0, 0.0]])
    # inside box 0; equidistant (1.0) from both boxes: the first; nearest box 1
    assert refp.route(rows, lo, hi, active).tolist() == [0, 0, 1]


def test_virtual_split_moves_the_mass_to_the_representative():
    lo = torch.tensor([[0.0, 0.0], [0.0, 0.0]])
    hi = torch.tensor([[4.0, 1.0], [0.0, 0.0]])
    psum = torch.tensor([[6.0, 1.0], [0.0, 0.0]], dtype=torch.float64)
    count = torch.tensor([2.0, 0.0], dtype=torch.float64)
    ps, cn, lo2, hi2 = refp.virtual_split(psum, count, lo, hi, torch.tensor([True, False]), 1)
    # longest side is feature 0, mid 2; the representative (3, 0.5) is right
    assert hi2[0].tolist() == [2.0, 1.0] and lo2[1].tolist() == [2.0, 0.0]
    assert cn.tolist() == [0.0, 2.0] and ps[1].tolist() == [6.0, 1.0]


def test_data_is_the_seeds():
    mix = data.mixture({"n": 100, "d": 3, "modes": 4, "anisotropy": 3.0, "center_scale": 10.0,
                        "mixture_seed": 0}, "cpu")
    a = data.draw(mix, 1000, data.derive(2**31 + 7, "rows"))
    b = data.draw(mix, 1000, data.derive(2**31 + 7, "rows"))
    c = data.draw(mix, 1000, data.derive(2**31 + 8, "rows"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert data.derive(-5, "x") != data.derive(5, "x") and 0 <= data.derive(2**40, 1) < 2**63
    assert data.mixture_std(mix).shape == (3,)
