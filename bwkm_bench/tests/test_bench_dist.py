"""The distributed loop (``kind: dist_fit``, the traffic ``dist4`` over the
``susy`` configuration) on the CPU: four gloo ranks at a small size, against
the reference; the control and a left-out exchange are not correct, and a
module of JAX's name that a rank loads while it judges is seen. No cell of
``BENCHMARK.json`` runs this loop yet (PERF.md §7), so the tests name the
cell ``susy.dist4`` themselves."""

from __future__ import annotations

import time

import pytest

from bwkm_bench import harness, spec
from bwkm_bench.loops import dist_fit


def _cell():
    bench = spec.load_benchmark()
    bench["workloads"] = bench["workloads"] + [
        {"name": "susy.dist4", "config": "susy", "traffic": "dist4", "chips": 4, "why": "test"}]
    cell = spec.Cell(bench, "susy.dist4")
    cell.config["data"]["n"] = 8_000  # 2,000 rows a rank, every width as configured
    return cell


def _run(plant=None):
    cell = _cell()
    rec, numbers, _ = dist_fit.run(cell, seed=2**31 + 21, seconds=1.0, trace=False,
                                   t0=time.perf_counter(), device_type="cpu", with_control=True,
                                   deadline_s=240.0, plant=plant)
    line = harness.result_line(cell, rec, numbers, trace=False,
                               device_info={"platform": "cpu", "kind": "cpu", "count": 4,
                                            "memory_peak_bytes": 0})
    return cell, line, rec


def test_four_gloo_ranks_are_correct_and_the_control_is_not():
    cell, line, rec = _run()
    assert line["correct"], line["checks"]
    assert spec.reader("dist_fit_s")(rec) > 0
    assert rec["forbidden"] == []
    assert [k for k, v in rec["control"].items() if v > cell.limits[k]]


@pytest.mark.parametrize("fault", ["no_exchange", "early_stop"])
def test_a_fault_in_the_ranks_is_not_correct(fault):
    _, line, _ = _run(plant=f"bwkm_bench.tests._faults:{fault}")
    assert not line["correct"], line["checks"]


def test_a_module_loaded_by_a_ranks_judge_is_found():
    _, _, rec = _run(plant="bwkm_bench.tests._faults:jax_in_judge")
    assert "jax" in rec["forbidden"]
