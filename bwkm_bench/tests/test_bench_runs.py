"""Small runs of every traffic on the CPU against the reference: sound runs
come out correct, the control and planted faults do not, the last line
has its schema, and nothing loads JAX or the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from bwkm_bench import harness, spec

CELLS = ("susy.fit", "kv128.assign", "susy.service")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(run_small, name):
    line, rec = run_small(name, control=True)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] == rec["units"] >= 1
    cell = spec.cell(name)
    failed_by_control = [k for k, v in rec["control"].items() if v > cell.limits[k]]
    assert failed_by_control, rec["control"]


@pytest.mark.parametrize("name", CELLS)
def test_last_line_schema(run_small, name):
    line, _ = run_small(name, seconds=0.5)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    e2e = {m["name"] for m in spec.cell(name).metrics(False)}
    assert set(line["metrics"]) == e2e
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_per_layer_metrics(run_small, name):
    line, rec = run_small(name, seconds=1.0, trace=True)
    assert line["correct"]
    assert rec["profile"] is not None and "breakdown" in line
    # the CPU has no device trace and no CUDA events: only host spans read here
    host = {"susy.fit": {"init_partition_ms.fit", "lloyd_ms.fit"}}.get(name, set())
    assert host <= set(line["metrics"])
    # the spans are the ones the cell's metrics declare, each once a unit
    declared = {s[2] for s in spec.spans(spec.cell(name).metrics(True))}
    assert set(rec["spans"]) == declared
    assert all(len(v) == rec["units"] for v in rec["spans"].values())


def test_open_loop_waits_are_not_device_idle(run_small):
    """The service's traced batches wait for their arrival; the idle share
    reads the batches' service time, not the waits."""
    from bwkm_bench.metrics import _read

    _, rec = run_small("susy.service", seconds=1.0, trace=True)
    prof = rec["profile"]
    assert 0.0 <= prof["wait_s"] < prof["window_s"]
    serving = prof["window_s"] - prof["wait_s"]
    assert _read.idle_pct(rec, "service") == pytest.approx(100.0 * (1 - prof["busy_s"] / serving))


def _plant(monkeypatch, fault: str):
    """The timed path broken underneath, as a later change might break it."""
    from repro_torch.core import lloyd, partition
    from repro_torch.kernels import ops

    if fault == "state_unchanged":  # a Lloyd call returns its start
        orig = lloyd.weighted_lloyd

        def unchanged(x, w, c, **kw):
            res = orig(x, w, c, **kw)
            return res._replace(centroids=c) if res.iters else res
        monkeypatch.setattr(lloyd, "weighted_lloyd", unchanged)
    elif fault == "half_left_out":  # statistics of half the rows, the mean taken over them
        orig = partition.block_stats

        def half(x, bid, m, valid=None):
            h = max(1, x.shape[0] // 2)
            st = orig(x[:h], bid[:h], m, None if valid is None else valid[:h])
            return st._replace(psum=st.psum * 2, count=st.count * 2)
        monkeypatch.setattr(partition, "block_stats", half)
    elif fault == "answer_altered":  # one label off where it is produced
        orig = ops.assign_top2

        def altered(x, c):
            a, d1, d2 = orig(x, c)
            a = a.clone()
            a[0] = (a[0] + 1) % c.shape[0]
            return a, d1, d2
        monkeypatch.setattr(ops, "assign_top2", altered)


def _plant_outer(monkeypatch, fault: str):
    """A fault of ``_faults`` in Algorithm 5's outer loop, undone after the test."""
    from repro_torch.core import misassignment
    from repro_torch.engine import driver

    from bwkm_bench.tests import _faults

    for owner, attr in ((driver, "fit_plane"), (misassignment, "misassignment"),
                        (misassignment, "sample_boundary")):
        monkeypatch.setattr(owner, attr, getattr(owner, attr))
    getattr(_faults, fault)()


@pytest.mark.parametrize("name,fault", [
    ("susy.fit", "state_unchanged"), ("susy.fit", "half_left_out"),
    ("susy.fit", "answer_altered"),
    ("susy.fit", "early_stop"), ("susy.fit", "eps_zero"), ("susy.fit", "half_draws"),
    ("kv128.assign", "half_left_out"), ("kv128.assign", "answer_altered"),
    ("susy.service", "state_unchanged"), ("susy.service", "half_left_out"),
    ("susy.service", "answer_altered"),
    ("susy.service", "eps_zero"), ("susy.service", "half_draws"),
])
def test_a_planted_fault_is_not_correct(run_small, monkeypatch, name, fault):
    if fault in ("early_stop", "eps_zero", "half_draws"):
        _plant_outer(monkeypatch, fault)
    elif name == "kv128.assign" and fault == "half_left_out":  # half the rows' labels returned
        import repro_torch

        orig = repro_torch.BWKM.predict
        monkeypatch.setattr(repro_torch.BWKM, "predict",
                            lambda self, x: orig(self, x)[: x.shape[0] // 2])
    else:
        _plant(monkeypatch, fault)
    line, _ = run_small(name)
    assert not line["correct"], line["checks"]


def test_no_jax_and_no_reference_package_loaded(tmp_path):
    """After a small run, no loaded module's top-level name is ``jax``,
    ``jaxlib``, ``flax`` or ``repro`` (the port ``repro_torch`` is fine)."""
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(spec.ROOT)!r})
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        import torch
        from conftest import small_cell
        from bwkm_bench import harness
        harness.prepare_environment()
        for name in {CELLS!r}:
            harness.run_local(small_cell(name), seed=5, seconds=0.3, trace=False,
                              device=torch.device("cpu"), t0=time.perf_counter())
        print(harness.forbidden_modules(), "repro_torch" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        assert "repro_torch_lookalike_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike_for_test"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "bwkm_bench.run", "--workload", "susy.fit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=spec.ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_every_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        if w["chips"] > torch.cuda.device_count():
            continue
        out = subprocess.run([sys.executable, "-m", "bwkm_bench.run", "--workload", w["name"],
                              "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0"],
                             capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
