"""BENCHMARK.json against the benchmark's contract, and everything it names
found by name under ``bwkm_bench/``."""

from __future__ import annotations

import json
import re

import pytest

from bwkm_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["bwkm_bench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32 and all(not w.startswith("/") for w in bench["command"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_sources(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in bench["workloads"]] \
        + [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads", "layer", "moves"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m and "\n" not in m["layer"]


def test_every_cell_reports_what_it_must(bench):
    chips4 = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(chips4) <= max(1, len(bench["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        per = cell.metrics(True)
        assert per, w["name"]
        for m in per:  # a per-layer metric moves an end-to-end metric its cells report
            assert m["moves"] in e2e, (w["name"], m["name"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


def test_configs_traffic_limits_and_readers_found_by_name(bench):
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["file"].startswith("bwkm_bench/configs/")
        assert {"n", "d", "modes", "mixture_seed"} <= set(cfg["data"]) and cfg["dtype"] == "float32"
        assert c["reduced"] == [] and len(c["source"]) <= 200
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert spec.loop_class(cell.traffic["kind"]) is not None
        assert cell.limits, f"limits/{w['name']}.json"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_the_spans_metrics_declare_exist_in_the_port(bench):
    spans = spec.spans(bench["per_layer"])
    assert spans
    for owner, attr, name, how in spans:
        assert callable(getattr(owner, attr)), (owner.__name__, attr)
        assert how in ("host", "events") and NAME.match(name)


def test_unknown_workload_is_refused(bench):
    with pytest.raises(KeyError):
        spec.Cell(bench, "no.such.cell")
