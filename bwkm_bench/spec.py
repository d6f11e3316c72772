"""Find what ``BENCHMARK.json`` names: a workload's configuration, traffic
mix, limits, metric readers and the spans those readers declare, each in a
file of its own under this folder, looked up by name. A new cell or metric
is a new file and a new entry; nothing here lists them."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Callable

__all__ = ["BENCH", "ROOT", "Cell", "cell", "load_benchmark", "loop_class", "reader", "spans"]

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload with everything it names."""

    def __init__(self, bench: dict, name: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
        self.workload = by_name[name]
        self.name = name
        cfg_entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = json.loads((ROOT / cfg_entry["file"]).read_text())
        self.traffic = json.loads((BENCH / "traffic" / f"{self.workload['traffic']}.json").read_text())
        limits = BENCH / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}
        self.chips = int(self.workload["chips"])
        self.bench = bench

    def metrics(self, trace: bool) -> list[dict]:
        """The metric entries this cell reports in a run with ``trace``."""
        group = self.bench["per_layer"] if trace else self.bench["end_to_end"]
        return [m for m in group if "workloads" not in m or self.name in m["workloads"]]


def cell(name: str) -> Cell:
    return Cell(load_benchmark(), name)


def _module(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bwkm_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[dict], float | None]:
    """``read(record)`` of ``metrics/<metric>.py``."""
    return _module(metric).read


def spans(metrics: list[dict]) -> list[tuple]:
    """The spans the metrics' readers declare (``SPANS`` of
    ``metrics/<metric>.py``: ``(module, attribute, span, "host" | "events")``),
    each once, with the module imported."""
    out: dict[str, tuple] = {}
    for m in metrics:
        for mod, attr, name, how in getattr(_module(m["name"]), "SPANS", ()):
            out.setdefault(name, (importlib.import_module(mod), attr, name, how))
    return list(out.values())


def loop_class(kind: str):
    """The loop of :mod:`bwkm_bench.loops` that drives traffic of ``kind``."""
    return importlib.import_module(f"bwkm_bench.loops.{kind}").Loop
