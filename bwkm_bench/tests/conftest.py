"""Small cells on the CPU for the benchmark's own tests (the port's plain
path runs there); tests that need the card carry the ``cuda`` marker and
decide inside the test."""

from __future__ import annotations

import pytest
import torch

from bwkm_bench import harness, spec

harness.prepare_environment()
torch.set_num_threads(2)  # several test workers share the host's cores

#: per workload: the sizes a CPU test can hold (every width as configured)
SMALL = {
    "susy.fit": {"data": {"n": 12_000}},
    "kv128.assign": {"data": {"n": 8_192}, "k": 64, "traffic": {"chunk_rows": 2_048}},
    "susy.service": {"traffic": {"batch_rows": 3_000, "drift_from_batch": 6}},
}


def small_cell(name: str):
    cell = spec.cell(name)
    over = SMALL[name]
    cell.config["data"].update(over.get("data", {}))
    cell.traffic.update(over.get("traffic", {}))
    if "k" in over:
        cell.config["k"] = over["k"]
    return cell


@pytest.fixture
def run_small():
    """``run(name, seed, seconds=2, trace=False, control=False)`` on the CPU:
    ``(line, record)``."""
    import time

    def run(name, seed=2**31 + 11, seconds=2.0, trace=False, control=False):
        cell = small_cell(name)
        rec, numbers, _ = harness.run_local(cell, seed=seed, seconds=seconds, trace=trace,
                                            device=torch.device("cpu"), t0=time.perf_counter(),
                                            with_control=control)
        line = harness.result_line(cell, rec, numbers, trace=trace,
                                   device_info={"platform": "cpu", "kind": "cpu", "count": 1,
                                                "memory_peak_bytes": 0})
        return line, rec

    return run


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
