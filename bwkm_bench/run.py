"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m bwkm_bench.run --workload susy.fit --seed 7 --seconds 40 --trace 0

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
``src/repro_torch``. Exits 2 without the CUDA devices the cell asks for, 3
if JAX or the JAX package was loaded, and prints no result then.
"""

import time

T0 = time.perf_counter()  # the set-up is measured from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with one intra-op thread: the port's host work is one Python
# thread, and idle pool threads spinning on a shared host only add noise
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m bwkm_bench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="makes every input of the run")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: per-layer metrics from spans and torch.profiler")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from bwkm_bench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
