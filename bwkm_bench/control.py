"""Read the numbers that decide ``correct`` from the port and from the
control, seed after seed, in one process (set-up is paid once a seed, the
process start once):

    python3 -m bwkm_bench.control --workload susy.fit --seeds 11,12,13 --seconds 5

prints one JSON line a seed, ``{"seed", "correct", "port": {...},
"control": {...}}``, and last the largest port reading and the smallest
control reading of each number. The limits in ``limits/<workload>.json``
are set between the two (PERF.md gives the readings). ``--plant
module:function`` breaks the port first (a fault of
``bwkm_bench/tests/_faults.py``), to read what that fault gives.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m bwkm_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--plant", default=None, help="module:function that breaks the port")
    args = p.parse_args(argv)
    from bwkm_bench import harness, spec

    harness.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("bwkm_bench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    if args.plant and cell.traffic["kind"] != "dist_fit":
        import importlib

        mod, fn = args.plant.split(":")
        getattr(importlib.import_module(mod), fn)()
    hi: dict = {}
    lo: dict = {}
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell.traffic["kind"] == "dist_fit":
        from bwkm_bench.loops import dist_fit

        runs = dist_fit.run_seeds(cell, seeds=seeds, seconds=args.seconds, trace=False,
                                  t0=time.perf_counter(), with_control=True,
                                  deadline_s=60.0 * len(seeds) + 120.0, plant=args.plant)
    else:
        runs = (harness.run_local(cell, seed=seed, seconds=args.seconds, trace=False,
                                  device=device, t0=time.perf_counter(), with_control=True)
                for seed in seeds)
    for seed, (rec, numbers, _) in zip(seeds, runs):
        ok = all(v <= cell.limits.get(k, float("inf")) for k, v in numbers.items())
        print(json.dumps({"seed": seed, "correct": ok and rec["failed"] == 0, "units": rec["units"],
                          "port": numbers, "control": rec.get("control"),
                          "check_s": rec.get("check_s")}), flush=True)
        for k, v in numbers.items():
            hi[k] = max(hi.get(k, 0.0), v)
        for k, v in (rec.get("control") or {}).items():
            lo[k] = min(lo.get(k, float("inf")), v)
    print(json.dumps({"port_max": hi, "control_min": lo,
                      "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
