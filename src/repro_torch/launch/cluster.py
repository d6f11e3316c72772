"""End-to-end massive-data clustering driver: the paper's own workload.

Counterpart of ``repro.launch.cluster``. Runs BWKM (in core, or the
distributed engine on a one-rank mesh) on a paper-profile synthetic dataset,
optionally with the paper's baselines, on CUDA unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.cluster --dataset SUSY --k 27 --compare
    PYTHONPATH=src python -m repro_torch.launch.cluster --dataset CIF --scale 0.05 \\
        --k 5 --max-iters 8 --device cpu

It returns (and prints) the same record as the reference: BWKM's error,
distances, iterations, blocks, stop reason and seconds; with ``--compare``
each baseline's error and distances, and every method's relative error.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import random as rnd
from repro_torch.core import baselines, bwkm, metrics
from repro_torch.data.synthetic import paper_dataset
from repro_torch.device import resolve_device

__all__ = ["main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="CIF")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iters", type=int, default=25)
    ap.add_argument("--distributed", action="store_true",
                    help="use the distributed engine (a one-rank mesh in this process)")
    ap.add_argument("--compare", action="store_true",
                    help="also run the paper's baselines")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    x = torch.from_numpy(paper_dataset(args.dataset, scale=args.scale, seed=args.seed)).to(device)
    print(f"[cluster] dataset {args.dataset} n={x.shape[0]} d={x.shape[1]} K={args.k} "
          f"device={device}")
    cfg = bwkm.BWKMConfig(k=args.k, max_iters=args.max_iters)
    key = rnd.key(args.seed)

    _sync(device)
    t0 = time.time()
    if args.distributed:
        from repro_torch.distributed import dist_bwkm
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.mesh import make_smoke_mesh

        with make_smoke_mesh(device) as mesh, sh.use_mesh(mesh):
            xs = dist_bwkm.shard_points(x, device)
            res = dist_bwkm.fit_distributed(key, xs, cfg, checkpoint_dir=args.ckpt_dir)
    else:
        res = bwkm.fit_incore(key, x, cfg)
    e_bwkm = float(metrics.kmeans_error(x, res.centroids))
    out = {
        "bwkm": {
            "error": e_bwkm,
            "distances": res.distances,
            "iterations": res.iterations,
            "blocks": res.n_blocks[-1] if res.n_blocks else 0,
            "stop": res.stop_reason,
            "seconds": round(time.time() - t0, 2),
        }
    }
    print(f"[cluster] BWKM E={e_bwkm:.4e} distances={res.distances:.3e} "
          f"stop={res.stop_reason} ({out['bwkm']['seconds']}s)")

    if args.compare:
        runs = {
            "forgy": lambda k_: baselines.forgy_kmeans(k_, x, args.k),
            "km++": lambda k_: baselines.kmeanspp_kmeans(k_, x, args.k),
            "kmc2": lambda k_: baselines.kmc2_kmeans(k_, x, args.k),
            "mb100": lambda k_: baselines.minibatch_kmeans(k_, x, args.k, batch=100),
            "grid-rpkm": lambda k_: baselines.grid_rpkm(k_, x, args.k),
        }
        for i, (name, fn) in enumerate(runs.items()):
            r = fn(rnd.key(args.seed + 100 + i))
            e = float(metrics.kmeans_error(x, r.centroids))
            out[name] = {"error": e, "distances": r.distances}
            print(f"[cluster] {name:10s} E={e:.4e} distances={r.distances:.3e}")
        rel = metrics.relative_errors({k: v["error"] for k, v in out.items()})
        for k in out:
            out[k]["relative_error"] = rel[k]
        print("[cluster] relative errors:", {k: round(v, 4) for k, v in rel.items()})
    return out


if __name__ == "__main__":
    main()
