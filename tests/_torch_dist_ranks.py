"""The ranks of ``tests/test_torch_distributed.py``: W processes on the CPU,
one gloo group over a ``file://`` rendezvous, each running the port's
distributed engine on its own rows and saving what it saw for the test to
compare. This module imports torch, numpy and the port only, so the ranks
import neither JAX nor the reference.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch

N, N_EVEN, D, K = 4001, 4000, 6, 5  # an uneven and an even row count
M = 16  # block rows of the statistics check
MAX_ITERS = 12


def points(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    centers = rng.randn(K, D) * 8
    return (centers[rng.randint(0, K, n)] + rng.randn(n, D)).astype(np.float32)


def memberships(n: int, seed: int = 1) -> np.ndarray:
    """Block ids over ``M`` rows, the last three left empty."""
    return np.random.RandomState(seed).randint(0, M - 3, n).astype(np.int32)


def spawn(world: int, out_dir: pathlib.Path, timeout: float):
    """Start ``world`` ranks; returns the context to :func:`collect`."""
    import torch.multiprocessing as mp

    out_dir.mkdir(parents=True, exist_ok=True)
    init = f"file://{out_dir}/rendezvous"
    return mp.start_processes(
        _rank_main, args=(world, init, str(out_dir)), nprocs=world, join=False,
        start_method="spawn",
    ), time.monotonic() + timeout


def collect(started, out_dir: pathlib.Path) -> list[dict]:
    """Join the ranks under the deadline (a hang fails: every rank is
    terminated) and load each one's record."""
    ctx, deadline = started
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"the ranks did not finish in time: {out_dir}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(len(ctx.processes))]


class _Recorded:
    """Patches ``sharded.ShardedPlane`` / ``ShardedLLSession`` with
    subclasses that keep every instance, so a rank can read a fit's
    statistics rounds and a k-means|| session's final φ."""

    def __init__(self):
        from repro_torch.engine import sharded

        self.sharded = sharded
        self.planes, self.sessions = [], []

    def __enter__(self):
        planes, sessions, sharded = self.planes, self.sessions, self.sharded

        class Plane(sharded.ShardedPlane):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.rounds = []
                planes.append(self)

            def _stats_round(self, part_in, bid_in, round_index):
                out = super()._stats_round(part_in, bid_in, round_index)
                self.rounds.append((part_in, bid_in.clone(), out))
                return out

        class Session(sharded.ShardedLLSession):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                sessions.append(self)

        self.saved = sharded.ShardedPlane, sharded.ShardedLLSession
        sharded.ShardedPlane, sharded.ShardedLLSession = Plane, Session
        return self

    def __exit__(self, *exc):
        self.sharded.ShardedPlane, self.sharded.ShardedLLSession = self.saved


def _fit_record(res) -> dict:
    return {
        "centroids": res.centroids, "stop_reason": res.stop_reason,
        "iterations": res.iterations, "n_blocks": res.n_blocks,
        "distances": res.distances, "weighted_errors": res.weighted_errors,
        "health": res.health.as_dict(),
    }


def _rounds(plane) -> list:
    return [(bid, out.psum, out.count, out.lo, out.hi, int(out_in.capacity))
            for out_in, bid, out in plane.rounds]


def run_checks(world: int, rank: int) -> dict:
    """Everything a rank does, under the mesh; returns its record."""
    import repro_torch
    from repro_torch import random as rnd
    from repro_torch.api import engines
    from repro_torch.core import bwkm
    from repro_torch.core import partition as part_mod
    from repro_torch.distributed import dist_bwkm, dist_kmeans_ll
    from repro_torch.engine import sharded

    out: dict = {"rank": rank, "n_shards": dist_bwkm.n_data_shards()}
    cfg = bwkm.BWKMConfig(k=K, max_iters=MAX_ITERS)
    # statistics with given memberships, an uneven and an even n
    for n in (N, N_EVEN):
        xs = dist_bwkm.shard_points(points(n), device="cpu")
        start, stop = sharded._block(n, world, rank)
        bid = torch.from_numpy(memberships(n)[start:stop])
        part = part_mod.create_partition(torch.zeros(1, D), M)
        st = dist_bwkm.dist_recompute_stats(part, xs, bid)
        out[f"stats{n}"] = (st.psum, st.count, st.lo, st.hi)
        out[f"rows{n}"] = xs.shape[0]
    # the default fit, recorded round by round, at the uneven n
    x = dist_bwkm.shard_points(points(N), device="cpu")
    with _Recorded() as rec:
        res = dist_bwkm.fit_distributed(rnd.key(0), x, cfg)
    out["fit"] = _fit_record(res)
    out["fit_rounds"] = _rounds(rec.planes[0])
    out["fit_bid"] = rec.planes[0].bid
    # the facade: auto picks the distributed engine under the mesh
    out["selected"] = engines.select_engine(points(8))
    model = repro_torch.BWKM(k=K, device="cpu", max_iters=MAX_ITERS).fit(points(N))
    out["facade"] = (model.engine_, model.centroids_)
    # full-data Lloyd, pruned and dense, from the first K rows
    c0 = torch.from_numpy(points(N)[:K].copy())
    for prune in (True, False):
        r = dist_bwkm.dist_lloyd(x, c0, max_iters=MAX_ITERS, epsilon=1e-6, prune=prune)
        out[f"lloyd_{prune}"] = (r.centroids, r.error, r.iters, r.distances)
    out["assign_step"] = dist_bwkm.dist_assign_step(x, c0)
    # k-means||, twice
    with _Recorded() as rec:
        out["ll"] = [dist_kmeans_ll.dist_kmeans_parallel(rnd.key(3), x, K) for _ in range(2)]
    out["ll_phi"] = [float(s.phi) for s in rec.sessions]
    # shard faults on the even n: one shard lost in round 1
    xe = dist_bwkm.shard_points(points(N_EVEN), device="cpu")
    if world == 4:
        with _Recorded() as rec:
            res = dist_bwkm.fit_distributed(rnd.key(0), xe, cfg, shard_faults={1: [2]})
        out["fault"] = _fit_record(res)
        part_in, bid_in, part_out = rec.planes[0].rounds[1]
        out["fault_round"] = (part_in, bid_in, part_out)
        bad = points(N_EVEN)
        bad[5] = np.inf  # on rank 0
        res = dist_bwkm.fit_distributed(rnd.key(0), dist_bwkm.shard_points(bad, device="cpu"), cfg)
        out["inf"] = _fit_record(res)
    # a loss above max_shard_loss_frac raises on every rank
    try:
        dist_bwkm.fit_distributed(rnd.key(0), xe, cfg, shard_faults={1: [world - 1]},
                                  max_shard_loss_frac=0.2)
        out["abort"] = None
    except sharded.ShardLossError as e:
        out["abort"] = str(e)
    return out


def _rank_main(rank: int, world: int, init: str, out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as sh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        with sh.use_mesh(mesh):
            out = run_checks(world, rank)
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
