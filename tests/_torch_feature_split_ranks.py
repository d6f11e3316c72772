"""The ranks of ``tests/test_torch_feature_split.py``: four gloo processes on
the CPU that build the ``(4,)``, ``(2, 2)``, ``(2, 2, 1)`` and ``(1, 4)``
meshes in turn and run the port's distributed engine on each, at a width
the model ranks divide and one they do not; and three that take one train
step of a reduced config on a ``(1, 3)`` mesh, whose padded vocabulary 3
does not divide. Each rank saves what it saw for the test to compare. This
module imports torch, numpy and the port only: the ranks import neither
JAX nor the reference.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch
from _torch_fsdp_ranks import B, OPT, S, collect, config, initial_params, inputs

N, K, MAX_ITERS = 4000, 5, 12
DIMS = (8, 5)  # one width the model ranks divide, one they do not
BLOCKS = 16  # block rows of the statistics check
#: name -> (shape, dimension names) of the meshes the four ranks build in turn
MESHES = {
    "4": ((4,), ("data",)),
    "2x2": ((2, 2), ("data", "model")),
    "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}
#: the meshes whose full-data passes hold the same row blocks (4 batch ranks)
SAME_BLOCKS = ("4", "2x2x1")
#: a non-finite entry: row 5 (batch rank 0), column 5 (model rank 1 of 2 at d = 8)
BAD = (5, 5)
#: the train step whose vocabulary stays whole: (arch, mesh, overrides)
VOCAB_CASE = ("qwen3-4b", (1, 3), {})


def points(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    centers = rng.randn(K, d) * 8
    return (centers[rng.randint(0, K, n)] + rng.randn(n, d)).astype(np.float32)


def memberships(n: int, seed: int = 1) -> np.ndarray:
    """Block ids over ``BLOCKS`` rows, the last three left empty."""
    return np.random.RandomState(seed).randint(0, BLOCKS - 3, n).astype(np.int32)


def spawn(world: int, out_dir: pathlib.Path, timeout: float):
    """Start the four mesh ranks (``world`` 4) or the three vocabulary
    ranks (``world`` 3); returns the context to ``collect``."""
    import torch.multiprocessing as mp

    out_dir.mkdir(parents=True, exist_ok=True)
    return mp.start_processes(
        _rank_main, args=(world, f"file://{out_dir}/rendezvous", str(out_dir)), nprocs=world,
        join=False, start_method="spawn",
    ), time.monotonic() + timeout


def _fit(res) -> dict:
    return {"centroids": res.centroids, "stop_reason": res.stop_reason,
            "iterations": res.iterations, "n_blocks": res.n_blocks,
            "distances": res.distances, "weighted_errors": res.weighted_errors,
            "health": res.health.as_dict()}


def _sent(before: dict) -> dict:
    """Bytes sent by kind since ``before`` (a copy of the counts)."""
    from repro_torch.distributed import sharding as sh

    return {k: v["bytes"] - before[k]["bytes"] for k, v in sh.COLLECTIVE_COUNTS.items()}


def _counts() -> dict:
    from repro_torch.distributed import sharding as sh

    return {k: dict(v) for k, v in sh.COLLECTIVE_COUNTS.items()}


def _width(name: str, d: int, out_dir: pathlib.Path, rank: int) -> dict:
    """One width on the current mesh: the layout, the statistics, a fit,
    the split routing's traffic."""
    from repro_torch import random as rnd
    from repro_torch.core import bwkm
    from repro_torch.core import partition as part_mod
    from repro_torch.distributed import dist_bwkm
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import sharded

    x = points(N, d)
    xs = dist_bwkm.shard_points(x, device="cpu")
    rows = sharded._block(N, dist_bwkm.n_data_shards(), sh._mesh_rank())
    cols = sharded._columns(d)
    out = {"rows": rows, "cols": cols, "split": isinstance(xs, sharded.FeatureSlice),
           "part": np.array_equal(xs.numpy(), x[rows[0]:rows[1], cols[0]:cols[1]]),
           "shape": tuple(xs.shape)}
    bid = torch.from_numpy(memberships(N)[rows[0]:rows[1]])
    part = part_mod.create_partition(torch.zeros(1, d), BLOCKS)
    before = _counts()
    st = dist_bwkm.dist_recompute_stats(part, xs, bid)
    out["stats_sent"] = _sent(before)
    out["stats"] = (st.psum, st.count, st.lo, st.hi)
    # the split routing: every block splits on its last column
    plan = part_mod.split_plan(st, torch.ones(BLOCKS, dtype=torch.bool))
    plan = plan._replace(axis=torch.full_like(plan.axis, d - 1))
    before = _counts()
    out["routed"] = dist_bwkm.dist_route_points(xs, bid, plan.fits, plan.axis, plan.mid,
                                                plan.right_row)
    out["route_sent"] = _sent(before)
    out["plan"] = (plan.fits, plan.axis, plan.mid, plan.right_row)
    ckpt = out_dir / f"ckpt_{name}_{d}" / f"rank{rank}"
    before = _counts()
    res = dist_bwkm.fit_distributed(rnd.key(0), xs, bwkm.BWKMConfig(k=K, max_iters=MAX_ITERS),
                                    checkpoint_dir=str(ckpt))
    out["fit_sent"] = _sent(before)
    out["fit"] = _fit(res)
    out["wrote_checkpoint"] = ckpt.exists() and any(ckpt.iterdir())
    return out


def _full_data(name: str) -> dict:
    """``dist_lloyd`` pruned and dense and ``dist_kmeans_parallel`` at d = 8."""
    from repro_torch import random as rnd
    from repro_torch.distributed import dist_bwkm, dist_kmeans_ll

    x = points(N, DIMS[0])
    xs = dist_bwkm.shard_points(x, device="cpu")
    c0 = torch.from_numpy(x[:K].copy())
    out = {}
    for prune in (True, False):
        r = dist_bwkm.dist_lloyd(xs, c0, max_iters=MAX_ITERS, epsilon=1e-6, prune=prune)
        out[f"lloyd_{prune}"] = (r.centroids, r.error, r.iters, r.distances)
    out["assign_step"] = dist_bwkm.dist_assign_step(xs, c0)
    out["ll"] = dist_kmeans_ll.dist_kmeans_parallel(rnd.key(3), xs, K)
    return out


def _non_finite() -> dict:
    """The statistics with one non-finite entry, on the current mesh."""
    from repro_torch.core import partition as part_mod
    from repro_torch.distributed import dist_bwkm
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import sharded

    d = DIMS[0]
    x = points(N, d)
    x[BAD] = np.inf
    xs = dist_bwkm.shard_points(x, device="cpu")
    rows = sharded._block(N, dist_bwkm.n_data_shards(), sh._mesh_rank())
    bid = torch.from_numpy(memberships(N)[rows[0]:rows[1]])
    part = part_mod.create_partition(torch.zeros(1, d), BLOCKS)
    st, n_ok = sharded._recompute_stats_ok(part, xs, bid)
    return {"stats": (st.psum, st.count, st.lo, st.hi), "n_ok": n_ok}


def run_mesh_checks(out_dir: pathlib.Path, rank: int) -> dict:
    """Everything a rank of the four does, mesh by mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import random as rnd
    from repro_torch.core import bwkm
    from repro_torch.distributed import dist_bwkm
    from repro_torch.distributed import sharding as sh

    out: dict = {}
    for name, (shape, names) in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        with sh.use_mesh(mesh):
            rec = {"n_shards": dist_bwkm.n_data_shards(), "coord": tuple(mesh.get_coordinate()),
                   "process_rank": sh._process_rank()}
            for d in DIMS:
                rec[d] = _width(name, d, out_dir, rank)
            rec["full"] = _full_data(name)
            if name in SAME_BLOCKS:  # one shard's statistics lost in round 1
                xs = dist_bwkm.shard_points(points(N, DIMS[0]), device="cpu")
                rec["fault"] = _fit(dist_bwkm.fit_distributed(
                    rnd.key(0), xs, bwkm.BWKMConfig(k=K, max_iters=MAX_ITERS),
                    shard_faults={1: [2]}))
            if name in ("2x2", "1x4"):
                rec["non_finite"] = _non_finite()
            try:  # whole rows that the model axis would split are refused
                dist_bwkm.dist_assign_step(torch.from_numpy(points(N, DIMS[0])),
                                           torch.zeros(K, DIMS[0]))
                rec["whole_refused"] = None
            except ValueError as e:
                rec["whole_refused"] = str(e)
        out[name] = rec
    return out


def run_vocab_step() -> dict:
    """One train step of :data:`VOCAB_CASE` on its mesh: the loss,
    grad-norm, whole first moment and parameters, and the collectives."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import params as layouts
    from repro_torch.distributed import sharding as sh
    from repro_torch.roofline import analysis
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    arch, shape, overrides = VOCAB_CASE
    cfg = config(arch, overrides)
    with sh.use_mesh(init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))):
        full = convert.params_from_numpy(initial_params(cfg), device="cpu")
        psh = layouts.param_shardings(cfg, full)
        params = fsdp.shard_tree(full, psh)
        toks = torch.from_numpy(inputs(cfg, B)[0])
        step = ts.make_train_step(cfg, opt.AdamWConfig(**OPT), param_shardings=psh)
        state = opt.adamw_init(params)
        analysis.collective_bytes(reset=True)
        params, state, m = step(params, state, toks, toks)
        counts = analysis.collective_bytes(reset=True)

        def whole(tree):
            return opt.tree_map(lambda t: t.detach().numpy().copy(), fsdp.full_tree(tree, psh))

        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "counts": counts,
                "params": whole(params), "m": whole(state["m"])}


def _rank_main(rank: int, world: int, init: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        out = run_mesh_checks(pathlib.Path(out_dir), rank) if world == 4 else run_vocab_step()
        out["rank"] = rank
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


__all__ = ["B", "BAD", "BLOCKS", "DIMS", "K", "MAX_ITERS", "MESHES", "N", "S", "SAME_BLOCKS",
           "VOCAB_CASE", "collect", "memberships", "points", "spawn"]
