"""``kind: dist_fit`` — the distributed engine over a ``("data",)`` mesh of
``ranks`` processes, one card each (NCCL; gloo on the CPU in the tests):
each rank makes its own ``n / ranks`` rows on its card from the seed, and
every rank drives ``fit_distributed`` — the engine behind
``BWKM(engine="distributed")`` — in a closed loop with the same key a fit.
Rank 0's clock decides when the window closes (one flag all-reduced after
each fit), so every rank runs the same fits. The metrics are the slowest
rank's.

Judged, for the fits the seed samples and the last fit, on every rank:
the partition against all rows (each rank's members counted, summed in
float64 and boxed, then added over the ranks by the reference's own
all-reduces; the boxes may meet, since the rows are routed into the boxes
of a partition built on a sample), the Lloyd passes over the replicated
representatives, every misassignment and the outer loop's stop and split
rules (:mod:`bwkm_bench.loops.passes`, as in ``kind: fit``), and
``rank_gap``: the centroids of every rank against rank 0's, which must be
equal.
"""

from __future__ import annotations

import os
import random
import socket
import tempfile
import time

import torch

from bwkm_bench import data

_KEY_MASK = (1 << 62) - 1


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Loop:
    """One rank's loop; ``rank``/``world`` from the process group."""

    def __init__(self, cell, seed: int, device: torch.device):
        import torch.distributed as dist

        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = int(seed), device
        self.dist = dist
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.kept: dict[int, tuple] = {}

    def setup(self) -> None:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch import random as rnd
        from repro_torch.core.bwkm import BWKMConfig
        from repro_torch.distributed import dist_bwkm, sharding

        from bwkm_bench.loops.passes import PassRecorder

        self.rnd, self.fit_distributed, self.sharding = rnd, dist_bwkm.fit_distributed, sharding
        spec = self.cfg["data"]
        per = int(spec["n"]) // self.world
        mix = data.mixture(spec, self.device)
        self.x = data.draw(mix, per, data.derive(self.seed, "rows", self.rank))
        self.rows_per_unit = per * self.world
        self.capacity, self.max_iters = int(self.traffic["capacity"]), int(self.traffic["max_iters"])
        self.config = BWKMConfig(k=int(self.cfg["k"]), capacity=self.capacity,
                                 max_iters=self.max_iters)
        self.mesh = init_device_mesh(self.device.type, (self.world,), mesh_dim_names=("data",))
        draw = random.Random(data.derive(self.seed, "sample"))
        self.sample = set(draw.sample(range(int(self.traffic["sample_from"])),
                                      int(self.traffic["samples"])))
        self.recorder = PassRecorder()
        self._mesh_ctx = sharding.use_mesh(self.mesh)
        self._mesh_ctx.__enter__()

    def _fit(self, key: int):
        return self.fit_distributed(self.rnd.key(key), self.x, self.config)

    def warm(self) -> None:
        for j in range(int(self.traffic["warmup_units"])):
            self._fit(data.derive(self.seed, "warm", j) & _KEY_MASK)

    def prepare(self, i: int) -> int:
        self.recorder.take()
        self.recorder.on = True
        return data.derive(self.seed, "fit", i) & _KEY_MASK

    def unit(self, i: int, key: int) -> None:
        self._last = self._fit(key)

    def after(self, i: int) -> None:
        self.recorder.on = False
        rec = (self._last, *self.recorder.take())
        self.kept = {j: v for j, v in self.kept.items() if j in self.sample}
        self.kept[i] = rec

    def go_on(self, elapsed: float, seconds: float) -> bool:
        """Rank 0's clock, the same answer on every rank."""
        flag = torch.tensor([1.0 if elapsed < seconds else 0.0], device=self.device)
        self.dist.broadcast(flag, src=0)
        return bool(flag.item() > 0)

    def capture(self):
        return self.recorder

    def release(self) -> None:
        self.recorder.on = False
        self._mesh_ctx.__exit__(None, None, None)

    # ------------------------------------------------------------- judge
    def _numbers(self, use_control: bool) -> dict[str, float]:
        from bwkm_bench.loops.passes import control, eps_gap, fit_rules, judge
        from bwkm_bench.reference import control as ctl
        from bwkm_bench.reference import partition as refp

        dist = self.dist
        ext = torch.stack([self.x.amax(0), -self.x.amin(0)]).double()
        dist.all_reduce(ext, op=dist.ReduceOp.MAX)
        extent = float((ext[0] + ext[1]).max())
        out: dict[str, float] = {}

        def bump(g):
            for k, v in g.items():
                out[k] = max(out.get(k, 0.0), float(v))

        for res, calls, b1, eps in self.kept.values():
            part = res.partition
            m = part.capacity
            count, psum, lo, hi = refp.member_stats(self.x, part.block_id, m)
            count = count.double()
            got = ctl.stats(self.x, part.block_id, m).double() if use_control else None
            for t, op in ((count, "SUM"), (psum, "SUM"), (lo, "MIN"), (hi, "MAX")) + (
                    ((got, "SUM"),) if got is not None else ()):
                dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
            occ = part.active & (count > 0)
            mean = psum / count.clamp(min=1.0)[:, None]
            rep = (got if use_control else part.psum.double()) / part.count.double().clamp(min=1.0)[:, None]
            g = {
                "count_bad": (part.count.double() != count).sum(),
                "box_bad": (occ[:, None] & ((part.lo != lo) | (part.hi != hi))).any(1).sum(),
                "rep_gap": torch.where(occ[:, None], (rep - mean).abs(), 0.0).max() / extent,
            }
            if calls and res.stop_reason != "max-iters":
                reps = rep if use_control else calls[-1].x.double()
                g["rep_gap"] = max(float(g["rep_gap"]), float(
                    torch.where(occ[:, None], (reps - mean).abs(), 0.0).max() / extent))
            c = res.centroids.double()
            c0 = c.clone()
            dist.broadcast(c0, src=0)
            g["rank_gap"] = (c - c0).abs().max() / extent
            bump(g)
            bump((control if use_control else judge)(calls, b1, extent))
            bump({"eps_gap": eps_gap(eps, extent, use_control)})
            bump(fit_rules(res, part, eps, extent, capacity=self.capacity,
                           max_iters=self.max_iters))
        # every rank's numbers, the largest
        names = sorted(out)
        vals = torch.tensor([out[k] for k in names], dtype=torch.float64, device=self.device)
        dist.all_reduce(vals, op=dist.ReduceOp.MAX)
        return dict(zip(names, vals.tolist()))

    def judge(self) -> dict[str, float]:
        return self._numbers(False)

    def control(self) -> dict[str, float]:
        return self._numbers(True)


def _rank(rank: int, world: int, port: int, name, seeds: list, seconds: float, trace: bool,
          start_wall: float, out_dir: str, backend: str, with_control: bool, plant) -> None:
    """One rank: its process group, then one run a seed, each record to
    ``out_dir``. ``plant`` (a test's ``"module:function"``) breaks the port
    in the rank before the runs, as a later change might."""
    import importlib
    import pickle

    from bwkm_bench import harness, spec

    harness.prepare_environment()
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(harness.CACHE / f"autotune.rank{rank}.json")
    import torch.distributed as dist

    cuda = backend == "nccl"
    if cuda:
        torch.cuda.set_device(rank)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    torch.set_num_threads(1)  # ranks sharing the host's cores
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    if plant:
        mod, fn = plant.split(":")
        getattr(importlib.import_module(mod), fn)()
    try:
        cell = spec.cell(name) if isinstance(name, str) else name
        for j, seed in enumerate(seeds):
            # the first run's set-up is measured from the parent's start
            t0 = time.perf_counter() - (time.time() - start_wall) if j == 0 else time.perf_counter()
            rec, numbers, peak = harness.run_local(cell, seed=seed, seconds=seconds, trace=trace,
                                                   device=device, t0=t0,
                                                   with_control=with_control)
            rec["peak"], rec["numbers"] = peak, numbers
            # what this rank loaded up to now, its judge and control included
            rec["forbidden"] = harness.forbidden_modules()
            with open(os.path.join(out_dir, f"seed{j}.rank{rank}.pkl"), "wb") as f:
                pickle.dump(rec, f)
    finally:
        dist.destroy_process_group()


def run_seeds(cell, *, seeds: list, seconds: float, trace: bool, t0: float,
              device_type: str = "cuda", with_control: bool = False, deadline_s: float = 330.0,
              plant: str | None = None) -> list:
    """Start ``traffic["ranks"]`` ranks, run each seed on all of them, wait
    for all, and return per seed ``(record of the slowest rank, numbers,
    the largest peak)``."""
    import pickle

    import torch.multiprocessing as mp

    world = int(cell.traffic["ranks"])
    backend = "nccl" if device_type == "cuda" else "gloo"
    compile_s = 0.0
    if device_type == "cuda":
        from repro_torch.kernels import _build

        tb = time.perf_counter()
        if _build.build_all():  # once, before the ranks load the libraries
            compile_s = time.perf_counter() - tb
    start_wall = time.time() - (time.perf_counter() - t0)
    out = []
    with tempfile.TemporaryDirectory(prefix="bwkm_bench_ranks_") as out_dir:
        ctx = mp.start_processes(
            _rank, args=(world, _free_port(), cell.name if device_type == "cuda" else cell,
                         list(seeds), seconds, trace, start_wall, out_dir, backend,
                         with_control, plant),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"the {world} ranks did not finish in {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        for j in range(len(seeds)):
            recs = []
            for r in range(world):
                with open(os.path.join(out_dir, f"seed{j}.rank{r}.pkl"), "rb") as f:
                    recs.append(pickle.load(f))
            slow = max(recs, key=lambda r: r["window_s"] / max(r["units"], 1))
            slow["compile_s"] = compile_s if j == 0 else 0.0
            # the ranks' set-up runs from the parent's start, the build in it
            slow["setup_s"] = max(r["setup_s"] for r in recs) - slow["compile_s"]
            slow["forbidden"] = sorted({m for r in recs for m in r["forbidden"]})
            slow["failed"] = max(r["failed"] for r in recs)
            if with_control:
                slow["control"] = recs[0].get("control")
            out.append((slow, recs[0]["numbers"], max(r["peak"] for r in recs)))
    return out


def run(cell, *, seed: int, **kw):
    """One seed of :func:`run_seeds`: ``(record, numbers, peak)``."""
    return run_seeds(cell, seeds=[seed], **kw)[0]
