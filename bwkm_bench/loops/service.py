"""``kind: service`` — the online service as a user runs it on a drifting
stream: a ``BWKMSession`` bootstrapped in set-up on a first batch and a
session key that are the same for every seed (``bootstrap_seed``), then
``batch_rows``-row batches drawn from the seed arriving at ``rate_per_s``
(an open loop, kept by the harness: batch ``i`` is due ``i / rate`` after
the window opens, and every batch due inside the window is served, late or
not), one ``partial_fit`` each; from batch ``drift_from_batch`` on every
feature is shifted by ``drift_sd`` of its standard deviation; a checkpoint
every ``checkpoint_every`` batches (into a directory under ``$TMPDIR``).
The number of batches, and so the growth of the partition by the refits,
is the same for any speed of the port.

Judged, for the batches the seed samples, the first batch of the window
that refits and the last batch, by following the update from the
session's state before it (the service keeps no member points, so its
state is where a reference has to start):

* the decayed partition with the batch routed into its boxes
  (:func:`bwkm_bench.reference.partition.route`) and folded in float64,
  against the representatives and weights the tracking Lloyd received
  (``rep_gap``, ``weight_gap``) and against the state after the batch;
* the misassignment ``ε`` against its definition (``eps_gap``); the
  decision to refit against its rule (``loop_bad``: the boundary holds more
  than ``refit_boundary_frac`` of the weight, and a block and a free row
  exist); a refit's split round against its rule (``split_bad``, which also
  counts blocks the state after the batch adds beyond the plan) and its
  draws (``split_z``), ``min(|F|, free rows, max_splits_per_refit)``;
* a refit's virtual split of the blocks its plan names, against the state
  after the batch (``box_bad`` exactly, ``rep_gap``, ``weight_gap``);
* every Lloyd pass of the tracking and refit Lloyd
  (:mod:`bwkm_bench.loops.passes`); the session's centroids are the last
  Lloyd's output.
"""

from __future__ import annotations

import random
import shutil
import tempfile

import torch

from bwkm_bench import data
from bwkm_bench.loops.passes import PassRecorder, control, eps_gap, judge, shortfall_z, split_round
from bwkm_bench.reference import control as ctl
from bwkm_bench.reference import partition as refp


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = int(seed), device
        self.kept: dict[int, tuple] = {}
        self.first_refit = None

    def setup(self) -> None:
        from repro_torch.core.bwkm import BWKMConfig
        from repro_torch.service import BWKMSession, ServiceConfig, save_session

        t = self.traffic
        self.save_session = save_session
        self.mix = data.mixture(self.cfg["data"], self.device)
        std = data.mixture_std(self.mix)
        self.shift = torch.as_tensor(float(t["drift_sd"]) * std, dtype=torch.float32,
                                     device=self.device)
        self.rows_per_unit = int(t["batch_rows"])
        self.capacity = int(t["capacity"])
        self.config = ServiceConfig(
            base=BWKMConfig(k=int(self.cfg["k"]), max_iters=int(t["boot_max_iters"]),
                            capacity=self.capacity),
            decay=float(t["decay"]), max_splits_per_refit=int(t["max_splits_per_refit"]),
            refit_boundary_frac=float(t["refit_boundary_frac"]),
            seed=data.derive(int(t["bootstrap_seed"]), "session") & ((1 << 62) - 1),
        )
        self.session = BWKMSession(self.config, device=self.device)
        # the deployment's state when the window's stream begins: the same
        # bootstrap for every seed, so that every seed's batches cost alike
        boot = data.draw(self.mix, self.rows_per_unit, data.derive(int(t["bootstrap_seed"]), "boot"))
        self.session.partial_fit(boot)
        self.next_batch = 2
        self.ckpt = tempfile.mkdtemp(prefix="bwkm_bench_service_")
        draw = random.Random(data.derive(self.seed, "sample"))
        self.sample = set(draw.sample(range(int(t["sample_from"])), int(t["samples"])))
        self.recorder = PassRecorder()

    def _batch(self, b: int) -> torch.Tensor:
        """Batch ``b`` of the stream (the bootstrap is batch 1)."""
        x = data.draw(self.mix, self.rows_per_unit, data.derive(self.seed, "batch", b))
        return x.add_(self.shift) if b >= int(self.traffic["drift_from_batch"]) else x

    def warm(self) -> None:
        for _ in range(int(self.traffic["warmup_units"])):
            self.session.partial_fit(self._batch(self.next_batch))
            self.next_batch += 1

    def prepare(self, i: int):
        x = self._batch(self.next_batch)
        self.recorder.take()
        self.recorder.on = True
        return x, self.session.state

    def unit(self, i: int, prepared) -> None:
        self._last = (prepared, self.session.partial_fit(prepared[0]))

    def after(self, i: int) -> None:
        self.recorder.on = False
        (x, before), metrics = self._last
        calls, _, eps = self.recorder.take()
        rec = (x, before, self.session.state, metrics, calls, eps)
        if metrics["refit"] and self.first_refit is None:
            self.first_refit = i
        keep = self.sample | {self.first_refit}
        self.kept = {j: v for j, v in self.kept.items() if j in keep}
        self.kept[i] = rec
        every = int(self.traffic["checkpoint_every"])
        if self.next_batch % every == 0:
            self.save_session(self.ckpt, self.session, cursor=self.next_batch)
        self.next_batch += 1

    def capture(self):
        return self.recorder

    def release(self) -> None:
        self.recorder.on = False
        shutil.rmtree(self.ckpt, ignore_errors=True)

    # ------------------------------------------------------------- judge
    def _rules(self, eps, g: dict) -> object:
        """The refit's decision and split round against their rules; the
        block mask the plan splits (``None`` without a refit)."""
        its = [e for e in eps if e.lloyd is not None]
        if len(its) != 1:  # one misassignment of the tracking Lloyd's result a batch
            g["loop_bad"] += 1
            return None
        e = its[0]
        w = e.lloyd.w.double()
        pos = e.eps > 0
        frac = float(torch.where(pos, w, 0.0).sum() / w.sum().clamp(min=1e-30))
        free = self.capacity - int(e.part.n_blocks)
        want = frac > self.config.refit_boundary_frac and bool(pos.any()) and free > 0
        # a share within rounding of the threshold may go either way
        if abs(frac - self.config.refit_boundary_frac) > 1e-6 and want != (e.split is not None):
            g["loop_bad"] += 1
        if e.split is None:
            return None
        bad, mean, var, cut = split_round(e, self.capacity, self.config.max_splits_per_refit)
        g["split_bad"] += bad
        g["split_z"] = max(g["split_z"], shortfall_z([(mean, var, cut)]))
        return e.split[1]

    def _follow(self, x, before, after, calls, eps, use_control: bool) -> dict[str, float]:
        """The numbers of one batch, followed from the state ``before``;
        under the control, the block sums and decayed weights are the
        control's."""
        gamma = self.config.decay
        p0, p1 = before.partition, after.partition
        live, m = int(p0.n_blocks), p0.capacity
        bid = refp.route(x, p0.lo[:live], p0.hi[:live], p0.active[:live])
        count_b, psum_b, lo_b, hi_b = refp.member_stats(x, bid, m)
        count = p0.count.double() * gamma + count_b.double()
        psum = p0.psum.double() * gamma + psum_b
        lo, hi = torch.minimum(p0.lo, lo_b), torch.maximum(p0.hi, hi_b)
        if use_control:  # the control's sums and decayed weights
            ctrl = p0.psum.double() * gamma + ctl.stats(x, bid, m).double()
            ctrl_w = ctl.tf32(p0.count * gamma).double() + count_b.double()
        extent = float((x.amax(0) - x.amin(0)).max())
        g = {"split_bad": 0.0, "rep_gap": 0.0, "weight_gap": 0.0, "loop_bad": 0.0, "split_z": 0.0,
             "eps_gap": eps_gap(eps, extent, use_control)}

        def stats_gap(want_psum, want_count, got_reps, got_w, mask):
            rep = want_psum / want_count.clamp(min=1.0)[:, None]
            rg = torch.where(mask[:, None], (got_reps.double() - rep).abs(), 0.0).max() / extent
            wg = ((got_w.double() - want_count).abs() / want_count.max().clamp(min=1e-30)).max()
            g["rep_gap"] = max(g["rep_gap"], float(rg))
            g["weight_gap"] = max(g["weight_gap"], float(wg))

        def reps_of(got_psum, got_count):
            return got_psum.double() / got_count.double().clamp(min=1.0)[:, None]

        if calls:  # the tracking Lloyd's input: the merged partition's representatives
            got, got_w = (reps_of(ctrl, ctrl_w), ctrl_w) if use_control else (calls[0].x, calls[0].w)
            stats_gap(psum, count, got, got_w, p0.active & (count > 0))
        plan = self._rules(eps, g)
        new = int(p1.n_blocks) - live
        g["split_bad"] += abs(new - (int(plan.n_new) if plan is not None else 0))
        if plan is not None and new > 0:  # a refit: the blocks its plan splits
            chosen = plan.fits
            right = p1.count > 0  # which child the port gave the mass, for ties
            if use_control:
                ctrl, ctrl_w = refp.virtual_split(ctrl, ctrl_w, lo, hi, chosen, live, right)[:2]
            psum, count, lo, hi = refp.virtual_split(psum, count, lo, hi, chosen, live, right)
            mask = p1.active & (count > 0)
            if len(calls) > 1:  # the refit Lloyd's input
                got, got_w = ((reps_of(ctrl, ctrl_w), ctrl_w) if use_control
                              else (calls[1].x, calls[1].w))
                stats_gap(psum, count, got, got_w, mask)
        g["box_bad"] = float((p1.active[:, None] & ((p1.lo != lo) | (p1.hi != hi))).any(1).sum())
        got, got_w = ((reps_of(ctrl, ctrl_w), ctrl_w) if use_control
                      else (reps_of(p1.psum, p1.count), p1.count))
        stats_gap(psum, count, got, got_w, p1.active & (count > 0))
        for k, v in (control if use_control else judge)(calls, [], extent).items():
            g[k] = max(g.get(k, 0.0), v)
        if calls:  # the session's centroids are the last Lloyd's
            gap = (after.centroids.double() - calls[-1].out.double()).abs().max() / extent
            g["update_gap"] = max(g["update_gap"], float(gap))
        return g

    def _numbers(self, use_control: bool) -> dict[str, float]:
        out: dict[str, float] = {}
        for x, before, after, _, calls, eps in self.kept.values():
            for k, v in self._follow(x, before, after, calls, eps, use_control).items():
                out[k] = max(out.get(k, 0.0), v)
        return out

    def judge(self) -> dict[str, float]:
        return self._numbers(False)

    def control(self) -> dict[str, float]:
        return self._numbers(True)
