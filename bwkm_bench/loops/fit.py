"""``kind: fit`` — a closed loop of in-core ``BWKM(k).fit(x)`` calls, each
with its own key from the seed, over rows drawn once in set-up.

Judged, for the fits the seed samples and the last fit of the window:

* every B1/B2/B3 pass of Algorithm 4 and of each Lloyd over the
  representatives (:mod:`bwkm_bench.loops.passes`);
* every misassignment ``ε`` of Algorithm 4 and of the outer loop against
  its definition (``eps_gap``), the outer loop's decisions against its stop
  rules (``loop_bad``) and each split round against its rule
  (``split_bad``) and its draws (``split_z``), with the capacity and the
  iteration cap the traffic states (:mod:`bwkm_bench.reference.outer`);
* the final partition against the rows: each block's member count
  (``count_bad``) and tight box (``box_bad``) exactly, its representative
  (``rep_gap``, against the float64 mean, relative to the data's extent),
  no two blocks' boxes meeting (``overlaps``), and the last Lloyd's input
  representatives against the same float64 means.
"""

from __future__ import annotations

import random

import torch

from bwkm_bench import data
from bwkm_bench.loops.passes import PassRecorder, control, eps_gap, fit_rules, judge
from bwkm_bench.reference import control as ctl
from bwkm_bench.reference import partition as refp

_KEY_MASK = (1 << 62) - 1


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = int(seed), device
        self.kept: dict[int, tuple] = {}

    def setup(self) -> None:
        import repro_torch

        self.repro_torch = repro_torch
        spec = self.cfg["data"]
        self.x = data.draw(data.mixture(spec, self.device), int(spec["n"]), data.derive(self.seed, "rows"))
        self.rows_per_unit = self.x.shape[0]
        self.k = int(self.cfg["k"])
        self.capacity, self.max_iters = int(self.traffic["capacity"]), int(self.traffic["max_iters"])
        draw = random.Random(data.derive(self.seed, "sample"))
        self.sample = set(draw.sample(range(int(self.traffic["sample_from"])),
                                      int(self.traffic["samples"])))
        self.recorder = PassRecorder()

    def _fit(self, key: int):
        return self.repro_torch.BWKM(k=self.k, device=self.device, seed=key,
                                     capacity=self.capacity, max_iters=self.max_iters).fit(self.x)

    def warm(self) -> None:
        for j in range(int(self.traffic["warmup_units"])):
            self._fit(data.derive(self.seed, "warm", j) & _KEY_MASK)

    def prepare(self, i: int) -> int:
        self.recorder.take()
        self.recorder.on = True
        return data.derive(self.seed, "fit", i) & _KEY_MASK

    def unit(self, i: int, key: int) -> None:
        self._last = (i, self._fit(key).result_)

    def after(self, i: int) -> None:
        self.recorder.on = False
        res = self._last[1]
        rec = (res, *self.recorder.take())
        self.kept = {j: v for j, v in self.kept.items() if j in self.sample}
        self.kept[i] = rec

    def capture(self):
        return self.recorder

    def release(self) -> None:
        self.recorder.on = False

    # ------------------------------------------------------------- judge
    def _extent(self) -> float:
        return float((self.x.amax(0) - self.x.amin(0)).max())

    def _partition(self, res, use_control: bool):
        """The partition numbers, and the float64 means and occupied mask;
        under the control, the block sums are the control's."""
        part = res.metadata["partition"]
        m = part.capacity
        count, psum, lo, hi = refp.member_stats(self.x, part.block_id, m)
        occ = part.active & (count > 0)
        extent = self._extent()
        g = {
            "count_bad": float((part.count.double() != count.double()).sum()),
            "box_bad": float((occ[:, None] & ((part.lo != lo) | (part.hi != hi))).any(1).sum()),
            "overlaps": float(refp.overlaps(part.lo, part.hi, occ)),
        }
        mean = psum / count.clamp(min=1).double()[:, None]
        got = ctl.stats(self.x, part.block_id, m) if use_control else part.psum
        rep = got.double() / part.count.double().clamp(min=1.0)[:, None]
        g["rep_gap"] = float(torch.where(occ[:, None], (rep - mean).abs(), 0.0).max()) / extent
        return g, mean, rep, occ

    def _numbers(self, use_control: bool) -> dict[str, float]:
        out: dict[str, float] = {}

        def bump(g):
            for k, v in g.items():
                out[k] = max(out.get(k, 0.0), v)

        extent = self._extent()
        for res, calls, b1, eps in self.kept.values():
            g, mean, rep, occ = self._partition(res, use_control)
            bump(g)
            bump((control if use_control else judge)(calls, b1, extent))
            bump({"eps_gap": eps_gap(eps, extent, use_control)})
            bump(fit_rules(res, res.metadata["partition"], eps, extent,
                           capacity=self.capacity, max_iters=self.max_iters))
            # the last Lloyd ran over the final partition's representatives,
            # unless the fit stopped by its iteration cap after one more split
            if calls and res.stop_reason != "max-iters":
                reps = rep if use_control else calls[-1].x.double()
                gap = torch.where(occ[:, None], (reps - mean).abs(), 0.0).max()
                bump({"rep_gap": float(gap) / extent})
        return out

    def judge(self) -> dict[str, float]:
        return self._numbers(False)

    def control(self) -> dict[str, float]:
        return self._numbers(True)
