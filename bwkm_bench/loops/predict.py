"""``kind: predict`` — a closed loop of ``BWKM.from_centroids(c).predict(x)``
over every row, ``chunk_rows`` a launch, with a codebook of ``k`` distinct
rows of the data drawn from the seed.

Judged, for the passes the seed samples and the last pass of the window:
every label is a nearest centre (``label_gap``, see
:mod:`bwkm_bench.reference.kmeans`). ``predict`` returns labels only, so
the distances are the reference's.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from bwkm_bench import data
from bwkm_bench.reference import control as ctl
from bwkm_bench.reference import kmeans as ref


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.device = int(seed), device
        self.kept: dict[int, torch.Tensor] = {}

    def setup(self) -> None:
        import repro_torch

        spec = self.cfg["data"]
        n, k = int(spec["n"]), int(self.cfg["k"])
        self.x = data.draw(data.mixture(spec, self.device), n, data.derive(self.seed, "rows"))
        pick = np.random.default_rng(data.derive(self.seed, "codebook")).choice(n, k, replace=False)
        self.c = self.x[torch.as_tensor(np.sort(pick), device=self.device)].clone()
        self.model = repro_torch.BWKM.from_centroids(
            self.c.cpu().numpy(), device=self.device, chunk_size=int(self.traffic["chunk_rows"]))
        self.rows_per_unit = n
        draw = random.Random(data.derive(self.seed, "sample"))
        self.sample = set(draw.sample(range(int(self.traffic["sample_from"])),
                                      int(self.traffic["samples"])))

    def warm(self) -> None:
        for _ in range(int(self.traffic["warmup_units"])):
            self.model.predict(self.x)

    def prepare(self, i: int) -> None:
        return None

    def unit(self, i: int, _) -> None:
        self._last = self.model.predict(self.x)

    def after(self, i: int) -> None:
        self.kept = {j: v for j, v in self.kept.items() if j in self.sample}
        self.kept[i] = self._last

    def capture(self):
        import contextlib

        return contextlib.nullcontext()

    def release(self) -> None:
        self.model = None

    def judge(self) -> dict[str, float]:
        n = self.x.shape[0]
        gap = missing = 0.0
        for labels in self.kept.values():
            m = min(n, int(labels.shape[0]))
            gap = max(gap, ref.label_gaps(self.x[:m], self.c, labels[:m])[0])
            missing = max(missing, float(abs(n - int(labels.shape[0]))))
        return {"label_gap": gap, "rows_missing": missing}

    def control(self) -> dict[str, float]:
        labels = ctl.top2(self.x, self.c)[0]
        return {"label_gap": ref.label_gaps(self.x, self.c, labels)[0], "rows_missing": 0.0}
