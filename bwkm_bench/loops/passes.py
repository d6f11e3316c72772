"""Record the port's kernel passes inside a unit and judge each one.

A :class:`PassRecorder` wraps, from outside, the seams the port's Lloyd,
Algorithm 4 and Algorithm 5's outer loop call through: ``ops.assign_update``
(B2), ``ops.assign_update_pruned`` (B3), ``ops.assign_top2`` (B1),
``lloyd.weighted_lloyd``, ``misassignment.misassignment`` and
``partition.split_plan``. While it is recording it keeps references to each
call's inputs and outputs (no copy, no sync); the port makes new tensors at
every step, so they stay as they were.

:func:`judge` then holds every pass to its definition (see
:mod:`bwkm_bench.reference.kmeans`): its labels are nearest centres, its
distances and statistics are the float64 ones, each Lloyd update is the
weighted mean of the previous pass's statistics, and a Lloyd call returns
the centres of its last pass. :func:`control` is the same judge with every
pass's outputs replaced by the TF32 control's. :func:`eps_gap` holds every
misassignment ``ε`` (Algorithm 4's and the outer loop's) to its definition
from the float64 distances of the pass it reads, and :func:`fit_rules` each
fit's outer loop to its stop and split rules
(:mod:`bwkm_bench.reference.outer`).
"""

from __future__ import annotations

import contextlib

from bwkm_bench.reference import control as ctl
from bwkm_bench.reference import kmeans as ref
from bwkm_bench.reference import outer
from bwkm_bench.trace import patched

__all__ = ["PassRecorder", "control", "eps_gap", "fit_rules", "judge", "split_round"]


class _Call:
    def __init__(self, x, w, c0):
        self.x, self.w, self.c0 = x, w, c0
        self.passes = []  # (c, out, active or None)
        self.out = None


class _Eps:
    """One misassignment call: its partition (without the rows'
    memberships, which the judge does not read and the window should not
    keep alive), the distances it read, its ``ε``, the pass those distances
    came from (``src``: ``(x, c)``), the outer loop's Lloyd call whose
    result it read (``None`` in Algorithm 4) and the split round that
    followed it (``(chosen, plan)``)."""

    def __init__(self, part, d1, d2, eps, src, lloyd):
        self.part = part._replace(block_id=None)
        self.d1, self.d2, self.eps = d1, d2, eps
        self.src, self.lloyd = src, lloyd
        self.split = None


class PassRecorder:
    """Keeps the Lloyd calls (``calls``), the B1 calls outside Lloyd
    (``b1``: ``(x, c, (assign, d1, d2))``) and the misassignment calls
    (``eps``) made while :attr:`on`."""

    def __init__(self):
        from repro_torch.core import lloyd, misassignment, partition
        from repro_torch.kernels import ops

        self._mods = (ops, lloyd, misassignment, partition)
        self.on = False
        self.calls: list[_Call] = []
        self.b1: list = []
        self.eps: list[_Eps] = []
        self._open: list[_Call] = []
        self._stack = None

    def take(self) -> tuple[list, list, list]:
        out = self.calls, self.b1, self.eps
        self.calls, self.b1, self.eps = [], [], []
        return out

    def _lloyd(self, fn):
        def inner(x, w, init_centroids, **kw):
            if not self.on:
                return fn(x, w, init_centroids, **kw)
            call = _Call(x, w, init_centroids)
            self._open.append(call)
            try:
                res = fn(x, w, init_centroids, **kw)
            finally:
                self._open.pop()
            call.out = res.centroids
            self.calls.append(call)
            return res
        return inner

    def _pass(self, fn, pruned):
        def inner(x, w, c, *rest):
            out = fn(x, w, c, *rest)
            if self.on and self._open:
                self._open[-1].passes.append((c, out, rest[1] if pruned else None))
            return out
        return inner

    def _top2(self, fn):
        def inner(x, c):
            out = fn(x, c)
            if self.on and not self._open:
                self.b1.append((x, c, out))
            return out
        return inner

    def _misassignment(self, fn):
        def inner(part, d1, d2):
            eps = fn(part, d1, d2)
            if self.on and not self._open:
                last = self.calls[-1] if self.calls else None
                src = lloyd = None
                if last is not None and last.passes and last.passes[-1][1][1] is d1:
                    src, lloyd = (last.x, last.passes[-1][0]), last
                elif self.b1 and self.b1[-1][2][1] is d1:
                    src = self.b1[-1][:2]
                self.eps.append(_Eps(part, d1, d2, eps, src, lloyd))
            return eps
        return inner

    def _split_plan(self, fn):
        def inner(part, chosen):
            plan = fn(part, chosen)
            e = self.eps[-1] if self.on and self.eps else None
            # the round that follows an outer iteration's misassignment
            if (e is not None and e.lloyd is not None and e.split is None
                    and e.lloyd is self.calls[-1] and e.part.lo is part.lo
                    and e.part.count is part.count):
                e.split = (chosen, plan)
            return plan
        return inner

    def __enter__(self):
        ops, lloyd, misassignment, partition = self._mods
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(patched(misassignment, "misassignment", self._misassignment))
        self._stack.enter_context(patched(partition, "split_plan", self._split_plan))
        self._stack.enter_context(patched(lloyd, "weighted_lloyd", self._lloyd))
        self._stack.enter_context(patched(ops, "assign_update", lambda f: self._pass(f, False)))
        self._stack.enter_context(patched(ops, "assign_update_pruned",
                                          lambda f: self._pass(f, True)))
        self._stack.enter_context(patched(ops, "assign_top2", self._top2))
        return self

    def __exit__(self, *exc):
        self._stack.close()


def _gaps(calls, b1, extent: float, outputs) -> dict[str, float]:
    g = dict.fromkeys(("label_gap", "dist_gap", "sum_gap", "update_gap"), 0.0)

    def bump(name, v):
        g[name] = max(g[name], float(v))

    for call in calls:
        prev = None
        for c, out, active in call.passes:
            o = outputs(call.x, call.w, c, out)
            lg, dg = ref.label_gaps(call.x, c, o[0], o[1], o[2], where=active)
            bump("label_gap", lg)
            bump("dist_gap", dg)
            bump("sum_gap", ref.sum_gap(call.x, call.w, o[0], o[3], o[4]))
            if prev is not None and c is not prev[0]:
                want = ref.next_centroids(prev[1][3], prev[1][4], prev[0])
                bump("update_gap", (c.double() - want).abs().max() / extent)
            prev = (c, o)
        last = call.passes[-1][0] if call.passes else call.c0
        bump("update_gap", (call.out.double() - last.double()).abs().max() / extent)
    for x, c, out in b1:
        o = outputs(x, None, c, out)
        lg, dg = ref.label_gaps(x, c, o[0], o[1], o[2])
        bump("label_gap", lg)
        bump("dist_gap", dg)
    return g


def judge(calls, b1, extent: float) -> dict[str, float]:
    """The four pass numbers over the recorded calls, the port's outputs."""
    return _gaps(calls, b1, extent, lambda x, w, c, out: (out[0], out[1], out[2],
                                                         *(out[3:5] if w is not None else ())))


def control(calls, b1, extent: float) -> dict[str, float]:
    """The same numbers with each pass's outputs made by the TF32 control
    from the same inputs."""
    def outputs(x, w, c, out):
        lab, d1, d2 = ctl.top2(x, c)
        if w is None:
            return lab, d1, d2
        return (lab, d1, d2, *ctl.sums(x, w, lab, c.shape[0]))
    return _gaps(calls, b1, extent, outputs)


def eps_gap(eps_recs, extent: float, use_control: bool = False) -> float:
    """The widest gap of a misassignment ``ε`` from its definition in
    float64, relative to the data's extent. The definition reads the top-2
    distances that the pass reported (they are judged against float64 by
    ``dist_gap`` with that pass; a difference of square roots of them would
    lift their rounding near 0 to its square root). Under the control, the
    pass's distances and ``ε`` are the control's. An ``ε`` whose distances
    no recorded pass reported reads inf."""
    g = 0.0
    for e in eps_recs:
        if e.src is None:
            return float("inf")
        occ = (e.part.count > 0) & e.part.active
        if use_control:
            d1, d2 = ctl.top2(*e.src)[1:]
            got = ctl.misassignment(e.part.lo, e.part.hi, occ, d1, d2)
        else:
            d1, d2, got = e.d1, e.d2, e.eps
        want = outer.misassignment(e.part.lo, e.part.hi, occ, d1, d2)
        g = max(g, float((got.double() - want).abs().max()) / extent)
    return g


def split_round(e, capacity: int, max_draws: int | None = None):
    """``(split_bad, mean, variance bound, blocks cut)`` of the split round
    after the outer iteration ``e``: its draws are ``min(|F|, free rows)``,
    capped at ``max_draws``."""
    chosen, plan = e.split
    part = e.part
    nb = int(part.n_blocks)
    draws = min(int((e.eps > 0).sum()), capacity - nb)
    if max_draws is not None:
        draws = min(draws, max_draws)
    bad = outer.split_bad(e.eps, chosen, plan.fits, plan.n_new, nb, part.active, part.count,
                          capacity, draws)
    mean, var = outer.draw_moments(e.eps, draws)
    return bad, mean, var, int(chosen.sum())


def shortfall_z(rounds) -> float:
    """How many bounds on the standard deviation the blocks cut over the
    ``(mean, variance bound, cut)`` rounds fall short of their mean (0 where
    they do not)."""
    mean = sum(r[0] for r in rounds)
    var = sum(r[1] for r in rounds)
    got = sum(r[2] for r in rounds)
    return max(0.0, (mean - got) / var ** 0.5) if var > 0 else 0.0


def fit_rules(res, part, eps_recs, extent: float, *, capacity: int, max_iters: int) -> dict:
    """One fit's outer loop against Algorithm 5's rules: ``loop_bad`` (stop
    rules), ``split_bad`` (split rule), ``split_z`` (blocks cut against the
    draws' mean) and the result's centroids against its last Lloyd's
    (``update_gap``). ``part`` is the result's final partition."""
    its = [e for e in eps_recs if e.lloyd is not None]
    rounds, draws, split_bad = [], [], 0
    for e in its:
        new = None
        if e.split is not None:
            bad, mean, var, cut = split_round(e, capacity)
            split_bad += bad
            draws.append((mean, var, cut))
            new = int(e.split[1].n_new)
        rounds.append((bool((e.eps > 0).any()), int(e.part.n_blocks), new))
    g = {"loop_bad": float(outer.fit_loop_bad(int(res.iterations), res.stop_reason, rounds,
                                              int(part.n_blocks), capacity, max_iters)),
         "split_bad": float(split_bad), "split_z": shortfall_z(draws)}
    if its:
        gap = (res.centroids.double() - its[-1].lloyd.out.double()).abs().max() / extent
        g["update_gap"] = float(gap)
    return g
