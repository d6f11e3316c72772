"""Faults planted in the port, as a later change might break it: in a test
process, inside the ranks of the distributed cell's tests, or in
``python3 -m bwkm_bench.control --plant bwkm_bench.tests._faults:<name>``
to read what a fault gives at a cell's own size."""

import sys
import types


def no_exchange() -> None:
    """The exchange between ranks left out: every collective of the port's
    sharded plane returns its own rank's tensor."""
    from repro_torch.distributed import sharding

    sharding._all_reduce = lambda t, *a, **kw: t


def early_stop() -> None:
    """Every fit stops after its first Lloyd over the representatives."""
    import dataclasses

    from repro_torch.engine import driver

    orig = driver.fit_plane
    driver.fit_plane = lambda key, plane, config, **kw: orig(
        key, plane, dataclasses.replace(config, max_iters=1), **kw)


def eps_zero() -> None:
    """The misassignment of the outer loop reads 0 everywhere, so the
    boundary looks empty after the first Lloyd."""
    from repro_torch.core import misassignment

    orig = misassignment.misassignment

    def zero(part, d1, d2):
        return orig(part, d1, d2) * 0.0
    misassignment.misassignment = zero


def half_draws() -> None:
    """Each split round draws half as many blocks as its rule says."""
    from repro_torch.core import misassignment

    orig = misassignment.sample_boundary
    misassignment.sample_boundary = lambda key, eps, n: orig(key, eps, (n + 1) // 2)


def jax_in_judge() -> None:
    """The judge loads a module named ``jax`` after the window."""
    from bwkm_bench.loops import passes

    orig = passes.judge

    def judge(*a, **kw):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return orig(*a, **kw)
    passes.judge = judge
