"""The port's public names and contracts against the reference's.

Each module of ``repro_torch`` that has a counterpart in ``repro`` exports
the reference's names, less those of modules still to be ported and those
dropped by design; the registries, ``FitResult.schema()``, the weight-blind
init's warning and the small helpers of ``core`` agree with the reference.
"""

import importlib
import os
import pathlib
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import bounds as jbounds
from repro.core import misassignment as jmis
from repro_torch.api import engines, inits
from repro_torch.core import bounds, bwkm, misassignment

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"

#: modules of the port that have no counterpart in the reference
PORT_ONLY = {"convert", "device", "random", "scan", "kernels._build"}
#: names whose ROADMAP A item is still open: none since the dry run
#: (``make_production_mesh``, ``input_specs``, ``cache_specs``) was ported
NOT_YET: set[str] = set()
#: names dropped by design: the port selects no impl and has no prune knob
#: (``*_pallas`` entry points are matched by suffix); its mesh has no model
#: axis, so the helpers that place tensors on one are left out
BY_DESIGN = {"backend", "pallas_available", "resolve_impl", "set_default_impl",
             "resolve_prune", "set_default_prune",
             "named_sharding", "logical_to_spec", "shard_map"}


def _port_modules():
    names = []
    for path in sorted(SRC.rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        parts = parts[:-1] if parts[-1] == "__init__" else parts
        name = ".".join(parts)
        if name not in PORT_ONLY:
            names.append(name)
    return names


def _import_reference(name):
    """``repro.<name>``, with ``XLA_FLAGS`` kept as it was: importing
    ``repro.launch.dryrun`` asks for 512 host devices, which would reach
    this process's JAX backend if it is not up yet, and every process the
    later tests start."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.mark.parametrize("name", _port_modules())
def test_each_module_exports_the_reference_names(name):
    suffix = f".{name}" if name else ""
    ref = _import_reference(f"repro{suffix}")
    port = importlib.import_module(f"repro_torch{suffix}")
    want = {n for n in getattr(ref, "__all__", ())
            if n not in NOT_YET | BY_DESIGN and not n.endswith("_pallas")}
    assert want <= set(getattr(port, "__all__", ())), sorted(want - set(port.__all__))
    for n in want:
        assert getattr(port, n, None) is not None, n


def test_version_is_the_packages():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert repro_torch.__version__ == meta["project"]["version"]


def test_fit_result_schema_is_the_references():
    args = (np.zeros((2, 2), np.float32), 0.0, 0, "max-iters", "incore")
    assert repro_torch.FitResult(*args).schema() == repro.FitResult(*args).schema()


def test_registries_hold_the_reference_names():
    assert set(repro_torch.list_inits()) == set(repro.list_inits())
    assert set(repro_torch.list_engines()) == set(repro.list_engines())
    assert repro_torch.get_engine("distributed").name == "distributed"
    for alias, name in [("kmc2", "afkmc2"), ("km++", "kmeans++"), ("kmeans-parallel", "kmeans||")]:
        assert inits.resolve_init(alias).name == repro.api.resolve_init(alias).name == name
    assert inits.resolve_init("afkmc2").supports_weights is False


def _points(n=600, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(3, 2) * 20
    return (centers[rng.randint(0, 3, n)] + rng.randn(n, 2)).astype(np.float32)


def test_registered_init_and_engine_are_taken_by_bwkm(monkeypatch):
    monkeypatch.setattr(inits, "_REGISTRY", dict(inits._REGISTRY))
    monkeypatch.setattr(engines, "_REGISTRY", dict(engines._REGISTRY))
    seen = []

    def first_rows(key, x, w, k):
        seen.append(k)
        return x[w > 0][:k]

    repro_torch.register_init(repro_torch.InitStrategy("first-rows", "test", first_rows), "fr")
    assert "first-rows" in repro_torch.list_inits()
    repro_torch.BWKM(k=3, device="cpu", init="fr", max_iters=2).fit(_points())
    assert seen == [3]

    incore = repro_torch.get_engine("incore")
    runs = []

    def fit(*a, **kw):
        runs.append(1)
        return incore.fit(*a, **kw)

    repro_torch.register_engine(repro_torch.Engine("wrapped", "test", fit))
    model = repro_torch.BWKM(k=3, device="cpu", engine="wrapped", max_iters=2).fit(_points())
    assert runs == [1] and model.engine_ == "wrapped"


def test_weight_blind_init_warns_as_the_reference_does():
    x = _points()
    with pytest.warns(UserWarning, match="ignores point weights"):
        repro.BWKM(k=3, init="afkmc2", max_iters=2).fit(x)
    with pytest.warns(UserWarning, match="ignores point weights"):
        model = repro_torch.BWKM(k=3, device="cpu", init="kmc2", max_iters=2).fit(x)
    assert bool(torch.isfinite(model.centroids_).all())


def test_afkmc2_init_never_seeds_a_zero_weight_row():
    rng = np.random.RandomState(0)
    reps = np.zeros((256, 3), np.float32)  # mostly padding, like a Partition
    reps[:8] = rng.normal(size=(8, 3)).astype(np.float32) + 50.0
    w = np.zeros(256, np.float32)
    w[:8] = 10.0
    with pytest.warns(UserWarning, match="ignores point weights"):
        c = bwkm.seed_centroids("afkmc2", repro_torch.random.key(0), torch.from_numpy(reps),
                                torch.from_numpy(w), 3)
    assert float(torch.linalg.vector_norm(c, dim=1).min()) > 1.0


def test_core_helpers_equal_the_references():
    eps = np.array([0.0, 0.5, 0.0, 2.0, 1e-3], np.float32)
    np.testing.assert_array_equal(misassignment.boundary_mask(torch.from_numpy(eps)).numpy(),
                                  np.asarray(jmis.boundary_mask(jnp.asarray(eps))))
    for e in (eps, np.zeros(4, np.float32)):
        np.testing.assert_allclose(
            misassignment.cutting_probabilities(torch.from_numpy(e)).numpy(),
            np.asarray(jmis.cutting_probabilities(jnp.asarray(e))), rtol=1e-6)
    for args in [(1, 1000, 0.5, 10.0), (4, 5_000_000, 3.25, 1.5e6)]:
        assert bounds.coreset_epsilon(*args) == jbounds.coreset_epsilon(*args)
