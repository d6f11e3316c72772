"""The port's distributed engine on the reference's other meshes: the
dataset's features split over ``"model"``, and pod meshes; and a padded
vocabulary that the model axis does not divide.

One subprocess with four forced CPU devices runs the reference's side
(:func:`_reference_main`): on ``(1, 2)``, ``(2, 2)``, ``(2, 2, 1)`` and
``(1, 4)`` meshes at d = 8 (the model ranks divide it) and d = 5 (they do
not), the layout of ``shard_points``, ``n_data_shards``,
``dist_recompute_stats``, and ``fit_distributed`` at both widths on
``(2, 2)`` and at d = 8 on ``(1, 2)`` and ``(2, 2, 1)`` (at d = 5 those two
take ``(2, 2)``'s path or the unmeshed one); the statistics with a
non-finite entry on ``(1, 2)``; and the jitted train step of a reduced
config on ``(1, 3)``. Two things keep it to about a minute, neither
changing a result: the reference's ``shard_map`` bodies
run under ``jax.jit`` (eagerly a ``shard_map`` compiles each of its
operations apart: 787 compiles for one fit here, three to four times the
time), and Algorithm 2 on the gathered sample, a deterministic function
of the sample and the key that every mesh gathers alike, runs once a
width (it is most of a fit's time: eager JAX over 14 split rounds).

Beside it, four gloo ranks (``_torch_feature_split_ranks``, which imports
no JAX) build the ``(4,)``, ``(2, 2)``, ``(2, 2, 1)`` and ``(1, 4)`` meshes in
turn, and three ranks take the train step on ``(1, 3)``. The tests hold:
the layout and the statistics equal to the reference's; the statistics
and every fit bit-equal to one rank's; the one-rank fit (under
``JaxKey``) within ``tests/test_golden.py``'s tolerances of the
reference's fit on each mesh; the split routing moving one f32 a row;
``dist_lloyd`` pruned ≡ dense and k-means|| the same on every rank and
between meshes of the same row blocks; one checkpoint writer; the rule for
a non-finite row; pod meshes counting pod × data shards (C12); the train
step with a whole vocabulary within ``tests/test_torch_tp.py``'s tolerances
of the reference's (C13).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_feature_split_ranks import (
    B, BAD, BLOCKS, DIMS, K, MAX_ITERS, MESHES, N, S, SAME_BLOCKS, VOCAB_CASE, collect,
    memberships, points, spawn,
)
from helpers import error_f64
from test_torch_bwkm import JaxKey
from test_torch_tp import REFERENCE_SECONDS, TESTS, check_train

from repro.engine import sharded as jsharded
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.core import bwkm
from repro_torch.core import partition as part_mod
from repro_torch.distributed import dist_bwkm
from repro_torch.distributed import params as layouts
from repro_torch.distributed import sharding as sh
from repro_torch.engine import sharded
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tf

TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_kernels_properties.py's f32 tolerance
RANK_SECONDS = 150.0  # the ranks' deadline: a hang fails the module
#: name -> (shape, dimension names) of the reference's meshes
REF_MESHES = {
    "1x2": ((1, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
    "1x4": ((1, 4), ("data", "model")),
}
#: the reference's fits: (mesh, d)
REF_FITS = (("1x2", 8), ("2x2", 8), ("2x2", 5), ("2x2x1", 8))
VOCAB = "vocab13"


def _coord_key(coord) -> str:
    return "_".join(str(c) for c in coord)


def _reference_main(out: str) -> None:
    """The reference's side (in a subprocess with four forced devices),
    written to ``out``."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.core import bwkm as jbwkm
    from repro.core import init_partition as jinit
    from repro.core import partition as jpart
    from repro.distributed import dist_bwkm as jdist
    from repro.distributed import params as jlayouts
    from repro.distributed import sharding as jsh
    from repro.launch.mesh import _mesh
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from _torch_fsdp_ranks import OPT, config, initial_params, inputs

    eager = jsh.shard_map
    jsh.shard_map = lambda f, **kw: jax.jit(eager(f, **kw))
    build, built = jinit.build_initial_partition, {}

    def build_once(key, sample, k, **kw):
        at = (np.asarray(key).tobytes(), np.asarray(sample).tobytes(), k, tuple(sorted(kw.items())))
        if at not in built:
            built[at] = build(key, sample, k, **kw)
        return built[at]

    jinit.build_initial_partition = build_once
    res: dict[str, np.ndarray] = {}
    for name, (shape, names) in REF_MESHES.items():
        mesh = _mesh(shape, names)
        with jsh.use_mesh(mesh):
            res[f"{name}/n_shards"] = np.asarray(jsharded.n_data_shards())
            for d in DIMS:
                x = points(N, d)
                xs = jsharded.shard_points(jnp.asarray(x))
                for coord in np.ndindex(*shape):
                    (idx,) = [s.index for s in xs.addressable_shards
                              if s.device == mesh.devices[coord]]
                    res[f"{name}/{d}/layout/{_coord_key(coord)}"] = np.asarray(
                        [idx[0].start or 0, N if idx[0].stop is None else idx[0].stop,
                         idx[1].start or 0, d if idx[1].stop is None else idx[1].stop])
                st = jdist.dist_recompute_stats(jpart.create_partition(jnp.zeros((1, d)), BLOCKS),
                                                xs, jnp.asarray(memberships(N)))
                for f in ("psum", "count", "lo", "hi"):
                    res[f"{name}/{d}/{f}"] = np.asarray(getattr(st, f))
                if (name, d) in REF_FITS:
                    r = jdist.fit_distributed(jax.random.PRNGKey(0), xs,
                                              jbwkm.BWKMConfig(k=K, max_iters=MAX_ITERS))
                    res[f"{name}/{d}/centroids"] = np.asarray(r.centroids)
                    res[f"{name}/{d}/stop_reason"] = np.asarray(r.stop_reason)
                    res[f"{name}/{d}/iterations"] = np.asarray(r.iterations)
                    res[f"{name}/{d}/distances"] = np.asarray(r.distances)
    # a non-finite entry in model rank 1's columns, on (1, 2)
    x = points(N, DIMS[0])
    x[BAD] = np.inf
    mesh = _mesh(*REF_MESHES["1x2"])
    with jsh.use_mesh(mesh):
        st, n_ok = jsharded._recompute_stats_ok(
            jpart.create_partition(jnp.zeros((1, DIMS[0])), BLOCKS),
            jsharded.shard_points(jnp.asarray(x)), jnp.asarray(memberships(N)))
        res["bad/n_ok"] = np.asarray(n_ok)
        res["bad/psum"] = np.asarray(st.psum)
        for i, s in enumerate(sorted(st.count.addressable_shards, key=lambda s: s.device.id)):
            res[f"bad/count{i}"] = np.asarray(s.data)
    # the train step over a vocabulary that 3 does not divide
    arch, shape, overrides = VOCAB_CASE
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch)).replace(**overrides)
    params = initial_params(config(arch, overrides))
    toks = inputs(config(arch, overrides), B)[0]
    mesh = _mesh(shape, ("data", "model"))
    with jsh.use_mesh(mesh):
        psh = jlayouts.param_shardings(jcfg, params)
        in_sh = jlayouts.input_shardings(jcfg, {"tokens": toks, "labels": toks})
        osh = {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}
        step = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**OPT), param_shardings=psh),
                       in_shardings=(psh, osh, in_sh["tokens"], in_sh["labels"], None))
        p, stt, m = step(params, jopt.adamw_init(params), toks, toks, None)
        res[f"{VOCAB}/loss"] = np.asarray(m["loss"])
        res[f"{VOCAB}/grad_norm"] = np.asarray(m["grad_norm"])
        for i, a in enumerate(jax.tree.leaves(p)):
            res[f"{VOCAB}/p{i}"] = np.asarray(a)
        for i, a in enumerate(jax.tree.leaves(stt["m"])):
            res[f"{VOCAB}/m{i}"] = np.asarray(a)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, the ranks' records (4: the meshes, 3: the
    vocabulary step) and the one-rank fits of the port."""
    root = tmp_path_factory.mktemp("feature_split")
    out = root / "reference.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)])}
    ref = subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_feature_split as t; t._reference_main({str(out)!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        started = {w: spawn(w, root / f"w{w}", RANK_SECONDS) for w in (4, 3)}
        cfg = bwkm.BWKMConfig(k=K, max_iters=MAX_ITERS)
        one = {d: dist_bwkm.fit_distributed(rnd.key(0), torch.from_numpy(points(N, d)), cfg)
               for d in DIMS}
        jax_key = {d: dist_bwkm.fit_distributed(JaxKey(jax.random.PRNGKey(0)),
                                                torch.from_numpy(points(N, d)), cfg)
                   for d in DIMS}
        ranks = {w: collect(s, root / f"w{w}") for w, s in started.items()}
        _, err = ref.communicate(timeout=REFERENCE_SECONDS)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with np.load(out) as data:
        reference = dict(data)
    return {"ref": reference, "ranks": ranks[4], "vocab": ranks[3], "one": one,
            "jax_key": jax_key}


def _batch_rank(rec: dict, name: str) -> int:
    """The rank's coordinate over the batch axes, pod-major."""
    shape, names = MESHES[name]
    b = 0
    for size, dim, c in zip(shape, names, rec[name]["coord"]):
        if dim != "model":
            b = b * size + c
    return b


# ------------------------------------------------------------- layout
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", ["2x2", "2x2x1", "1x4"])
def test_layout_is_the_references(runs, name, d):
    """Each rank holds the rows and columns the reference's coordinate
    holds: its batch rank's block, and its model rank's ``d/M`` columns
    where M divides d (a ``FeatureSlice``), else all of them."""
    ref = runs["ref"]
    for r in runs["ranks"]:
        rec = r[name]
        assert rec["n_shards"] == int(ref[f"{name}/n_shards"])
        got = rec[d]
        want = ref[f"{name}/{d}/layout/{_coord_key(rec['coord'])}"]
        assert (*got["rows"], *got["cols"]) == tuple(int(v) for v in want)
        assert got["part"] and got["shape"] == (want[1] - want[0], want[3] - want[2])
        assert got["split"] == (want[3] - want[2] < d)


def test_pod_mesh_counts_pod_times_data_shards(runs):
    """C12: on ``(2, 2, 1)`` there are 4 batch shards, as in the reference,
    every batch rank holds n/4 rows, and ``shard_faults`` addresses 4
    shards: one lost shard reweights as on the ``(4,)`` mesh, bit for bit."""
    assert int(runs["ref"]["2x2x1/n_shards"]) == 4
    recs = [r["2x2x1"] for r in runs["ranks"]]
    assert sorted(_batch_rank(r, "2x2x1") for r in runs["ranks"]) == [0, 1, 2, 3]
    for rec in recs:
        assert rec["n_shards"] == 4
        assert rec[8]["rows"][1] - rec[8]["rows"][0] == N // 4
    np.testing.assert_array_equal(sharded._alive_mask_for(N, 4, [2]).numpy(),
                                  np.asarray(jsharded._alive_mask_for(N, 4, [2])))
    for r in runs["ranks"]:
        for name in SAME_BLOCKS:
            h = r[name]["fault"]["health"]
            assert (h["lost_shards"], h["degraded_rounds"], h["lost_mass_frac"]) == (1, 1, 0.25)
        assert torch.equal(r["2x2x1"]["fault"]["centroids"], r["4"]["fault"]["centroids"])
        assert r["2x2x1"]["fault"]["distances"] == r["4"]["fault"]["distances"]


# ------------------------------------------------------------- statistics
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", list(MESHES))
def test_statistics_are_one_pass_and_the_references(runs, name, d):
    """Every rank's statistics are bit-equal to one ``block_stats`` over all
    rows, and to the reference's on the same mesh (its psum within TOL);
    the round moves statistics, far fewer bytes than the rank's rows."""
    want = part_mod.block_stats(torch.from_numpy(points(N, d)), torch.from_numpy(memberships(N)),
                                BLOCKS)
    ref = runs["ref"]
    for r in runs["ranks"]:
        got = r[name][d]
        for a, b in zip(got["stats"], want):
            assert torch.equal(a, b)
        n_local = got["rows"][1] - got["rows"][0]
        assert sum(got["stats_sent"].values()) < n_local * d * 4 / 4
        if name in REF_MESHES:
            np.testing.assert_allclose(got["stats"][0].numpy(), ref[f"{name}/{d}/psum"], **TOL)
            for i, f in ((1, "count"), (2, "lo"), (3, "hi")):
                np.testing.assert_array_equal(got["stats"][i].numpy(), ref[f"{name}/{d}/{f}"])


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", list(MESHES))
def test_split_routing_moves_one_value_a_row(runs, name, d):
    """The memberships after a split are ``route_split``'s on whole rows;
    on a feature split the round moves one f32 a local row (one all-reduce
    over ``"model"``), and nothing where the rows are whole."""
    x, bid = torch.from_numpy(points(N, d)), torch.from_numpy(memberships(N))
    for r in runs["ranks"]:
        got = r[name][d]
        r0, r1 = got["rows"]
        fits, axis, mid, right_row = got["plan"]
        plan = part_mod.SplitPlan(fits, axis, mid, right_row, fits.sum(dtype=torch.int32))
        assert bool(fits.any())
        assert torch.equal(got["routed"], part_mod.route_split(x[r0:r1], bid[r0:r1], plan))
        sent = got["route_sent"]
        assert sent == {**dict.fromkeys(sent, 0), "all-reduce": (r1 - r0) * 4 if got["split"] else 0}


# ------------------------------------------------------------- fits
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", list(MESHES))
def test_fit_is_bit_equal_to_one_rank(runs, name, d):
    one = runs["one"][d]
    for r in runs["ranks"]:
        got = r[name][d]["fit"]
        assert torch.equal(got["centroids"], one.centroids)
        assert (got["stop_reason"], got["iterations"], got["n_blocks"], got["distances"],
                got["weighted_errors"]) == (one.stop_reason, one.iterations, one.n_blocks,
                                            one.distances, one.weighted_errors)
        assert not got["health"]["degraded"]


@pytest.mark.parametrize("name,d", REF_FITS)
def test_one_rank_fit_is_the_references_on_its_mesh(runs, name, d):
    """The port's fit under ``JaxKey`` (the same on every mesh, above)
    against the reference's ``fit_distributed`` on the mesh, at
    ``tests/test_golden.py``'s tolerances."""
    ref, got = runs["ref"], runs["jax_key"][d]
    x = points(N, d)
    assert got.stop_reason == str(ref[f"{name}/{d}/stop_reason"])
    assert got.iterations == int(ref[f"{name}/{d}/iterations"])
    np.testing.assert_allclose(error_f64(x, got.centroids.numpy()),
                               error_f64(x, ref[f"{name}/{d}/centroids"]), rtol=1e-3)
    np.testing.assert_allclose(got.distances, float(ref[f"{name}/{d}/distances"]), rtol=0.05)


@pytest.mark.parametrize("name", list(MESHES))
def test_full_data_passes_repeat_on_every_rank(runs, name):
    """``dist_lloyd`` pruned ≡ dense bit for bit, the same on every rank,
    pruning saving distances; k-means|| the same on every rank; one
    ``dist_assign_step`` within TOL of one rank's."""
    x = points(N, DIMS[0])
    one_c, one_err = dist_bwkm.dist_assign_step(torch.from_numpy(x), torch.from_numpy(x[:K].copy()))
    first = runs["ranks"][0][name]["full"]
    for r in runs["ranks"]:
        full = r[name]["full"]
        pruned, dense = full["lloyd_True"], full["lloyd_False"]
        assert torch.equal(pruned[0], dense[0]) and pruned[2] == dense[2]
        assert pruned[3] < dense[3]
        assert torch.equal(pruned[0], first["lloyd_True"][0])
        assert torch.equal(full["ll"], first["ll"])
        np.testing.assert_allclose(full["assign_step"][0].numpy(), one_c.numpy(), **TOL)
        np.testing.assert_allclose(float(full["assign_step"][1]), float(one_err), rtol=1e-5)


def test_full_data_passes_are_bit_equal_over_the_same_row_blocks(runs):
    """``(4,)`` and ``(2, 2, 1)`` hold the same rows a batch rank, so their
    f32 partials add alike: ``dist_lloyd`` and k-means|| bit-equal."""
    for r in runs["ranks"]:
        a, b = r[SAME_BLOCKS[0]]["full"], r[SAME_BLOCKS[1]]["full"]
        assert torch.equal(a["lloyd_True"][0], b["lloyd_True"][0])
        assert a["lloyd_True"][1:] == b["lloyd_True"][1:]
        assert torch.equal(a["ll"], b["ll"])


@pytest.mark.parametrize("name", list(MESHES))
def test_one_rank_writes_the_checkpoint(runs, name):
    """Only the rank at coordinate 0 of every mesh dimension writes."""
    for d in DIMS:
        writers = [r["rank"] for r in runs["ranks"] if r[name][d]["wrote_checkpoint"]]
        assert writers == [0]
    for r in runs["ranks"]:
        assert (r[name]["process_rank"] == 0) == (not any(r[name]["coord"]))


# ------------------------------------------------------------- faults, layouts
def test_a_non_finite_entry_drops_its_batch_shard_on_every_model_rank(runs):
    """A batch shard's rows count whole or not at all: an infinity in model
    rank 1's columns drops batch rank 0's rows on both model ranks of
    ``(2, 2)`` (the statistics of rows 2,000–3,999 alone, one shard
    finite), and the whole data on ``(1, 4)``. The reference decides each
    (batch, model) shard apart: on ``(1, 2)`` its returned count keeps all
    4,000 rows (model rank 0's) while the psum of model rank 1's columns is
    zero and it reports one finite shard (ROADMAP, Known differences)."""
    d = DIMS[0]
    x, bid = torch.from_numpy(points(N, d)), torch.from_numpy(memberships(N))
    want = part_mod.block_stats(x[N // 2:], bid[N // 2:], BLOCKS)
    for r in runs["ranks"]:
        got = r["2x2"]["non_finite"]
        assert got["n_ok"] == 1
        for a, b in zip(got["stats"], want):
            assert torch.equal(a, b)
        got = r["1x4"]["non_finite"]
        assert got["n_ok"] == 0 and float(got["stats"][1].sum()) == 0.0
    ref = runs["ref"]
    assert int(ref["bad/n_ok"]) == 1
    assert float(ref["bad/count0"].sum()) == N and float(ref["bad/count1"].sum()) == 0.0
    assert not ref["bad/psum"][:, d // 2:].any() and ref["bad/psum"][:, : d // 2].any()


def test_layouts_the_port_does_not_take_raise(runs):
    """Whole rows that the model axis would split are refused (the error
    names ``shard_points``), as is a ``FeatureSlice`` without a model axis;
    on a mesh without one, whole rows are the layout."""
    for r in runs["ranks"]:
        for name in ("2x2", "1x4"):
            assert "shard_points" in r[name]["whole_refused"]
        for name in SAME_BLOCKS:
            assert r[name]["whole_refused"] is None
    cols = torch.zeros(4, 2).as_subclass(sharded.FeatureSlice)
    with pytest.raises(ValueError, match="FeatureSlice"):
        dist_bwkm.dist_assign_step(cols, torch.zeros(2, 2))
    assert sh.current_mesh() is None and sh._process_rank() == 0
    assert dist_bwkm.n_data_shards() == 1 and sharded._columns(8) == (0, 8)
    assert type(dist_bwkm.shard_points(points(10, 3), device="cpu")) is torch.Tensor


# ------------------------------------------------------------- the vocabulary (C13)
def test_whole_vocabulary_train_step_is_the_references(runs):
    """C13: reduced qwen3-4b on ``(1, 3)``, whose padded vocabulary (256)
    3 does not divide, takes a train step with the embedding and the head
    whole on every rank, within ``tests/test_torch_tp.py``'s tolerances of
    the reference's jitted step; its collectives are the dry run's rule."""
    check_train(runs["ref"], runs["vocab"], VOCAB)
    arch, shape, overrides = VOCAB_CASE
    cfg = configs.reduced_config(configs.get_config(arch)).replace(**overrides)
    assert cfg.vocab_padded % shape[1]
    whole = tf.init_params(cfg, rnd.key(0), device="meta")
    with dryrun.fake_mesh(shape[0] * shape[1], shape):
        want = dryrun._collectives(cfg, configs.Shape("t", S, B, "train"), whole,
                                   layouts.param_shardings(cfg, whole))
    for r in runs["vocab"]:
        assert r["counts"] == want
