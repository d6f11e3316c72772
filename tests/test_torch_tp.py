"""The port's model axis (``distributed.tp``, ``models.transformer``'s
tensor and sequence parallelism, ``models.moe``'s islands) held against
the reference's jitted steps on ``("data", "model")`` meshes of forced CPU
devices: (1, 2), (2, 2) and (1, 4).

One subprocess runs the reference (``XLA_FLAGS`` forcing four host
devices, meshes built with ``repro.launch.mesh._mesh``): for every case of
``_torch_tp_ranks`` it jits ``make_train_step(cfg, param_shardings=...)``
with the parameters, the AdamW state and the batch laid out by
``repro.distributed.params`` on the case's mesh, and the prefill and
decode, and writes what they return to an ``.npz``. Beside it, W = 2 and
W = 4 gloo ranks (``_torch_tp_ranks``, which imports no JAX) run the port's
steps on their shards, rows and sequence parts, from the same numpy
parameters through ``convert.params_from_numpy`` and ``fsdp.shard_tree``.
Each is started once for the module and they run side by side.

The cases: a reduced dense config (qwen3-4b's) on all three meshes, with
remat on (2, 2) and its 2 KV heads expanded over 4 model ranks on (1, 4);
the reduced MoE (deepseek-moe-16b's, 2 shared experts) in each island:
``ep`` with 4 experts on (2, 2), ``ep_split`` with 2 experts on (1, 4),
``tp`` with 3 experts on (1, 2), at capacity factor 1.0, where each rank's
capacity drops its own tokens.

Tolerances, ``tests/test_torch_fsdp.py``'s (f32 throughout):

* loss within 2e-6 (four f32 ulps at 5.5);
* grad-norm within a relative 1e-5;
* the first AdamW moment each leaf within 1e-4 of its own max |m|;
* the updated parameters within 1e-6 + 1e-5 relative where the
  reference's moment is above that tolerance (elsewhere AdamW's first step
  moves a parameter by lr·g/(|g| + eps), whose sign f32 does not fix, so
  the two may differ by up to 2·lr);
* the serving logits within 1e-5 + 1e-5 relative.

Each has a control that must miss by 100 times: the dense and ``tp``
steps with the row-parallel partials left unreduced over ``"model"``, and
the ``ep`` and ``ep_split`` steps at one rank on the whole batch (capacity
from all its tokens).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_fsdp_ranks import B, OPT, S, config, initial_params, inputs
from _torch_tp_ranks import (
    AGAIN_CASE, CASES, CE_VOCAB, CONTROL_CASES, DECODE_STEPS, FAMILY_CASES, MAX_SEQ, SERVE_ONLY,
    case_params, ce_inputs, collect, max_seq, serve_tokens, spawn,
)

from repro_torch import configs, convert
from repro_torch import random as rnd
from repro_torch.distributed import fsdp
from repro_torch.distributed import params as layouts
from repro_torch.launch import dryrun
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

LOSS_ATOL = 2e-6
NORM_RTOL = 1e-5
MOMENT_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
CONTROL = 100
RANK_SECONDS = 120.0  # the ranks' deadline: a hang fails the module
REFERENCE_SECONDS = 240.0
TESTS = pathlib.Path(__file__).parent


def _reference_main(out: str, families: bool = False) -> None:
    """The reference's side (in a subprocess with four forced devices):
    every case's jitted train step, prefill and decode on its mesh (of
    ``FAMILY_CASES`` with ``families``), written to ``out``."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    jax.config.update("jax_threefry_partitionable", True)
    from repro import configs as jconfigs
    from repro.distributed import params as jlayouts
    from repro.distributed import sharding as jsh
    from repro.launch.mesh import _mesh
    from repro.models import transformer as jtf
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts

    res: dict[str, np.ndarray] = {}
    for name, (arch, shape, overrides) in (FAMILY_CASES if families else CASES).items():
        jcfg = jconfigs.reduced_config(jconfigs.get_config(arch)).replace(**overrides)
        cfg = config(arch, overrides)
        params = case_params(name)
        toks, img = inputs(cfg, B)
        mesh = _mesh(shape, ("data", "model"))
        with jsh.use_mesh(mesh):
            psh = jlayouts.param_shardings(jcfg, params)
            batch = {"tokens": toks, "labels": toks}
            if img is not None:
                batch["image_embeds"] = img
            in_sh = jlayouts.input_shardings(jcfg, batch)
            if name not in SERVE_ONLY:
                osh = {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}
                step = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**OPT),
                                                   param_shardings=psh),
                               in_shardings=(psh, osh, in_sh["tokens"], in_sh["labels"],
                                             in_sh.get("image_embeds")))
                p, st, m = step(params, jopt.adamw_init(params), toks, toks, img)
                res[f"{name}/loss"] = np.asarray(m["loss"])
                res[f"{name}/grad_norm"] = np.asarray(m["grad_norm"])
                for i, a in enumerate(jax.tree.leaves(p)):
                    res[f"{name}/p{i}"] = np.asarray(a)
                for i, a in enumerate(jax.tree.leaves(st["m"])):
                    res[f"{name}/m{i}"] = np.asarray(a)
            prompt, forced = serve_tokens(cfg)
            rows = NamedSharding(mesh, P("data"))
            prefill = jax.jit(
                lambda p, t, i: jtf.prefill(jcfg, p, t, i, max_seq_len=max_seq(name)),
                in_shardings=(psh, NamedSharding(mesh, P("data", None)), in_sh.get("image_embeds")))
            decode = jax.jit(lambda p, c, t, pos: jtf.decode(jcfg, p, c, t, pos))
            logits, cache = prefill(params, prompt, img)
            res[f"serve_{name}/0"] = np.asarray(logits)
            for i, tok in enumerate(forced):
                logits, cache = decode(params, cache, jax.device_put(tok, rows), np.int32(S + i))
                res[f"serve_{name}/{i + 1}"] = np.asarray(logits)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and the ranks' records, W -> [rank record]."""
    root = tmp_path_factory.mktemp("tp")
    out = root / "reference.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)])}
    ref = subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_tp as t; t._reference_main({str(out)!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        started = {w: spawn(w, root / f"w{w}", RANK_SECONDS) for w in (2, 4)}
        ranks = {w: collect(s, root / f"w{w}") for w, s in started.items()}
        _, err = ref.communicate(timeout=REFERENCE_SECONDS)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with np.load(out) as data:
        reference = dict(data)
    return {"ref": reference, "ranks": ranks}


def _world(name):
    dp, m = CASES[name][1]
    return dp * m


def _cfg(name):
    arch, _, overrides = CASES[name]
    return config(arch, overrides)


def _one_rank_loss(name) -> float:
    cfg = _cfg(name)
    params = convert.params_from_numpy(initial_params(cfg), device="cpu")
    t = torch.from_numpy(inputs(cfg, B)[0])
    _, _, m = ts.make_train_step(cfg, opt.AdamWConfig(**OPT))(params, opt.adamw_init(params), t, t)
    return float(m["loss"])


# ------------------------------------------------------------- train steps
def check_train(ref: dict, recs: list[dict], name: str) -> None:
    """The ranks' records of a case's train step against the reference's:
    the same loss and norm on every rank and within the tolerances, each
    leaf's first moment and updated parameters, the same whole state on
    every rank."""
    got = recs[0]
    assert all(r["loss"] == got["loss"] and r["grad_norm"] == got["grad_norm"] for r in recs)
    assert abs(got["loss"] - float(ref[f"{name}/loss"])) <= LOSS_ATOL
    np.testing.assert_allclose(got["grad_norm"], float(ref[f"{name}/grad_norm"]), rtol=NORM_RTOL)
    params, moments = opt.leaves(got["params"]), opt.leaves(got["m"])
    for i, (p, m) in enumerate(zip(params, moments, strict=True)):
        want_m, want_p = ref[f"{name}/m{i}"], ref[f"{name}/p{i}"]
        tol = MOMENT_TOL * max(float(np.abs(want_m).max()), 1e-30)
        assert float(np.abs(m - want_m).max()) <= tol, (name, i)
        signed = np.abs(want_m) > tol
        np.testing.assert_allclose(p[signed], want_p[signed], **PARAM_TOL, err_msg=f"{name} {i}")
        assert float(np.abs(p - want_p).max(initial=0.0)) <= 2 * OPT["lr"] + PARAM_TOL["atol"]
    for r in recs[1:]:  # every rank holds the same whole state
        for a, b in zip(opt.leaves(r["params"]), opt.leaves(got["params"]), strict=True):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_the_reference_sharded_step(runs, name):
    check_train(runs["ref"], [r["train"][name] for r in runs["ranks"][_world(name)]], name)


@pytest.mark.parametrize("name", CONTROL_CASES)
def test_the_unreduced_control_misses_by_a_hundred_times(runs, name):
    """The step with the row-parallel partials of attention, the MLP and
    the shared experts left unreduced over ``"model"``."""
    miss = abs(runs["ranks"][_world(name)][0]["control"][name]
               - float(runs["ref"][f"{name}/loss"]))
    assert miss >= CONTROL * LOSS_ATOL, miss


@pytest.mark.parametrize("name", ["ep22", "ep_split14"])
def test_moe_control_at_one_rank_misses_by_a_hundred_times(runs, name):
    """The port's one-rank step on the whole batch sizes capacity from all
    its tokens and routes them together: not the island's step. (The
    ``tp`` island routes a data rank's whole sequence: at one data rank,
    the one-rank step's; its control is the unreduced one.)"""
    miss = abs(_one_rank_loss(name) - float(runs["ref"][f"{name}/loss"]))
    assert miss >= CONTROL * LOSS_ATOL, (name, miss)


def test_two_runs_are_bit_equal(runs):
    for r in runs["ranks"][_world(AGAIN_CASE)]:
        first, again = r["train"][AGAIN_CASE], r["train"][AGAIN_CASE + "_again"]
        assert first["loss"] == again["loss"] and first["grad_norm"] == again["grad_norm"]
        for a, b in zip([*opt.leaves(first["params"]), *opt.leaves(first["m"])],
                        [*opt.leaves(again["params"]), *opt.leaves(again["m"])], strict=True):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["dense22", "ep22"])
def test_collectives_are_the_dry_run_rule(runs, name):
    """The collectives a rank of the 2 × 2 step issued, by kind, against
    the dry run's rule for the cell on the same mesh."""
    cfg = _cfg(name)
    whole = tf.init_params(cfg, rnd.key(0), device="meta")
    with dryrun.fake_mesh(4, (2, 2)):
        want = dryrun._collectives(cfg, configs.Shape("t", S, B, "train"), whole,
                                   layouts.param_shardings(cfg, whole))
    for r in runs["ranks"][4]:
        assert r["train"][name]["counts"] == want
    assert want["all-to-all"]["count"] > (0 if name == "ep22" else -1)
    assert want["reduce-scatter"]["count"] > 0


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_match_the_reference(runs, name):
    """The ranks' logits, rows and vocabulary columns put together, over a
    cache whose 36 slots are split over the model ranks."""
    dp, m = CASES[name][1]
    recs = runs["ranks"][dp * m]
    for r in recs:
        assert r["serve"][name]["slots"] == MAX_SEQ // m
    for i in range(DECODE_STEPS + 1):
        got = np.concatenate([np.concatenate([recs[d * m + j]["serve"][name]["logits"][i]
                                              for j in range(m)], axis=-1) for d in range(dp)])
        np.testing.assert_allclose(got, runs["ref"][f"serve_{name}/{i}"], **LOGIT_TOL,
                                   err_msg=f"{name} step {i}")


# ------------------------------------------------------------- the pieces
@pytest.mark.parametrize("world", [2, 4])
def test_vocab_parallel_cross_entropy_and_lookup(runs, world):
    """Each rank's CE over its vocabulary columns is the whole CE, the
    gradient of its 1/M share that CE's gradient's columns; the vocab-parallel embedding is
    the whole table's rows (exactly) and its gradient the rows' gradient
    added into the table's rows."""
    logits, labels = ce_inputs()
    whole = torch.from_numpy(logits).requires_grad_()
    ce = ts.cross_entropy(whole, torch.from_numpy(labels), CE_VOCAB)
    (g,) = torch.autograd.grad(ce, [whole])
    recs = [r["vocab_parallel"] for r in runs["ranks"][world]]
    for r in recs:
        assert abs(r["ce"] - float(ce.detach())) <= 1e-6
    np.testing.assert_allclose(np.concatenate([r["ce_grad"] for r in recs], axis=-1), g.numpy(),
                               rtol=1e-5, atol=1e-7)
    cfg = config("qwen3-4b", {})
    table = np.random.RandomState(6).randn(cfg.vocab_padded, cfg.d_model).astype(np.float32)
    ids = np.random.RandomState(7).randint(0, cfg.vocab, (2, 8))
    rows = np.concatenate([r["rows"] for r in recs], axis=1)  # each rank its positions
    assert np.array_equal(rows, table[ids])
    n = ids.shape[1] // world
    co = (1 + np.arange(2 * n * cfg.d_model, dtype=np.float32)).reshape(2, n, -1)
    want = np.zeros_like(table)
    for j in range(world):
        np.add.at(want, ids[:, j * n:(j + 1) * n], co)
    np.testing.assert_allclose(np.concatenate([r["embed_grad"] for r in recs]), want)


def test_decode_combine_is_whole_cache_attention():
    """The partials of disjoint parts of a ring cache (one with no
    attendable slot), combined, against ``decode_attention`` over the whole
    cache; a control combines without the rescaling."""
    rng = np.random.RandomState(8)
    b, h, kv, hd, sc, pos = 2, 4, 2, 16, 12, 20
    q = torch.from_numpy(rng.randn(b, h, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, sc, kv, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, sc, kv, hd).astype(np.float32))
    slot_pos = torch.from_numpy(np.stack([np.arange(pos - sc + 1, pos + 1) % 100] * b)
                                .astype(np.int32))
    slot_pos[:, :4] = -1  # the first part holds no attendable slot
    want = layers.decode_attention(q, k, v, slot_pos, pos, window=9)
    parts = torch.stack([layers.decode_attention_partial(q, k[:, i:i + 4], v[:, i:i + 4],
                                                         slot_pos[:, i:i + 4], pos, window=9)
                         for i in range(0, sc, 4)])
    got = layers.decode_combine(parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    flat = parts.clone()
    flat[..., -2] = 0.0  # control: every part's max taken as 0
    assert float((layers.decode_combine(flat[1:]) - want).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["musicgen-medium", "mamba2-130m", "zamba2-1.2b",
                                  "llama-3.2-vision-90b"])
def test_the_other_families_raise_on_the_model_axis(arch):
    """The audio, ssm, hybrid and vlm families no longer raise on the model
    axis (``tests/test_torch_tp_families.py`` holds them against the
    reference): on a (2, 2) mesh forward and prefill run on the rank's
    shards and return its vocabulary columns; a control on a "data" mesh
    returns every column."""
    cfg = configs.reduced_config(configs.get_config(arch))
    whole = tf.init_params(cfg, rnd.key(0), device="meta")
    toks = torch.zeros((1, S), dtype=torch.int32, device="meta")
    img = torch.zeros((1, cfg.n_image_tokens or 1, cfg.d_model), device="meta")
    with dryrun.fake_mesh(4, (2, 2)):
        psh = layouts.param_shardings(cfg, whole)
        shards = fsdp.shard_tree(whole, psh)
        logits = tf.forward(cfg, shards, toks, img, param_shardings=psh)[0]
        assert logits.shape == (1, S, cfg.vocab_padded // 2)
        last, _ = tf.prefill(cfg, shards, toks, img, param_shardings=psh)
        assert last.shape == (1, cfg.vocab_padded // 2)
    with dryrun.fake_mesh(4):  # control: a "data" mesh runs them on every column
        psh = layouts.param_shardings(cfg, whole)
        logits = tf.forward(cfg, fsdp.shard_tree(whole, psh), toks, img, param_shardings=psh)[0]
        assert logits.shape == (1, S, cfg.vocab_padded)


# ------------------------------------------------------------- layouts, meshes
_MODEL_ARCHS = ("codeqwen1.5-7b", "granite-8b", "stablelm-12b", "qwen3-4b", "deepseek-moe-16b",
                "mixtral-8x22b")


def _flat(tree, names=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, (*names, k)) if isinstance(v, dict) else {(*names, k): v})
    return out


def _port_spec(placement, ndim, axes) -> tuple:
    """A placement tuple read as a reference spec entry a dimension."""
    entry = []
    for d in range(ndim):
        on = tuple(a for a, p in zip(axes, placement) if getattr(p, "dim", None) == d)
        entry.append(None if not on else on[0] if len(on) == 1 else on)
    return tuple(entry)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", _MODEL_ARCHS)
def test_layouts_are_the_references_on_the_production_meshes(arch, multi):
    """``distributed.params``' placements of the parameters and of every
    runnable shape's inputs on ``16x16`` and ``2x16x16``, read as specs,
    against the reference's ``_leaf_spec``/``input_shardings`` on an
    abstract mesh of the same shape (``logical_to_spec``'s rule); a control
    on the data mesh differs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro import configs as jconfigs
    from repro.distributed import params as jparams
    from repro.distributed import sharding as jsh
    from repro.models import transformer as jtf
    from repro_torch.launch import mesh as meshes

    shape = meshes.production_shape(multi)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    jcfg = jconfigs.get_config(arch)
    ref = {}
    with jsh.use_mesh(AbstractMesh(shape, axes)):
        tree = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            spec = jparams._leaf_spec(jcfg, path, leaf)
            names = tuple(getattr(p, "key", None) for p in path)
            ref[("params", *names)] = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        for s in configs.SHAPES:
            if (arch, s) in jconfigs.runnable_cells():
                specs = jconfigs.input_specs(jcfg, jconfigs.SHAPES[s])
                flat_specs = dict(jax.tree_util.tree_flatten_with_path(specs)[0])
                shard = jparams.input_shardings(jcfg, specs)
                for path, ns in jax.tree_util.tree_flatten_with_path(shard)[0]:
                    nd = flat_specs[path].ndim
                    names = tuple(getattr(p, "key", None) for p in path)
                    ref[(s, *names)] = tuple(ns.spec) + (None,) * (nd - len(ns.spec))
    cfg = configs.get_config(arch)
    whole = tf.init_params(cfg, rnd.key(0), device="meta")

    def port_layouts():
        got = {("params", *k): _port_spec(v, _flat(whole)[k].ndim, axes)
               for k, v in _flat(layouts.param_shardings(cfg, whole)).items()}
        for s in configs.SHAPES:
            if (arch, s) in configs.runnable_cells():
                specs = _flat(configs.input_specs(cfg, configs.SHAPES[s]))
                for k, v in _flat(layouts.input_shardings(
                        cfg, configs.input_specs(cfg, configs.SHAPES[s]))).items():
                    got[(s, *k)] = _port_spec(v, specs[k].ndim, axes)
        return got

    with dryrun.fake_mesh(meshes.production_world(multi), shape):
        assert port_layouts() == ref
    with dryrun.fake_mesh(meshes.production_world(multi)):  # control: the data mesh
        axes = ("data",)
        assert port_layouts() != ref


def test_the_meshes():
    """The production meshes are the reference's shapes and names; the
    data meshes keep the ranks on one dimension; the smoke mesh takes the
    reference's 1 × 1 × 1."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as meshes

    assert (meshes.production_mesh_name(), meshes.production_mesh_name(True)) == ("16x16",
                                                                                   "2x16x16")
    with dryrun.fake_group(512):
        m = meshes.make_production_mesh(multi_pod=True, device="cpu")
        assert m.mesh_dim_names == ("pod", "data", "model") and tuple(m.shape) == (2, 16, 16)
        assert meshes.make_data_mesh(multi_pod=True, device="cpu").mesh_dim_names == ("data",)
        with pytest.raises(RuntimeError, match="256 ranks, this one has 512"):
            meshes.make_data_mesh(device="cpu")
    with meshes.make_smoke_mesh("cpu", (1, 1, 1)) as m, sh.use_mesh(m):
        assert sh.batch_axes() == ("pod", "data") and sh.axis_size("model") == 1
        assert sh.named_sharding(("batch", "tensor"), (4, 6)) == sh.logical_to_spec(
            ("batch", "tensor"), (4, 6))
    assert sh.named_sharding(("batch",), (4,)) is None  # no mesh
    with dryrun.fake_mesh(4, (2, 2)):
        from torch.distributed.tensor import Replicate, Shard

        assert sh.logical_to_spec(("batch", "tensor"), (4, 6)) == (Shard(0), Shard(1))
        assert sh.logical_to_spec(("batch", "tensor"), (3, 5)) == (Replicate(), Replicate())
        assert sh.logical_to_spec(("tensor", None), (4, 6)) == (Replicate(), Shard(0))
