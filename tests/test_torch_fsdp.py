"""The port's FSDP train and serve steps (``distributed.fsdp``) held
against the reference's jitted steps on a ``("data", "model")`` mesh of
W = 2 and 4 forced CPU devices.

One subprocess runs the reference (``XLA_FLAGS`` forcing four host
devices, meshes built with ``repro.launch.mesh._mesh``): for every case of
``_torch_fsdp_ranks`` it jits ``make_train_step(cfg,
param_shardings=...)`` with the parameters, the AdamW state and the batch
laid out by ``repro.distributed.params``, and the prefill and decode, and
writes what they return to an ``.npz``. Beside it, W = 2 and W = 4 gloo
ranks (``_torch_fsdp_ranks``, which imports no JAX) run the port's steps on
their shards and rows, from the same numpy parameters through
``convert.params_from_numpy`` and ``fsdp.shard_tree``. Both are started
once for the module and run side by side.

Tolerances (f32 throughout; the reference's own W = 2 and one-device
losses differ by 4e-7):

* loss within 2e-6 (four f32 ulps at 5.5);
* grad-norm within a relative 1e-5;
* the first AdamW moment, 0.1 × the clipped gradient, each leaf within
  1e-4 of its own max |m| (``tests/test_torch_train.py``'s gradient
  tolerance);
* the updated parameters within 1e-6 + 1e-5 relative (one step at lr
  1e-3: each moves by about 1e-3) where the reference's moment is above
  that tolerance; below it the gradient's sign is not fixed by f32
  arithmetic, AdamW's first step moves the parameter by lr·g/(|g| + eps)
  either way, and the two may differ by up to 2·lr;
* the serving logits within 1e-5 + 1e-5 relative.

The MoE runs at capacity factor 1.0, where each rank's capacity drops its
own tokens: its control, the port's one-rank step on the whole batch, must
miss the reference's W = 2 loss by at least 100 times the loss tolerance.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_fsdp_ranks import (
    CKPT_CASE, DECODE_STEPS, LOOKUP_IDS, OPT, S, SERVE_CASES, SERVE_FAMILIES, TRAIN_CASES, collect,
    config, initial_params, inputs, lookup_inputs, serve_inputs, spawn,
)

from repro_torch import configs, convert
from repro_torch import random as rnd
from repro_torch.distributed import params as layouts
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

LOSS_ATOL = 2e-6
NORM_RTOL = 1e-5
MOMENT_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
RANK_SECONDS = 120.0  # the ranks' deadline: a hang fails the module
REFERENCE_SECONDS = 240.0
TESTS = pathlib.Path(__file__).parent


def _reference_main(out: str) -> None:
    """The reference's side (in a subprocess with four forced devices):
    every case's jitted sharded step, written to ``out``."""
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
    for name, (arch, w, overrides, batch) in TRAIN_CASES.items():
        jcfg = jconfigs.reduced_config(jconfigs.get_config(arch)).replace(**overrides)
        params = initial_params(config(arch, overrides))
        toks, img = inputs(config(arch, overrides), batch)
        mesh = _mesh((w, 1), ("data", "model"))
        with jsh.use_mesh(mesh):
            psh = jlayouts.param_shardings(jcfg, params)
            specs = {"tokens": toks, "labels": toks}
            if img is not None:
                specs["image_embeds"] = img
            in_sh = jlayouts.input_shardings(jcfg, specs)
            state = jopt.adamw_init(params)
            osh = {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}
            args = [params, state, toks, toks] + ([img] if img is not None else [])
            shard = [psh, osh, in_sh["tokens"], in_sh["labels"]] + (
                [in_sh["image_embeds"]] if img is not None else [])
            step = jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**OPT),
                                               param_shardings=psh),
                           in_shardings=tuple(shard))
            p, st, m = step(*args)
            res[f"{name}/loss"] = np.asarray(m["loss"])
            res[f"{name}/grad_norm"] = np.asarray(m["grad_norm"])
            for i, a in enumerate(jax.tree.leaves(p)):
                res[f"{name}/p{i}"] = np.asarray(a)
            for i, a in enumerate(jax.tree.leaves(st["m"])):
                res[f"{name}/m{i}"] = np.asarray(a)
    for name, (arch, w, overrides) in SERVE_CASES.items():
        jcfg = jconfigs.reduced_config(jconfigs.get_config(arch)).replace(**overrides)
        params = initial_params(config(arch, overrides))
        prompt, forced, _ = serve_inputs(config(arch, overrides))
        mesh = _mesh((w, 1), ("data", "model"))
        with jsh.use_mesh(mesh):
            psh = jlayouts.param_shardings(jcfg, params)
            rows = NamedSharding(mesh, P("data"))
            prefill = jax.jit(lambda p, t: jtf.prefill(jcfg, p, t, max_seq_len=S + DECODE_STEPS),
                              in_shardings=(psh, NamedSharding(mesh, P("data", None))))
            decode = jax.jit(lambda p, c, t, pos: jtf.decode(jcfg, p, c, t, pos))
            logits, cache = prefill(params, prompt)
            res[f"serve_{name}/0"] = np.asarray(logits)
            for i, tok in enumerate(forced):
                logits, cache = decode(params, cache, jax.device_put(tok, rows),
                                       np.int32(S + i))
                res[f"serve_{name}/{i + 1}"] = np.asarray(logits)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and the ranks' records, W -> [rank record]."""
    root = tmp_path_factory.mktemp("fsdp")
    out = root / "reference.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)])}
    ref = subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_fsdp as t; t._reference_main({str(out)!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        started = {w: spawn(w, root / f"w{w}", root / "ckpt", RANK_SECONDS) for w in (2, 4)}
        ranks = {w: collect(s, root / f"w{w}") for w, s in started.items()}
        _, err = ref.communicate(timeout=REFERENCE_SECONDS)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with np.load(out) as data:
        reference = dict(data)
    return {"ref": reference, "ranks": ranks, "ckpt": root / "ckpt"}


def _leaves(tree):
    return list(opt.leaves(tree))


def _case_cfg(name):
    arch, _, overrides, _ = TRAIN_CASES[name]
    return config(arch, overrides)


# ------------------------------------------------------------- train steps
@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step_matches_the_reference_sharded_step(runs, name):
    ref, world = runs["ref"], TRAIN_CASES[name][1]
    recs = [r["train"][name] for r in runs["ranks"][world]]
    got = recs[0]
    assert all(r["loss"] == got["loss"] and r["grad_norm"] == got["grad_norm"] for r in recs)
    assert abs(got["loss"] - float(ref[f"{name}/loss"])) <= LOSS_ATOL
    np.testing.assert_allclose(got["grad_norm"], float(ref[f"{name}/grad_norm"]), rtol=NORM_RTOL)
    params, moments = _leaves(got["params"]), _leaves(got["m"])
    for i, (p, m) in enumerate(zip(params, moments, strict=True)):
        want_m, want_p = ref[f"{name}/m{i}"], ref[f"{name}/p{i}"]
        tol = MOMENT_TOL * max(float(np.abs(want_m).max()), 1e-30)
        assert float(np.abs(m - want_m).max()) <= tol, (name, i)
        signed = np.abs(want_m) > tol
        np.testing.assert_allclose(p[signed], want_p[signed], **PARAM_TOL, err_msg=f"{name} {i}")
        assert float(np.abs(p - want_p).max(initial=0.0)) <= 2 * OPT["lr"] + PARAM_TOL["atol"]
    assert f"{name}/p{len(params)}" not in ref


def test_moe_control_misses_by_a_hundred_times(runs):
    """The port's one-rank step on the whole batch sizes capacity from all
    four rows and routes them together: not the W = 2 step."""
    cfg = _case_cfg("moe2")
    params = convert.params_from_numpy(initial_params(cfg), device="cpu")
    toks, _ = inputs(cfg, TRAIN_CASES["moe2"][3])
    t = torch.from_numpy(toks)
    _, _, m = ts.make_train_step(cfg, opt.AdamWConfig(**OPT))(params, opt.adamw_init(params), t, t)
    miss = abs(float(m["loss"]) - float(runs["ref"]["moe2/loss"]))
    assert miss >= 100 * LOSS_ATOL, miss
    assert abs(runs["ranks"][2][0]["train"]["moe2"]["loss"] - float(m["loss"])) >= 100 * LOSS_ATOL


def test_two_runs_are_bit_equal(runs):
    first, again = (runs["ranks"][2][0]["train"][k] for k in ("dense2", "dense2_again"))
    assert first["loss"] == again["loss"]
    for a, b in zip(_leaves(first["params"]) + _leaves(first["m"]),
                    _leaves(again["params"]) + _leaves(again["m"]), strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n", LOOKUP_IDS)
def test_lookup_moves_the_rows_or_the_table(runs, world, n):
    """``fsdp.lookup`` of a column-sharded table, fewer ids a rank than the
    table's rows (the rows move) and more (the table moves): each rank's
    rows bit-equal to indexing the whole table; the shards' gradients,
    put together, the mean over ranks of each rank's whole-table gradient
    (within 1e-6)."""
    want = 0.0
    for r, rec in enumerate(runs["ranks"][world]):
        table, ids, co = lookup_inputs(world, r, n)
        rows, _ = rec["lookup"][n]
        assert np.array_equal(rows, table[ids])
        g = np.zeros_like(table)
        np.add.at(g, ids, co)
        want = want + g
    got = np.concatenate([rec["lookup"][n][1] for rec in runs["ranks"][world]], axis=1)
    np.testing.assert_allclose(got, want / world, rtol=1e-6, atol=1e-6)


def test_the_backward_needs_no_mesh_on_its_thread(runs):
    """A CUDA backward (and remat's recompute) runs on the autograd
    engine's thread, which does not see the caller's mesh: the vlm's
    gradients with remat, the backward run on another thread, are the same
    bits."""
    assert all(r["backward_elsewhere"] for r in runs["ranks"][2])


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_collectives_are_the_dry_run_rule(runs, name):
    arch, world, _, batch = TRAIN_CASES[name]
    cfg = _case_cfg(name)
    whole = tf.init_params(cfg, rnd.key(0), device="meta")
    with dryrun.fake_mesh(world):
        want = dryrun._collectives(cfg, configs.Shape("t", S, batch, "train"), whole,
                                   layouts.param_shardings(cfg, whole), world)
    for r in runs["ranks"][world]:
        assert r["train"][name]["counts"] == want
    assert want["reduce-scatter"]["count"] > 0
    if cfg.remat:  # the layers are gathered again in the backward
        assert want["all-gather"]["count"] > want["reduce-scatter"]["count"]


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_prefill_and_decode_match_the_reference(runs, name):
    world = SERVE_CASES[name][1]
    recs = [r["serve"][name] for r in runs["ranks"][world]]
    for r in recs:
        assert r["rows"] == 4 // world  # each rank serves its rows
    for i in range(DECODE_STEPS + 1):
        got = np.concatenate([r["logits"][i] for r in recs])
        np.testing.assert_allclose(got, runs["ref"][f"serve_{name}/{i}"], **LOGIT_TOL,
                                   err_msg=f"{name} step {i}")


@pytest.mark.parametrize("name", list(SERVE_FAMILIES))
def test_prefill_and_decode_of_the_other_families_match_one_rank(runs, name):
    """The ssm, hybrid and vlm serving seams (held against the reference
    unsharded in ``tests/test_torch_models.py`` and
    ``tests/test_torch_mamba2.py``): the ranks' logits, rows put together,
    against the port's one-rank prefill and decode of the whole batch."""
    arch, world, overrides = SERVE_FAMILIES[name]
    cfg = config(arch, overrides)
    params = convert.params_from_numpy(initial_params(cfg), device="cpu")
    prompt, forced, img = serve_inputs(cfg)
    with torch.no_grad():
        logits, cache = tf.prefill(cfg, params, torch.from_numpy(prompt),
                                   None if img is None else torch.from_numpy(img),
                                   max_seq_len=S + DECODE_STEPS)
        want = [logits.numpy()]
        for i, tok in enumerate(forced):
            logits, cache = tf.decode(cfg, params, cache, torch.from_numpy(tok), S + i)
            want.append(logits.numpy())
    recs = [r["serve"][name] for r in runs["ranks"][world]]
    assert all(r["rows"] == 4 // world for r in recs)
    for i, w in enumerate(want):
        np.testing.assert_allclose(np.concatenate([r["logits"][i] for r in recs]), w,
                                   **LOGIT_TOL, err_msg=f"{name} step {i}")


# ------------------------------------------------------------- checkpoints
def _saved(ckpt_dir):
    cfg = _case_cfg(CKPT_CASE)
    whole = tf.init_params(cfg, rnd.key(0), device="cpu")
    template = {"params": whole, "opt": opt.adamw_init(whole)}
    state, _ = checkpoint.restore(ckpt_dir, 1, template, device="cpu")
    return cfg, state


@pytest.mark.parametrize("world", [2, 4])
def test_elastic_restore_gives_each_rank_its_slice(runs, world):
    cfg, state = _saved(runs["ckpt"])
    with dryrun.fake_mesh(world):
        psh = layouts.param_shardings(cfg, state["params"])
    for rank, r in enumerate(runs["ranks"][world]):
        got = r["ckpt"]["restored"]
        for tree in ("m", "v"):
            for g, s, p in zip(_leaves(got["opt"][tree]), _leaves(state["opt"][tree]),
                               _leaves(psh), strict=True):
                assert np.array_equal(g, _slice(s.numpy(), p, world, rank))
        for g, s, p in zip(_leaves(got["params"]), _leaves(state["params"]), _leaves(psh),
                           strict=True):
            assert np.array_equal(g, _slice(s.numpy(), p, world, rank))
        assert int(got["opt"]["step"]) == 1
    if world == 2:  # the step after the restore is the uninterrupted run's
        ck = runs["ranks"][2][0]["ckpt"]
        for a, b in zip(_leaves(ck["after_restore"]), _leaves(ck["uninterrupted"]), strict=True):
            assert np.array_equal(a, b)


def _slice(a, placement, world, rank):
    d = next((p.dim for p in placement if type(p).__name__ == "Shard"), None)
    if d is None:
        return a
    n = a.shape[d] // world
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=d)


def test_restore_at_one_rank_is_the_saved_whole_state(runs):
    """The W = 2 checkpoint restored whole at one rank is the W = 2 ranks'
    step-1 state, and the step after it is bit-equal to the same step from
    that state as the ranks held it."""
    cfg, state = _saved(runs["ckpt"])
    rec = runs["ranks"][2][0]["train"][CKPT_CASE]
    held = {"params": rec["params"], "opt": {"m": rec["m"], "v": rec["v"]}}
    for tree, want in ((state["params"], held["params"]), (state["opt"]["m"], rec["m"]),
                       (state["opt"]["v"], rec["v"])):
        for a, b in zip(_leaves(tree), _leaves(want), strict=True):
            assert np.array_equal(a.numpy(), b)
    toks, _ = inputs(cfg, TRAIN_CASES[CKPT_CASE][3])
    t = torch.from_numpy(toks)
    step = ts.make_train_step(cfg, opt.AdamWConfig(**OPT))
    p1, _, _ = step(state["params"], state["opt"], t, t)
    mem = convert.params_from_numpy(held, device="cpu")
    mem["opt"]["step"] = torch.tensor(1, dtype=torch.int32)
    p2, _, _ = step(mem["params"], mem["opt"], t, t)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(p1), _leaves(p2), strict=True))
    with pytest.raises(ValueError, match="use_mesh"):
        checkpoint.restore(runs["ckpt"], 1, {"params": state["params"]},
                           {"params": _places(cfg, state["params"])}, device="cpu")


def _places(cfg, tree):
    with dryrun.fake_mesh(2):
        return layouts.param_shardings(cfg, tree)
