"""The model axis of the audio, ssm, hybrid and vlm families, and the
reference's whole-dimension rule, held against the reference's jitted
steps on ``("data", "model")`` meshes of forced CPU devices.

Built as ``tests/test_torch_tp.py`` is: one subprocess runs the
reference's side (``test_torch_tp._reference_main`` over
``_torch_tp_ranks.FAMILY_CASES``), and W = 2 and W = 4 gloo ranks run the
port's train, prefill and decode steps on their shards, rows and sequence
parts, side by side. The cases:

* reduced mamba2-130m on (1, 2) and (2, 2): the Mamba heads split, the
  gated norm's sums of squares added over the ranks, ``out_proj``
  row-parallel, the ``ssm`` cache on the rank's heads;
* reduced zamba2-1.2b on (1, 2) with remat: the Mamba groups and the shared
  block over ``concat(h, x0)``, its KV cache on the rank's slots;
* reduced llama-3.2-vision-90b on (1, 4): its 2 KV heads expanded over 4
  model ranks in the self and the cross layers, the image K/V whole in the
  cache;
* reduced musicgen-medium with ``n_heads=6`` on (1, 4): heads that do not
  divide M run whole on every rank, ``wq`` gathered from its 1.5 heads a
  rank;
* the reduced dense config serving on (1, 2) over a cache of 37 slots,
  which M does not divide: each rank holds it whole and decode attends
  over all of it, with no flash-decoding combine.

Tolerances are ``tests/test_torch_tp.py``'s (f32 throughout). Two controls
on the (1, 2) Mamba step must miss the first moment's tolerance by 100
times: ``out_proj``'s partials left unreduced, and the gated norm over
each rank's own heads only. Each rank's collectives are the dry run's rule for the step on its
mesh, and the dry run plans each family on the ``16x16`` production mesh.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_fsdp_ranks import B, S, config
from _torch_tp_ranks import (
    DECODE_STEPS, FAMILY_CASES, FAMILY_CONTROL_CASE, FAMILY_CONTROLS, MAX_SEQ, SERVE_ONLY,
    collect, max_seq, spawn,
)
from test_torch_tp import CONTROL, LOGIT_TOL, MOMENT_TOL, REFERENCE_SECONDS, TESTS, check_train

from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.distributed import fsdp
from repro_torch.distributed import params as layouts
from repro_torch.launch import dryrun
from repro_torch.models import mamba2
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt

RANK_SECONDS = 180.0  # the ranks' deadline: a hang fails the module
TRAIN = [n for n in FAMILY_CASES if n not in SERVE_ONLY]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and the ranks' records, W -> [rank record]."""
    root = tmp_path_factory.mktemp("tp_families")
    out = root / "reference.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)])}
    ref = subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_tp as t; t._reference_main({str(out)!r}, families=True)"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        started = {w: spawn(w, root / f"w{w}", RANK_SECONDS, families=True) for w in (2, 4)}
        ranks = {w: collect(s, root / f"w{w}") for w, s in started.items()}
        _, err = ref.communicate(timeout=REFERENCE_SECONDS)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with np.load(out) as data:
        reference = dict(data)
    return {"ref": reference, "ranks": ranks}


def _shape(name):
    return FAMILY_CASES[name][1]


def _cfg(name):
    arch, _, overrides = FAMILY_CASES[name]
    return config(arch, overrides)


def _recs(runs, name):
    dp, m = _shape(name)
    return runs["ranks"][dp * m]


# ------------------------------------------------------------- train steps
@pytest.mark.parametrize("name", TRAIN)
def test_train_step_matches_the_reference_sharded_step(runs, name):
    """Loss, grad-norm, first moment and updated parameters against the
    reference's jitted step on the same mesh (``tests/test_torch_tp.py``'s
    check, on this module's cases)."""
    check_train(runs["ref"], [r["train"][name] for r in _recs(runs, name)], name)


@pytest.mark.parametrize("which", FAMILY_CONTROLS)
def test_the_mamba_controls_miss_by_a_hundred_times(runs, which):
    """The (1, 2) Mamba step with ``out_proj``'s partials left unreduced,
    and with the gated norm over each rank's own heads only. The layers'
    outputs move the loss of a reduced model at its initial scale by less
    than 100 × its tolerance, so the control is read where the check holds
    the step tightest: the first moment, each leaf within MOMENT_TOL of its
    own max |m|, must miss by 100 times that."""
    ref, name = runs["ref"], FAMILY_CONTROL_CASE
    for r in _recs(runs, name):
        got = opt.leaves(r["control"][which]["m"])
        miss = max(float(np.abs(m - ref[f"{name}/m{i}"]).max())
                   / max(float(np.abs(ref[f"{name}/m{i}"]).max()), 1e-30)
                   for i, m in enumerate(got))
        assert miss >= CONTROL * MOMENT_TOL, (which, miss)


@pytest.mark.parametrize("name", TRAIN)
def test_collectives_are_the_dry_run_rule(runs, name):
    """Each rank's train step issued the dry run's rule for the cell on its
    mesh, by kind."""
    cfg = _cfg(name)
    dp, m = _shape(name)
    whole = tf.init_params(cfg, rnd.key(0), device="meta")
    with dryrun.fake_mesh(dp * m, (dp, m)):
        want = dryrun._collectives(cfg, configs.Shape("t", S, B, "train"), whole,
                                   layouts.param_shardings(cfg, whole))
    for r in _recs(runs, name):
        assert r["train"][name]["counts"] == want
    assert want["all-gather"]["count"] > 0


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_prefill_and_decode_match_the_reference(runs, name):
    """The ranks' logits, rows and vocabulary columns put together, over
    the rank's cache: its slots (whole where M does not divide them) and
    its Mamba heads."""
    dp, m = _shape(name)
    recs = _recs(runs, name)
    cfg = _cfg(name)
    sc = max_seq(name)
    for r in recs:
        got = r["serve"][name]
        if cfg.family != "ssm":
            assert got["slots"] == (sc // m if sc % m == 0 else sc)
        if cfg.family in ("ssm", "hybrid"):
            assert got["ssm_heads"] == mamba2.mamba_dims(cfg)["nheads"] // m
    assert (SERVE_ONLY.get(name, MAX_SEQ) % m != 0) == (name in SERVE_ONLY)
    for i in range(DECODE_STEPS + 1):
        got = np.concatenate([np.concatenate([recs[d * m + j]["serve"][name]["logits"][i]
                                              for j in range(m)], axis=-1) for d in range(dp)])
        np.testing.assert_allclose(got, runs["ref"][f"serve_{name}/{i}"], **LOGIT_TOL,
                                   err_msg=f"{name} step {i}")


@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_serving_collectives_are_the_dry_run_rule(runs, name):
    """Each rank's prefill and decode steps issued the dry run's rules for
    a prefill of [B, S] and a decode over the case's cache (whole where M
    does not divide its slots: no partial softmaxes gathered)."""
    cfg = _cfg(name)
    dp, m = _shape(name)
    whole = tf.init_params(cfg, rnd.key(0), device="meta")
    with dryrun.fake_mesh(dp * m, (dp, m)):
        psh = layouts.param_shardings(cfg, whole)
        prefill = dryrun._collectives(cfg, configs.Shape("p", S, B, "prefill"), whole, psh)
        decode = dryrun._collectives(cfg, configs.Shape("d", max_seq(name), B, "decode"), whole,
                                     psh)
    for r in _recs(runs, name):
        counts = r["serve"][name]["counts"]
        assert counts[0] == prefill
        assert all(c == decode for c in counts[1:])


@pytest.mark.parametrize("mesh,sc", [((1, 2), MAX_SEQ + 1), ((1, 2), MAX_SEQ), ((1, 4), MAX_SEQ)])
def test_decode_raises_where_a_rank_s_slots_cannot_tell_the_layout(mesh, sc):
    """A rank's count of cache slots tells a split cache (``Sc/M`` a rank)
    from a whole one (``Sc`` on every rank, M not dividing ``Sc``) only
    where M divides it. Elsewhere decode raises unless it is given the
    session's ``max_seq_len``: 37 slots whole on 2 ranks, and 36 as 9 a
    rank on 4 ranks. 18 of 36 on 2 ranks decodes without it. A
    ``max_seq_len`` that did not size the cache raises too. On the meta
    device under a fake mesh."""
    from repro_torch.models import cache as cache_mod

    cfg = _cfg("odd12")
    whole = tf.init_params(cfg, rnd.key(0), device="meta")
    token = torch.zeros((B,), dtype=torch.int32, device="meta")
    with dryrun.fake_mesh(mesh[0] * mesh[1], mesh):
        psh = layouts.param_shardings(cfg, whole)
        shards = fsdp.shard_tree(whole, psh)
        cache = cache_mod.init_cache(cfg, B // mesh[0], sc, device="meta")

        def decode(**kw):
            return tf.decode(cfg, shards, cache, token, sc - 1, param_shardings=psh, **kw)[0]

        held = cache["slot_pos"].shape[1]
        assert held == (sc if sc % mesh[1] else sc // mesh[1])
        if held % mesh[1]:
            with pytest.raises(ValueError, match="max_seq_len"):
                decode()
        else:
            assert decode().shape == (B, cfg.vocab_padded // mesh[1])
        assert decode(max_seq_len=sc).shape == (B, cfg.vocab_padded // mesh[1])
        with pytest.raises(ValueError, match="not the rank's part"):
            decode(max_seq_len=MAX_SEQ + (sc == MAX_SEQ))


@pytest.mark.parametrize("mesh", [(2, 2), (1, 16)])
@pytest.mark.parametrize("arch", ["musicgen-medium", "mamba2-130m", "zamba2-1.2b",
                                  "llama-3.2-vision-90b"])
def test_the_ranks_caches_are_the_layouts_parts(arch, mesh):
    """``init_cache``'s rank shapes equal the rank's part of the whole tree
    under ``cache_shardings`` (the reference's ``_CACHE_RULES``): the slots
    split where M divides them and whole where it does not (36 and 37
    slots), the ``ssm`` cache on the rank's heads where M divides them,
    ``conv`` and the image K/V whole."""
    from repro_torch.models import cache as cache_mod

    cfg = configs.reduced_config(configs.get_config(arch))
    with dryrun.fake_mesh(mesh[0] * mesh[1], mesh):
        for sc in (MAX_SEQ, MAX_SEQ + 1):
            whole = cache_mod.cache_specs(cfg, 4, sc)
            places = layouts.cache_shardings(cfg, whole)
            mine = cache_mod.init_cache(cfg, 4 // mesh[0], sc, device="meta")  # the rank's rows
            got = {n: tuple(t.shape) for n, t, _ in dryrun._walk(mine, places)}
            want = {n: dryrun._local_shape(t.shape, p) for n, t, p in dryrun._walk(whole, places)}
            assert got == want, (sc, got, want)


@pytest.mark.parametrize("arch", ["musicgen-medium", "mamba2-130m", "zamba2-1.2b",
                                  "llama-3.2-vision-90b"])
def test_a_backward_on_another_thread_recomputes_on_the_mesh(arch):
    """A CUDA backward runs on the autograd engine's own thread, which does
    not see the caller's (thread-local) mesh: every checkpointed block
    (the hybrid's shared block too) recomputes its collectives on the mesh
    it ran on. On the meta device, a backward started from a thread without
    the mesh gives each shard its gradient; a control without remat's
    wrapper (the shared block run bare) fails there."""
    import threading

    cfg = configs.reduced_config(configs.get_config(arch)).replace(remat=True)
    whole = tf.init_params(cfg, rnd.key(0), device="meta")
    toks = torch.zeros((1, S), dtype=torch.int32, device="meta")
    img = torch.zeros((1, cfg.n_image_tokens or 1, cfg.d_model), device="meta")

    def grads(bare=False):
        with dryrun.fake_mesh(2, (1, 2)):
            psh = layouts.param_shardings(cfg, whole)
            shards = opt.tree_map(lambda t: t.requires_grad_(),
                                  fsdp.shard_tree(whole, psh))
            real = tf._at_use
            if bare:
                tf._at_use = lambda fn, places: fn if places is None else real(fn, places)
            try:
                loss = tf.forward(cfg, shards, toks, img, param_shardings=psh)[0].sum()
            finally:
                tf._at_use = real
            got = {}

            def backward():  # the group lives on; the thread has no current mesh
                try:
                    got["grads"] = torch.autograd.grad(loss, list(opt.leaves(shards)))
                except Exception as e:  # noqa: BLE001 - the control's failure is the point
                    got["error"] = e

            t = threading.Thread(target=backward)
            t.start()
            t.join()
        return got, shards

    got, shards = grads()
    assert "error" not in got, got.get("error")
    assert [g.shape for g in got["grads"]] == [p.shape for p in opt.leaves(shards)]
    if cfg.family == "hybrid":
        assert "error" in grads(bare=True)[0]


# ------------------------------------------------------------- the dry run
@pytest.mark.parametrize("arch,shape", [
    ("musicgen-medium", "train_4k"),  # 24 heads whole on 16 model ranks
    ("mamba2-130m", "train_4k"),  # 24 Mamba heads whole
    *((a, "decode_32k") for a in ("musicgen-medium", "mamba2-130m", "zamba2-1.2b",
                                  "llama-3.2-vision-90b")),
])
def test_the_dry_run_plans_the_family_on_16x16(arch, shape):
    """At full width and one unit of depth on the 16 × 16 mesh (a fake
    process group of 256 ranks): the traced step's collectives are the
    rule's (``trace_cell`` raises otherwise), the record names ``16x16``,
    the batch splits over the 16 data ranks and the model axis issues its
    collectives (the mixer's, the shared block's, the cross layers', the
    whole heads')."""
    cfg = configs.get_config(arch)
    rec = dryrun.run_cell(arch, shape, multi_pod=False,
                          overrides={"n_layers": dryrun._probe_depth(cfg)})
    assert rec["mesh"] == "16x16" and rec["chips"] == 256 and rec["batch_split"]
    assert rec["per_rank_batch"] == configs.SHAPES[shape].global_batch // 16
    kinds = rec["collectives"]
    assert kinds["all-reduce"]["count"] > 0 and kinds["all-gather"]["count"] > 0


def test_the_dry_run_plans_two_pods():
    """One family's cell on ``2x16x16``: the record names it."""
    rec = dryrun.run_cell("musicgen-medium", "decode_32k", multi_pod=True,
                          overrides={"n_layers": 1})
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
