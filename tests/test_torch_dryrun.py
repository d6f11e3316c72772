"""The port's dry run against the reference's, on the CPU.

``configs.input_specs`` and ``models.cache.cache_specs`` against the
reference's ``ShapeDtypeStruct`` trees for every runnable cell; the layouts
of ``distributed.params`` against the reference's ``PartitionSpec``s under
an ``AbstractMesh((W, 1), ("data", "model"))`` at W = 1, 8 and 256, at full
width (``'data'`` read as ``Shard(dim)``); the report's parameter counts
and roofline rows against the reference's; the meta trace's FLOPs against
``FlopCounterMode`` over the real CPU step of each family; ``--probe``'s
extrapolation against the full trace; and the fake process group torn down
after every cell. Each test has a control that must fail. Meta tensors
hold no storage, so full-width trees cost nothing here.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.distributed import params as jparams
from repro.distributed import sharding as jsh
from repro.models import transformer as jtf
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.distributed import params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import cache as cache_mod
from repro_torch.models import transformer as tf
from repro_torch.roofline import analysis, report

#: one arch per family, for the traces
FAMILY_ARCHS = ["qwen3-4b", "deepseek-moe-16b", "mamba2-130m", "musicgen-medium",
                "llama-3.2-vision-90b", "zamba2-1.2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the small real steps: where several test
    workers share the cores, torch's default pool waits on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) else np.dtype(d).name


def _flat(tree, names=()):
    """``{key path: leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*names, k)))
        else:
            out[(*names, k)] = v
    return out


def _tree_diffs(port: dict, ref: dict) -> list[str]:
    """Where a tree of meta tensors differs from one of ShapeDtypeStructs."""
    p, r = _flat(port), _flat(ref)
    diffs = [f"keys {sorted(set(p) ^ set(r))}"] if set(p) != set(r) else []
    for k in set(p) & set(r):
        a, b = p[k], r[k]
        if tuple(a.shape) != tuple(b.shape) or _dtype(a.dtype) != _dtype(b.dtype):
            diffs.append(f"{k}: {tuple(a.shape)} {a.dtype} vs {b.shape} {b.dtype}")
        if not a.is_meta:
            diffs.append(f"{k} is on {a.device}")
    return diffs


# ------------------------------------------------------------ meta trees
def test_meta_draws_are_empty_and_cpu_draws_keep_their_bits():
    key = rnd.key(7)
    draws = {
        "randint": (lambda d: rnd.randint(key, (3, 4), 0, 9, device=d), torch.int64),
        "uniform": (lambda d: rnd.uniform(key, (3, 4), device=d), torch.float32),
        "gumbel": (lambda d: rnd.gumbel(key, (3, 4), device=d), torch.float32),
        "normal": (lambda d: rnd.normal(key, (3, 4), device=d, std=0.5), torch.float32),
        "choice": (lambda d: rnd.choice(key, 20, (3, 4), device=d), torch.int64),
        "categorical": (lambda d: rnd.categorical(key, torch.zeros(5, device=d), (3, 4)),
                        torch.int64),
    }
    for name, (draw, dtype) in draws.items():
        m = draw("meta")
        assert m.is_meta and m.shape == (3, 4) and m.dtype == dtype, name
        assert torch.equal(draw("cpu"), draw("cpu")), name  # control: real draws repeat
    gen = torch.Generator().manual_seed(key.seed >> 1)
    want = torch.empty(3, 4).normal_(0.0, 0.5, generator=gen)
    assert torch.equal(rnd.normal(key, (3, 4), device="cpu", std=0.5), want)
    assert rnd.categorical(key, torch.zeros(5, device="meta")).shape == ()


def test_moe_counts_are_bincounts():
    from repro_torch.models import moe

    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 7, 500))
    assert torch.equal(moe._counts(ids, 9), torch.bincount(ids, minlength=9))
    assert moe._counts(ids.to("meta"), 9).shape == (9,)
    assert not torch.equal(moe._counts(ids[1:], 9), torch.bincount(ids, minlength=9))  # control


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_meta_trees_are_the_references_at_full_width(arch):
    from repro.train import optimizer as jopt
    from repro_torch.train import train_step as ts

    params, state = ts.init_train_state(configs.get_config(arch), rnd.key(0), device="meta")
    ref = _ref_param_shapes(arch)
    assert _tree_diffs(params, ref) == []
    jstate = jax.eval_shape(jopt.adamw_init, ref)
    assert _tree_diffs(state, jstate) == []
    # control: another depth differs
    other = tf.init_params(configs.get_config(arch).replace(
        n_layers=2 * dryrun._probe_depth(configs.get_config(arch))), rnd.key(0), device="meta")
    assert _tree_diffs(other, ref)


@pytest.mark.parametrize("arch,shape", jconfigs.runnable_cells())
def test_input_and_cache_specs_are_the_references_on_meta(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    specs = configs.input_specs(cfg, configs.SHAPES[shape])
    ref = jconfigs.input_specs(jcfg, jconfigs.SHAPES[shape])
    assert _tree_diffs(specs, ref) == []
    if "cache" in specs:
        s = configs.SHAPES[shape]
        cache = cache_mod.cache_specs(cfg, s.global_batch, s.seq_len)
        assert _tree_diffs(cache, ref["cache"]) == []
    # control: a batch one row longer is found
    lead = "token" if "token" in specs else "tokens"
    bad = dict(specs, **{lead: torch.empty((specs[lead].shape[0] + 1, *specs[lead].shape[1:]),
                                           dtype=torch.int32, device="meta")})
    assert _tree_diffs(bad, ref)


def test_the_ring_cache_is_bounded_by_the_window():
    cfg = configs.get_config("mixtral-8x22b")
    cache = cache_mod.cache_specs(cfg, 1, configs.SHAPES["long_500k"].seq_len)
    assert cache["k"].shape[2] == cfg.window == 4096 and cache["k"].is_meta
    assert cache_mod.cache_specs(cfg, 1, 1024)["k"].shape[2] == 1024  # control


# ------------------------------------------------------------ the layouts
@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    jcfg = jconfigs.get_config(arch)
    return jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _names(path) -> tuple:
    return tuple(getattr(p, "key", getattr(p, "name", None)) for p in path)


def _spec_tuple(spec, ndim) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _port_spec(placement, ndim) -> tuple:
    """A placement tuple read as a reference spec: ``Shard(d)`` is
    ``'data'`` at d."""
    from torch.distributed.tensor import Replicate, Shard

    (p,) = placement
    assert isinstance(p, (Shard, Replicate)), placement
    return tuple("data" if isinstance(p, Shard) and p.dim == d else None for d in range(ndim))


def _ref_layouts(arch, w):
    """The reference's specs of the parameters and of every runnable
    shape's inputs under an abstract (W, 1) data × model mesh."""
    jcfg = jconfigs.get_config(arch)
    with jsh.use_mesh(AbstractMesh((w, 1), ("data", "model"))):
        flat = jax.tree_util.tree_flatten_with_path(_ref_param_shapes(arch))[0]
        out = {("params", *_names(p)): _spec_tuple(jparams._leaf_spec(jcfg, p, l), l.ndim)
               for p, l in flat}
        for s in configs.SHAPES:
            if (arch, s) not in jconfigs.runnable_cells():
                continue
            specs = jconfigs.input_specs(jcfg, jconfigs.SHAPES[s])
            shard = jparams.input_shardings(jcfg, specs)
            flat_specs = dict(jax.tree_util.tree_flatten_with_path(specs)[0])
            for p, ns in jax.tree_util.tree_flatten_with_path(shard)[0]:
                out[(s, *_names(p))] = _spec_tuple(ns.spec, flat_specs[p].ndim)
    return out


def _port_layouts(arch):
    cfg = configs.get_config(arch)
    tree = tf.init_params(cfg, rnd.key(0), device="meta")
    out = {("params", *k): _port_spec(v, _flat(tree)[k].ndim)
           for k, v in _flat(params.param_shardings(cfg, tree)).items()}
    for s in configs.SHAPES:
        if (arch, s) not in configs.runnable_cells():
            continue
        specs = configs.input_specs(cfg, configs.SHAPES[s])
        flat_specs = _flat(specs)
        for k, v in _flat(params.input_shardings(cfg, specs)).items():
            out[(s, *k)] = _port_spec(v, flat_specs[k].ndim)
    return out


def _mesh(w):
    return make_smoke_mesh("cpu") if w == 1 else dryrun.fake_mesh(w)


@pytest.mark.parametrize("w", [1, 8, 256])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_layouts_are_the_references_specs(arch, w):
    from repro_torch.distributed.sharding import use_mesh

    ref = _ref_layouts(arch, w)
    with _mesh(w) as mesh:
        if w == 1:
            with use_mesh(mesh):
                port = _port_layouts(arch)
        else:
            port = _port_layouts(arch)
    assert not dist.is_initialized()
    assert port == ref
    # control: the layouts at another mesh size differ somewhere
    other = _ref_layouts(arch, 3 if w != 3 else 5)
    assert any(port[k] != other[k] for k in port)


def test_layouts_need_a_mesh():
    cfg = configs.reduced_config(configs.get_config("qwen3-4b"))
    tree = tf.init_params(cfg, rnd.key(0), device="meta")
    with pytest.raises(RuntimeError, match="use_mesh"):
        params.param_shardings(cfg, tree)
    with dryrun.fake_mesh(2):
        assert params.param_shardings(cfg, tree)["embed"][0].dim == 1  # control


def test_make_production_mesh_wants_its_world():
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with dryrun.fake_group(8), pytest.raises(RuntimeError, match="512 ranks, this one has 8"):
        make_production_mesh(multi_pod=True, device="cpu")
    with dryrun.fake_group(512):  # control
        assert make_production_mesh(multi_pod=True, device="cpu").size() == 512
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_n_params_is_the_references(arch):
    cfg = configs.get_config(arch)
    got = report._n_params(cfg)
    assert got == jreport._n_params(jconfigs.get_config(arch))
    # control: a group of layers fewer counts otherwise
    assert got != report._n_params(cfg.replace(n_layers=cfg.n_layers - dryrun._probe_depth(cfg)))


# ------------------------------------------------------------ the traces
def test_the_tally_counts_live_storages_bytes_and_flops():
    """A step whose peak needs the frees: 4,000-byte ``a`` and ``c``, then
    ``a`` (and its view) dropped before a 6,000-byte ``e``; views add no
    storage and no bytes; the arguments are not counted."""

    def step(x, w):
        a = x * 2
        b = a.view(10, 100)
        c = b + 1
        del a, b
        e = torch.empty(1500, device=x.device)
        return (c @ w).sum() + e.sum()

    x, w = torch.empty(1000, device="meta"), torch.empty(100, 5, device="meta")
    with dryrun._Tally(set(dryrun._storage_keys((x, w)))) as tally:
        step(x, w)
    # c, e, the product and its sum at once; without the frees a's 4,000 would stay
    assert tally.peak == 4000 + 6000 + 200 + 4
    assert tally.flops == 2 * 10 * 100 * 5
    # mul 8,000, add 8,000, empty 6,000, mm 4,000 + 2,000 + 200, the two sums
    # 204 and 6,004, the last add 12
    assert tally.bytes_accessed == 8000 + 8000 + 6000 + 6200 + 204 + 6004 + 12


def _small(arch, kind):
    cfg = configs.reduced_config(configs.get_config(arch))
    if kind == "train":
        return cfg.replace(remat=True), configs.Shape("t", 64, 4, "train")
    if kind == "prefill":
        return cfg, configs.Shape("p", 64, 4, "prefill")
    return cfg, configs.Shape("d", 64, 4, "decode")


def _real_flops(cfg, shape):
    from torch.utils.flop_counter import FlopCounterMode

    step, args, _ = dryrun.cell_step(cfg, shape, device="cpu")
    with FlopCounterMode(display=False) as fc:
        step(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_trace_flops_are_the_real_steps(arch, kind):
    cfg, shape = _small(arch, kind)
    with dryrun.fake_mesh(2):
        rec = dryrun.trace_cell(cfg, shape)
        real = _real_flops(cfg, shape)
        # control: the step at another depth counts otherwise
        other = _real_flops(cfg.replace(n_layers=cfg.n_layers * 2), shape)
    assert rec["flops"] == real > 0
    assert other != real
    assert rec["per_rank_batch"] == 2 and rec["batch_split"]
    m = rec["memory"]
    assert m["peak_bytes_est"] == (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
                                   - m["alias_bytes"]) > m["argument_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0 and rec["bytes_accessed"] > 0


def test_the_collective_rule():
    """Gathers once a forward pass in the dtype used, the stacked layers'
    twice with remat; the embedding's looked-up rows exchanged (ids
    all-gathered, rows and their gradients all-to-all) and not the table;
    every other sharded gradient reduce-scattered in f32 once a micro-batch;
    the replicated gradients with the loss averaged in one all-reduce and
    the squared norm summed in another; nothing on one rank. The trace of
    the step (which raises where it issues other collectives) agrees."""
    cfg = configs.reduced_config(configs.get_config("granite-8b")).replace(dtype=torch.bfloat16)
    shape = configs.Shape("t", 64, 4, "train")
    tree = tf.init_params(cfg, rnd.key(0), device="meta")
    with dryrun.fake_mesh(2):
        psh = params.param_shardings(cfg, tree)
        got = {r: dryrun._collectives(cfg.replace(remat=r), shape, tree, psh, 2) for r in (0, 1)}
        accum = dryrun._collectives(cfg.replace(grad_accum=2), shape, tree, psh, 2)
        traced = {r: dryrun.trace_cell(cfg.replace(remat=r), shape)["collectives"] for r in (0, 1)}
        # 1,024 ids a rank, more than the table's 256 rows: the table moves
        long = dryrun.trace_cell(cfg, configs.Shape("t", 512, 4, "train"))["collectives"]
    leaves, places = _flat(tree), _flat(psh)
    sharded = [k for k in leaves if type(places[k][0]).__name__ == "Shard" and k != ("embed",)]
    assert type(places[("embed",)][0]).__name__ == "Shard"
    shard_bytes = sum(leaves[k].numel() // 2 * 2 for k in sharded)  # half a leaf, 2 bytes each
    layer_bytes = sum(leaves[k].numel() // 2 * 2 for k in sharded if k[0] == "layers")
    tokens = 2 * 64  # a rank's rows
    assert 0 < layer_bytes < shard_bytes  # the head is gathered once
    assert got[0]["all-gather"]["bytes"] == shard_bytes + 8 * tokens
    assert got[1]["all-gather"]["bytes"] == shard_bytes + layer_bytes + 8 * tokens
    assert got[0]["all-to-all"] == {"bytes": 2 * tokens * cfg.d_model * 4, "count": 2}
    assert got[0]["reduce-scatter"]["bytes"] == 4 * sum(leaves[k].numel() for k in sharded)
    replicated = sum(t.numel() for k, t in leaves.items()
                     if type(places[k][0]).__name__ != "Shard")
    assert got[0]["all-reduce"] == {"bytes": 4 * (replicated + 1) + 4, "count": 2}
    assert accum["reduce-scatter"]["count"] == 2 * got[0]["reduce-scatter"]["count"]
    assert accum["all-to-all"] == {"bytes": got[0]["all-to-all"]["bytes"], "count": 4}
    assert accum["all-reduce"] == got[0]["all-reduce"]
    assert traced == got
    embed = leaves[("embed",)].numel()
    assert long["all-to-all"]["count"] == 0
    assert long["all-gather"]["bytes"] == shard_bytes + embed // 2 * 4
    assert long["reduce-scatter"]["bytes"] == got[0]["reduce-scatter"]["bytes"] + 4 * embed
    with dryrun.fake_mesh(1):  # control: one rank has none
        assert dryrun._collectives(cfg, shape, tree, params.param_shardings(cfg, tree),
                                   1)["total_bytes"] == 0


@pytest.mark.parametrize("arch,kind,layers", [
    ("granite-8b", "train", 4), ("deepseek-moe-16b", "prefill", 3),
    ("llama-3.2-vision-90b", "train", 6), ("zamba2-1.2b", "decode", 6)])
def test_probe_extrapolation_equals_the_full_trace(arch, kind, layers):
    cfg, shape = _small(arch, kind)
    cfg = cfg.replace(n_layers=layers)
    with dryrun.fake_mesh(2):
        probe = dryrun._probe_costs(cfg, shape)
        full = dryrun.trace_cell(cfg, shape)
    want = {"flops": full["flops"], "bytes_accessed": full["bytes_accessed"],
            "collective_bytes": full["collectives"]["total_bytes"]}
    assert probe["extrapolated"] == pytest.approx(want, rel=1e-12)
    assert probe["probe_1"]["flops"] < full["flops"]  # control: a probe is not the full trace


def _record(probe):
    rec = {"arch": "deepseek-moe-16b", "shape": "train_4k", "chips": 256, "tag": "",
           "flops": 1.3e13, "bytes_accessed": 4.9e11,
           "collectives": {"total_bytes": 6.4e9}, "memory": {"peak_bytes_est": 1.5e10}}
    if probe:
        rec["probe"] = {"extrapolated": {"flops": 2.1e14, "bytes_accessed": 5.5e12,
                                         "collective_bytes": 7.7e10}}
    return rec


@pytest.mark.parametrize("probe", [False, True])
def test_roofline_row_is_the_references(monkeypatch, probe):
    rec = _record(probe)
    cfg, jcfg = configs.get_config(rec["arch"]), jconfigs.get_config(rec["arch"])
    row = report.roofline_row(rec, cfg, configs.SHAPES[rec["shape"]])
    unpatched = jreport.roofline_row(rec, jcfg, jconfigs.SHAPES[rec["shape"]])
    monkeypatch.setattr(janalysis, "PEAK_FLOPS", analysis.PEAK_FLOPS)
    monkeypatch.setattr(janalysis, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(janalysis, "ICI_BW", analysis.NVLINK_BW)
    ref = jreport.roofline_row(rec, jcfg, jconfigs.SHAPES[rec["shape"]])
    # the source names the port's trace, which counts every layer
    assert {k: v for k, v in row.items() if k != "source"} == \
        {k: v for k, v in ref.items() if k != "source"}
    assert row["compute_s"] != unpatched["compute_s"]  # control: the TPU's peaks differ


# ------------------------------------------------------------ run_cell and main
def test_run_cell_leaves_no_process_group(monkeypatch):
    seen = []
    real = dryrun.trace_cell

    def spy(cfg, shape):
        seen.append(dist.is_initialized() and dist.get_world_size())
        return real(cfg, shape)

    monkeypatch.setattr(dryrun, "trace_cell", spy)
    rec = dryrun.run_cell("mamba2-130m", "decode_32k", multi_pod=False,
                          overrides={"n_layers": 1})
    assert seen == [256] and not dist.is_initialized()  # the control: a group while tracing
    # 128 sequences do not split over 256 ranks: each rank decodes all of them
    assert rec["mesh"] == "data256" and rec["per_rank_batch"] == 128 and not rec["batch_split"]

    def boom(cfg, shape):
        seen.append(dist.get_world_size())
        raise ValueError("boom")

    monkeypatch.setattr(dryrun, "trace_cell", boom)
    with pytest.raises(ValueError, match="boom"):
        dryrun.run_cell("mamba2-130m", "decode_32k", multi_pod=True)
    assert seen[-1] == 512 and not dist.is_initialized()


def test_main_writes_records_the_report_reads(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    dryrun.main(["--arch", "mixtral-8x22b", "--shape", "long_500k", "--set", "n_layers=1"])
    # mixtral is a moe config: on the 16 × 16 ("data", "model") mesh
    rec = json.loads((tmp_path / "16x16" / "mixtral-8x22b__long_500k.json").read_text())
    assert rec["chips"] == 256 and not rec["batch_split"] and rec["per_rank_batch"] == 1
    assert rec["collectives"]["all-gather"]["count"] > 0 and "trace_s" in rec
    dry, roof, rows = report.build_tables(tmp_path)
    assert "| mixtral-8x22b | long_500k | " in dry and "whole (1 on every rank)" in dry
    assert [r["shape"] for r in rows] == ["long_500k"] and "runs it whole" in roof
    monkeypatch.chdir(tmp_path)
    doc = tmp_path / "EXPERIMENTS.md"
    doc.write_text("a\n<!-- DRYRUN_TABLE -->\nb\n<!-- ROOFLINE_TABLE -->\n")
    report.main(["--results", str(tmp_path), "--write"])
    assert "| mixtral-8x22b | long_500k |" in doc.read_text()
    with pytest.raises(SystemExit):  # control: a file without markers is refused
        report.main(["--results", str(tmp_path), "--write"])
