"""The port's configs and models held against the reference on the CPU.

The reference's parameters come into the port through
``convert.params_from_numpy``, so both packages compute with the same
weights. Reduced configs (f32, two layers, d 64) as ``reduced_config``
gives them; each arch's reference results are computed once per module.
Tolerances: layers within 1e-5, whole models within 1e-4 (absolute, on
logits of order 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs, convert
from repro_torch import random as rnd
from repro_torch.data import TokenStream
from repro_torch.distributed.sharding import shard
from repro_torch.models import cache as cache_mod
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf

MODEL_ARCHS = ["granite-8b", "qwen3-4b", "mixtral-8x22b", "deepseek-moe-16b", "musicgen-medium"]
B, P, GEN = 2, 64, 3  # P = 2 attention chunks of 32: the block-causal path


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------ configs
def _fields(cfg):
    out = dataclasses.asdict(cfg)
    for name in ("dtype", "param_dtype"):
        v = out[name]
        out[name] = str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else np.dtype(v).name
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_and_reduced_config_are_the_references(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert _fields(cfg) == _fields(jcfg)
    assert _fields(configs.reduced_config(cfg)) == _fields(jconfigs.reduced_config(jcfg))
    assert (cfg.hd, cfg.vocab_padded, cfg.subquadratic) == (jcfg.hd, jcfg.vocab_padded,
                                                            jcfg.subquadratic)


def test_shapes_and_cells_are_the_references():
    assert configs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name, s in configs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jconfigs.SHAPES[name])
    assert configs.runnable_cells() == jconfigs.runnable_cells()
    with pytest.raises(ValueError, match="clustering workload"):
        configs.get_config("bwkm")


# ------------------------------------------------------------------- layers
def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def test_rmsnorm_rope_and_swiglu_agree():
    rng = np.random.RandomState(0)
    x, w = _rand(rng, 2, 5, 3, 16), _rand(rng, 16)
    np.testing.assert_allclose(_n(layers.rmsnorm(_t(x), _t(w))),
                               np.asarray(jlayers.rmsnorm(x, w)), atol=1e-5)
    pos = np.arange(5)
    for theta in (1e4, 1e7):
        np.testing.assert_allclose(_n(layers.rope(_t(x), _t(pos), theta)),
                                   np.asarray(jlayers.rope(x, pos, theta)), atol=1e-5)
    x2, w1, w3, w2 = _rand(rng, 4, 8), _rand(rng, 8, 12), _rand(rng, 8, 12), _rand(rng, 12, 8)
    np.testing.assert_allclose(_n(layers.swiglu(*map(_t, (x2, w1, w3, w2)))),
                               np.asarray(jlayers.swiglu(x2, w1, w3, w2)), atol=1e-5)


@pytest.mark.parametrize("impl,s,window", [("masked_full", 24, None), ("block_causal", 16, None),
                                           ("block_causal", 64, None), ("block_causal", 64, 20),
                                           ("masked_full", 64, 20)])
def test_attention_agrees(impl, s, window):
    rng = np.random.RandomState(s)
    q, k, v = _rand(rng, 2, s, 4, 8), _rand(rng, 2, s, 2, 8), _rand(rng, 2, s, 2, 8)
    kw = dict(window=window, impl=impl, chunk=16)
    got = layers.attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(_n(got), np.asarray(jlayers.attention(q, k, v, **kw)), atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_agrees_over_a_ring(window):
    rng = np.random.RandomState(1)
    q, kc, vc = _rand(rng, 2, 4, 8), _rand(rng, 2, 12, 2, 8), _rand(rng, 2, 12, 2, 8)
    slot_pos = np.where(rng.rand(2, 12) < 0.2, -1, rng.randint(0, 20, (2, 12))).astype(np.int32)
    got = layers.decode_attention(_t(q), _t(kc), _t(vc), _t(slot_pos), 15, window=window)
    want = jlayers.decode_attention(q, kc, vc, slot_pos, jnp.asarray(15), window=window)
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-5)


# --------------------------------------------------------- whole models
_REF: dict = {}


def _reference(arch):
    """The reference's params and results for ``arch``, computed once."""
    if arch not in _REF:
        jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        toks = np.random.RandomState(0).randint(0, jcfg.vocab, (B, P)).astype(np.int32)
        logits, aux, _ = jtf.forward(jcfg, jp, jnp.asarray(toks))
        last, cache = jtf.prefill(jcfg, jp, jnp.asarray(toks), max_seq_len=P + GEN)
        # one layer's decode block on the prefill cache, the token at slot P
        x = np.random.RandomState(1).randn(B, jcfg.d_model).astype(np.float32)
        slot_pos = cache["slot_pos"].at[:, P % cache["slot_pos"].shape[1]].set(P)
        blk_in = dict(x=x, kc=np.asarray(cache["k"][0]), vc=np.asarray(cache["v"][0]),
                      slot_pos=np.asarray(slot_pos))
        blk_out = jtf.dense_block_decode(jcfg, jax.tree.map(lambda a: a[0], jp["layers"]),
                                         jnp.asarray(x), cache["k"][0], cache["v"][0], slot_pos,
                                         jnp.asarray(P, jnp.int32))
        steps, tok = [], np.zeros(B, np.int32)
        for i in range(GEN):
            out, cache = jtf.decode(jcfg, jp, cache, jnp.asarray(tok), jnp.asarray(P + i, jnp.int32))
            steps.append((tok, np.asarray(out)))
            tok = np.asarray(jnp.argmax(out, -1)).astype(np.int32)
        _REF[arch] = dict(params=jax.tree.map(np.asarray, jp), toks=toks, logits=np.asarray(logits),
                          aux=float(aux), last=np.asarray(last), steps=steps, blk_in=blk_in,
                          blk_out=[np.asarray(a) for a in blk_out])
    return _REF[arch]


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_prefill_and_decode_follow_the_reference(arch):
    ref = _reference(arch)
    cfg = configs.reduced_config(configs.get_config(arch))
    params = convert.params_from_numpy(ref["params"], device="cpu")
    toks = _t(ref["toks"])
    logits, aux, _ = tf.forward(cfg, params, toks)
    np.testing.assert_allclose(_n(logits), ref["logits"], atol=1e-4)
    np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-5, atol=1e-6)
    last, cache = tf.prefill(cfg, params, toks, max_seq_len=P + GEN)
    np.testing.assert_allclose(_n(last), ref["last"], atol=1e-4)
    assert cache["k"].shape[2] == cache_mod.cache_seq_len(cfg, P + GEN)
    blk_in = {k: _t(v) for k, v in ref["blk_in"].items()}
    got = tf.dense_block_decode(cfg, tf.layer(params["layers"], 0), blk_in["x"], blk_in["kc"],
                                blk_in["vc"], blk_in["slot_pos"], P)
    for g, w in zip(got, ref["blk_out"]):
        np.testing.assert_allclose(_n(g), w, atol=1e-4)
    assert all(np.array_equal(_n(blk_in[k]), ref["blk_in"][k]) for k in blk_in)  # functional
    for i, (tok, want) in enumerate(ref["steps"]):
        before = {k: v.clone() for k, v in cache.items()}
        out, new = tf.decode(cfg, params, cache, _t(tok), P + i)
        np.testing.assert_allclose(_n(out), want, atol=1e-4)
        assert all(torch.equal(before[k], cache[k]) for k in before)  # functional
        cache = new


def test_params_round_trip_and_init_draws_the_reference_tree():
    ref = _reference("deepseek-moe-16b")["params"]
    back = convert.params_to_numpy(convert.params_from_numpy(ref, device="cpu"))
    flat_ref, _ = jax.tree_util.tree_flatten_with_path(ref)
    flat_back, _ = jax.tree_util.tree_flatten_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    cfg = configs.reduced_config(configs.get_config("deepseek-moe-16b"))
    mine = convert.params_to_numpy(tf.init_params(cfg, rnd.key(0), device="cpu"))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), mine) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), ref)
    again = convert.params_to_numpy(tf.init_params(cfg, rnd.key(0), device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, mine, again)
    bf = {"w": torch.randn(3, 4).to(torch.bfloat16)}
    assert torch.equal(convert.params_from_numpy(convert.params_to_numpy(bf), device="cpu")["w"],
                       bf["w"])


def test_moe_dispatch_and_combine_are_exact_when_dropless():
    rng = np.random.RandomState(3)
    t, d, e, k = 40, 8, 4, 2
    x = _rand(rng, t, d)
    logits = _rand(rng, t, e)
    logits[:5] = 0.0  # ties: the lower expert id goes first
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    jp, ji = jax.lax.top_k(jnp.asarray(probs), k)
    order = torch.sort(_t(probs), dim=-1, descending=True, stable=True).indices[:, :k]
    np.testing.assert_array_equal(_n(order), np.asarray(ji))
    cap = t * k  # dropless
    got = moe._dispatch(_t(x), _t(np.asarray(jp)), _t(np.asarray(ji)).long(), e, cap)
    want = jmoe._dispatch(jnp.asarray(x), jp, ji, e, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), np.asarray(w))
    y = moe._combine(got[0], *got[1:], t)  # identity experts: Σ_j gate_j · x
    np.testing.assert_allclose(_n(y), x * np.asarray(jp).sum(1, keepdims=True), atol=1e-6)
    np.testing.assert_allclose(_n(y), np.asarray(jmoe._combine(want[0], *want[1:], t)), atol=1e-6)
    assert torch.equal(y, moe._combine(got[0], *got[1:], t))


def test_moe_router_and_replace_router_follow_the_reference():
    rng = np.random.RandomState(4)
    x, w = _rand(rng, 16, 8), _rand(rng, 8, 4)
    got = moe._router(_t(x), _t(w), 2)
    for g, r in zip(got, jmoe._router(jnp.asarray(x), jnp.asarray(w), 2)):
        np.testing.assert_allclose(_n(g), np.asarray(r), atol=1e-6)
    p = {"router": torch.zeros(4, 6, 3)}
    assert moe.replace_router(p, np.ones((6, 3), np.float32))["router"].shape == (4, 6, 3)
    for bad in (np.ones((5, 3), np.float32), np.full((6, 3), np.nan, np.float32)):
        with pytest.raises(ValueError):
            moe.replace_router(p, bad)
        with pytest.raises(ValueError):
            jmoe.replace_router({"router": jnp.zeros((4, 6, 3))}, bad)
    assert moe.moe_mode(64, 16) == jmoe.moe_mode(64, 16) == "ep"
    assert moe.moe_mode(8, 16) == jmoe.moe_mode(8, 16) == "ep_split"


def test_token_stream_is_bit_equal_to_the_references():
    for kw, step, host in [(dict(vocab=49152, seq_len=64, global_batch=4), 0, (0, 1)),
                           (dict(vocab=256, seq_len=16, global_batch=8, seed=3), 5, (1, 2))]:
        got, labels = TokenStream(**kw).batch(step, host_id=host[0], n_hosts=host[1], device="cpu")
        want, _ = JTokenStream(**kw).batch(step, host_id=host[0], n_hosts=host[1])
        assert got.dtype == torch.int32 and got is labels
        np.testing.assert_array_equal(_n(got), np.asarray(want))


def test_shard_returns_its_input_and_checks_the_rank():
    x = torch.zeros(2, 3)
    assert shard(x, "batch", None) is x
    with pytest.raises(ValueError):
        shard(x, "batch")
