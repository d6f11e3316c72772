"""The port's ssm, hybrid and vlm families held against the reference on the
CPU: ``models.mamba2``, their caches, ``cross_attention`` and the whole
models (mamba2-130m, zamba2-1.2b with and without a Mamba tail,
llama-3.2-vision-90b), at ``reduced_config`` (f32).

The reference's initialisation hides what these families add: Mamba2's
unit ``d_skip`` and zero ``a_log`` let the skip term dominate at small
width, and the vlm's gates start at 0. So every comparison feeds both
packages the same *stressed* numpy parameters (no skip, seeded decay rates
and step biases, wide in-projections and convs, non-zero gates), and each
has a control that must fail: the port with the carried SSD state zeroed
between chunks, or the vlm with other image embeddings, differs from the
reference by more than 100× the tolerance. Tolerances: layers within 1e-5
(absolute and relative: the f32 SSM states reach about 6), whole models
within 1e-4 (absolute, on logits of order 1);
chunked against sequential SSD at the reference's rtol/atol of 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import vq as jvq
from repro.launch import serve as jserve
from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models import mamba2 as jm
from repro.models import transformer as jtf
from repro_torch import configs, convert, vq
from repro_torch import random as rnd
from repro_torch.launch import serve
from repro_torch.models import cache as cache_mod
from repro_torch.models import layers, mamba2
from repro_torch.models import transformer as tf

B, P, GEN = 2, 64, 3  # P = 4 SSD chunks of 16
TOL_LAYER, TOL_MODEL, TOL_SEQ = 1e-5, 1e-4, 2e-3
#: (arch, n_layers override): zamba2's reduced config has no Mamba tail;
#: five layers give two groups of two and a tail of one
MODELS = {"mamba2-130m": ("mamba2-130m", None), "zamba2-1.2b": ("zamba2-1.2b", None),
          "zamba2-tail": ("zamba2-1.2b", 5), "llama-3.2-vision-90b": ("llama-3.2-vision-90b", None)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread: with several test workers on the
    cores, each worker's intra-op pool spinning on every core slowed this
    file several times over (the tolerances hold at any thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().cpu().numpy()


def _cfgs(name):
    arch, n_layers = MODELS[name]
    cfg = configs.reduced_config(configs.get_config(arch))
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    if n_layers:
        cfg, jcfg = cfg.replace(n_layers=n_layers), jcfg.replace(n_layers=n_layers)
    return cfg, jcfg


def _stress(tree, rng, d_model):
    """The stressed copy of a reference parameter tree (numpy leaves)."""
    scale = 0.3 * np.sqrt(64 / d_model)  # in-projection std: pre-activations near N(0, 2.4²)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _stress(v, rng, d_model)
            continue
        v = np.asarray(v)
        draw = {
            "in_proj": lambda: rng.randn(*v.shape) * scale,
            "conv_w": lambda: rng.randn(*v.shape) * 0.4,
            "conv_b": lambda: rng.randn(*v.shape) * 0.1,
            "a_log": lambda: rng.uniform(-3.0, -1.0, v.shape),
            "dt_bias": lambda: rng.uniform(-3.0, -1.0, v.shape),
            "d_skip": lambda: np.zeros(v.shape),
            "gate_attn": lambda: rng.uniform(0.5, 1.5, v.shape),
            "gate_mlp": lambda: rng.uniform(0.5, 1.5, v.shape),
        }.get(k)
        out[k] = draw().astype(v.dtype) if draw else v
    return out


def _zeroed_state(monkeypatch):
    """The control: every chunk starts from a zero state."""
    step = mamba2._chunk_step
    monkeypatch.setattr(mamba2, "_chunk_step",
                        lambda state, *a: step(torch.zeros_like(state), *a))


def _far(got, want, tol):
    return float(np.abs(_n(got) - np.asarray(want)).max()) > 100 * tol


# -------------------------------------------------------------- the block
def _block(seed):
    cfg = configs.reduced_config(configs.get_config("mamba2-130m"))
    jcfg = jconfigs.reduced_config(jconfigs.get_config("mamba2-130m"))
    jp = jm.init_mamba_params(jcfg, jax.random.PRNGKey(seed))
    p = _stress(jax.tree.map(np.asarray, jp), np.random.RandomState(seed), cfg.d_model)
    return cfg, jcfg, p


def _sequential(cfg, p, x):
    """Per-token recurrence oracle for the chunked SSD (the port's decode)."""
    dims = mamba2.mamba_dims(cfg)
    b, s, _ = x.shape
    conv = torch.zeros((b, cfg.ssm_conv - 1, dims["conv_dim"]), dtype=x.dtype)
    ssm = torch.zeros((b, dims["nheads"], cfg.ssm_headdim, dims["n"]))
    outs = []
    for t in range(s):
        y, (conv, ssm) = mamba2.mamba_decode(cfg, p, x[:, t], conv, ssm)
        outs.append(y)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba_forward_and_decode_follow_the_reference(seed, monkeypatch):
    cfg, jcfg, p = _block(seed)
    pt = convert.params_from_numpy(p, device="cpu")
    x = np.random.RandomState(seed + 10).randn(B, P, cfg.d_model).astype(np.float32)
    want = jm.mamba_forward(jcfg, p, jnp.asarray(x))
    np.testing.assert_allclose(_n(mamba2.mamba_forward(cfg, pt, _t(x))), np.asarray(want),
                               rtol=TOL_LAYER, atol=TOL_LAYER)
    out, (conv, ssm) = mamba2.mamba_forward(cfg, pt, _t(x), return_state=True)
    jout, (jconv, jssm) = jm.mamba_forward(jcfg, p, jnp.asarray(x), return_state=True)
    for g, w in ((out, jout), (conv, jconv), (ssm, jssm)):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=TOL_LAYER, atol=TOL_LAYER)
    assert conv.shape == (B, cfg.ssm_conv - 1, mamba2.mamba_dims(cfg)["conv_dim"])
    x1 = np.random.RandomState(seed + 20).randn(B, cfg.d_model).astype(np.float32)
    before = (conv.clone(), ssm.clone())
    y, (c1, s1) = mamba2.mamba_decode(cfg, pt, _t(x1), conv, ssm)
    jy, (jc1, js1) = jm.mamba_decode(jcfg, p, jnp.asarray(x1), jconv, jssm)
    for g, w in ((y, jy), (c1, jc1), (s1, js1)):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=TOL_LAYER, atol=TOL_LAYER)
    assert torch.equal(before[0], conv) and torch.equal(before[1], ssm)  # functional
    _zeroed_state(monkeypatch)  # the control
    assert _far(mamba2.mamba_forward(cfg, pt, _t(x)), want, TOL_LAYER)


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_chunked_matches_sequential(seed, monkeypatch):
    """The reference's test on the port, with stressed parameters."""
    cfg, _, p = _block(seed)
    pt = convert.params_from_numpy(p, device="cpu")
    x = rnd.normal(rnd.key(seed + 10), (2, 32, cfg.d_model), device="cpu")
    y_seq = _sequential(cfg, pt, x)
    torch.testing.assert_close(mamba2.mamba_forward(cfg, pt, x), y_seq, rtol=TOL_SEQ, atol=TOL_SEQ)
    _zeroed_state(monkeypatch)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(mamba2.mamba_forward(cfg, pt, x), y_seq, rtol=TOL_SEQ,
                                   atol=TOL_SEQ)


def test_ssd_forward_state_matches_decode_continuation(monkeypatch):
    cfg, _, p = _block(0)
    pt = convert.params_from_numpy(p, device="cpu")
    x = rnd.normal(rnd.key(1), (1, 48, cfg.d_model), device="cpu")
    y_full = _sequential(cfg, pt, x[:, :33])
    _, (conv, ssm) = mamba2.mamba_forward(cfg, pt, x[:, :32], return_state=True)
    y_dec, _ = mamba2.mamba_decode(cfg, pt, x[:, 32], conv, ssm)
    torch.testing.assert_close(y_dec, y_full[:, 32], rtol=TOL_SEQ, atol=TOL_SEQ)
    _zeroed_state(monkeypatch)
    _, (conv, ssm) = mamba2.mamba_forward(cfg, pt, x[:, :32], return_state=True)
    y_dec, _ = mamba2.mamba_decode(cfg, pt, x[:, 32], conv, ssm)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(y_dec, y_full[:, 32], rtol=TOL_SEQ, atol=TOL_SEQ)


def _bf16_gap(cfg, params, toks, at=32, steps=4):
    """Prefill of ``at`` tokens and ``steps`` decode steps against the
    full forward's logits there, as a share of their largest."""
    full, _, _ = tf.forward(cfg, params, toks)
    want = full[:, at - 1 : at - 1 + steps, : cfg.vocab]
    last, cache = tf.prefill(cfg, params, toks[:, :at], max_seq_len=at + steps)
    got = [last]
    for j in range(steps - 1):
        out, cache = tf.decode(cfg, params, cache, toks[:, at + j], at + j)
        got.append(out)
    got = torch.stack(got, 1)[..., : cfg.vocab]
    return float((got - want).abs().max() / want.abs().max())


def test_bf16_prefill_and_decode_continue_the_forward(monkeypatch):
    """In bf16 the chunked conv and a decode step's conv do the same
    arithmetic (taps summed in f32, one rounding), so a prefill continued
    by decode steps gives the forward's logits (ROADMAP C11). The control,
    each tap rounded to bf16 as it is added, put them 3 % of the largest
    logit apart at mamba2-130m's full width on the card."""
    cfg = configs.reduced_config(configs.get_config("mamba2-130m")).replace(
        n_layers=24, d_model=128, dtype=torch.bfloat16)
    params = tf.init_params(cfg, rnd.key(25), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab, (4, 64)))
    assert _bf16_gap(cfg, params, toks) <= 1e-3

    def per_tap(xbc, w, b):  # the sequence's conv only; decode keeps one rounding
        pad = torch.nn.functional.pad(xbc, (0, 0, w.shape[0] - 1, 0))
        out = pad[:, : xbc.shape[1]] * w[0]
        for i in range(1, w.shape[0]):
            out = out + pad[:, i : i + xbc.shape[1]] * w[i]
        return torch.nn.functional.silu(out + b)

    monkeypatch.setattr(mamba2, "_causal_conv", per_tap)
    assert _bf16_gap(cfg, params, toks) > 1e-2


def test_softplus_is_jaxs_past_torchs_threshold():
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 20.0, 21.0, 25.0, 80.0], np.float32)
    np.testing.assert_array_equal(_n(mamba2._softplus(_t(x))), np.asarray(jax.nn.softplus(x)))


def test_mamba_forward_refuses_a_partial_chunk():
    cfg, jcfg, p = _block(0)
    pt = convert.params_from_numpy(p, device="cpu")
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        mamba2.mamba_forward(cfg, pt, torch.zeros(1, cfg.ssm_chunk + 8, cfg.d_model))
    with pytest.raises(AssertionError):
        jm.mamba_forward(jcfg, p, jnp.zeros((1, jcfg.ssm_chunk + 8, jcfg.d_model)))


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("s,t,h,kv", [(5, 8, 4, 2), (1, 17, 8, 8)])
def test_cross_attention_agrees(s, t, h, kv):
    rng = np.random.RandomState(s + t)
    q = rng.randn(2, s, h, 16).astype(np.float32) * 2
    k, v = (rng.randn(2, t, kv, 16).astype(np.float32) * 2 for _ in range(2))
    np.testing.assert_allclose(_n(layers.cross_attention(_t(q), _t(k), _t(v))),
                               np.asarray(jlayers.cross_attention(q, k, v)), atol=TOL_LAYER)


def _tree_meta(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), np.dtype(a.dtype).name), tree)


@pytest.mark.parametrize("name", list(MODELS))
def test_init_cache_is_the_references(name):
    cfg, jcfg = _cfgs(name)
    got = convert.params_to_numpy(cache_mod.init_cache(cfg, B, P + GEN, device="cpu"))
    want = jax.tree.map(np.asarray, jcache.init_cache(jcfg, B, P + GEN))
    assert _tree_meta(got) == _tree_meta(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert ("mamba_tail" in got) == (name == "zamba2-tail")


_INIT: dict = {}


def _ref_init(name):
    """The reference's initial parameters for ``name`` as numpy, drawn once."""
    if name not in _INIT:
        _, jcfg = _cfgs(name)
        _INIT[name] = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    return _INIT[name]


@pytest.mark.parametrize("name", list(MODELS))
def test_init_params_draws_the_reference_tree_and_round_trips(name):
    cfg, _ = _cfgs(name)
    mine = convert.params_to_numpy(tf.init_params(cfg, rnd.key(0), device="cpu"))
    want = _ref_init(name)
    assert _tree_meta(mine) == _tree_meta(want)
    # the reference's constants: unit norms and skips, zero biases, decay logs and gates
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = path[-1].key
        if key in ("conv_b", "a_log", "dt_bias", "d_skip", "norm_w", "gate_attn", "gate_mlp"):
            got = mine
            for p in path:
                got = got[p.key]
            np.testing.assert_array_equal(got, leaf)
    back = convert.params_to_numpy(convert.params_from_numpy(want, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, want)


# -------------------------------------------------------------- the models
_REF: dict = {}


def _images(cfg, seed):
    if cfg.family != "vlm":
        return None
    return np.random.RandomState(seed).randn(B, cfg.n_image_tokens, cfg.d_model).astype(np.float32)


def _reference(name):
    """The reference's stressed params and results for ``name``, once."""
    if name not in _REF:
        cfg, jcfg = _cfgs(name)
        params = _stress(_ref_init(name), np.random.RandomState(7), jcfg.d_model)
        jp = jax.tree.map(jnp.asarray, params)
        toks = np.random.RandomState(0).randint(0, jcfg.vocab, (B, P)).astype(np.int32)
        img = _images(jcfg, 1)
        jimg = None if img is None else jnp.asarray(img)
        logits, _, _ = jtf.forward(jcfg, jp, jnp.asarray(toks), jimg)
        last, cache = jtf.prefill(jcfg, jp, jnp.asarray(toks), jimg, max_seq_len=P + GEN)
        steps, tok = [], np.zeros(B, np.int32)
        for i in range(GEN):
            out, cache = jtf.decode(jcfg, jp, cache, jnp.asarray(tok), jnp.asarray(P + i, jnp.int32))
            steps.append((tok, np.asarray(out)))
            tok = np.asarray(jnp.argmax(out, -1)).astype(np.int32)
        _REF[name] = dict(params=params, toks=toks, img=img, logits=np.asarray(logits),
                          last=np.asarray(last), steps=steps)
    return _REF[name]


def _run_port(name, img=None):
    """The port's forward, prefill and decode steps on the reference's
    inputs; every cache given is checked to be left as it was."""
    ref = _reference(name)
    cfg, _ = _cfgs(name)
    params = convert.params_from_numpy(ref["params"], device="cpu")
    toks = _t(ref["toks"])
    img = _t(ref["img"] if img is None else img) if cfg.family == "vlm" else None
    logits, _, _ = tf.forward(cfg, params, toks, img)
    last, cache = tf.prefill(cfg, params, toks, img, max_seq_len=P + GEN)
    steps = []
    for i, (tok, _) in enumerate(ref["steps"]):
        before = tf._clone_tree(cache)
        out, new = tf.decode(cfg, params, cache, _t(tok), P + i)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(_n(a), _n(b)), before, cache)
        steps.append(out)
        cache = new
    return logits, last, steps


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_prefill_and_decode_follow_the_reference(name):
    ref = _reference(name)
    logits, last, steps = _run_port(name)
    np.testing.assert_allclose(_n(logits), ref["logits"], atol=TOL_MODEL)
    np.testing.assert_allclose(_n(last), ref["last"], atol=TOL_MODEL)
    for got, (_, want) in zip(steps, ref["steps"]):
        np.testing.assert_allclose(_n(got), want, atol=TOL_MODEL)
    assert np.abs(ref["logits"]).max() > 0.1  # logits of order 1, not a vanishing residue


@pytest.mark.parametrize("name", list(MODELS))
def test_the_control_fails_against_the_reference(name, monkeypatch):
    """The port with the carried state zeroed between chunks (ssm, hybrid),
    or the vlm with other image embeddings, is far from the reference."""
    ref = _reference(name)
    cfg, _ = _cfgs(name)
    if cfg.family == "vlm":
        logits, last, steps = _run_port(name, img=_images(cfg, 2))
    else:
        _zeroed_state(monkeypatch)
        logits, last, steps = _run_port(name)
    assert _far(logits, ref["logits"], TOL_MODEL)
    assert _far(last, ref["last"], TOL_MODEL)
    assert _far(steps[0], ref["steps"][0][1], TOL_MODEL)


def test_vlm_forward_needs_image_embeds():
    cfg, jcfg = _cfgs("llama-3.2-vision-90b")
    params = tf.init_params(cfg, rnd.key(0), device="cpu")
    with pytest.raises(ValueError, match="image_embeds"):
        tf.forward(cfg, params, torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(AssertionError):
        jtf.forward(jcfg, _ref_init("llama-3.2-vision-90b"), jnp.zeros((1, 8), jnp.int32))


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b"])
def test_generate_gives_the_references_tokens(name):
    ref = _reference(name)
    cfg, jcfg = _cfgs(name)
    prompts = ref["toks"][:, :32]
    got = serve.generate(cfg, convert.params_from_numpy(ref["params"], device="cpu"), prompts, 6)
    want = jserve.generate(jcfg, jax.tree.map(jnp.asarray, ref["params"]), jnp.asarray(prompts), 6)
    np.testing.assert_array_equal(_n(got), np.asarray(want))


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_lm_driver_serves_the_recurrent_families(arch, capsys):
    out = serve.lm_main(["--arch", arch, "--batch", "2", "--prompt-len", "16", "--gen", "4"],
                        device="cpu")
    assert out["tokens"].shape == (2, 4) and out["tok_per_s"] > 0
    assert f"[serve] {arch} generated [2, 4] tokens" in capsys.readouterr().out


def test_kv_quantize_refuses_the_recurrent_families_with_the_references_error():
    with pytest.raises(ValueError) as want:
        jvq.n_kv_layers(jconfigs.get_config("mamba2-130m"))
    with pytest.raises(ValueError) as got:
        serve.lm_main(["--arch", "mamba2-130m", "--batch", "2", "--prompt-len", "16", "--gen",
                       "2", "--kv-quantize"], device="cpu")
    assert str(got.value) == str(want.value)


def test_cache_dump_source_refuses_a_vlm_as_the_reference_does():
    cfg = configs.reduced_config(configs.get_config("llama-3.2-vision-90b"))
    with pytest.raises(NotImplementedError, match="harvest its cache externally"):
        vq.CacheDumpSource(cfg, {}, np.zeros((1, 8), np.int32), layer=0)
