"""The port's training path held against the reference on the CPU: the
flash backward (``layers._Flash``), ``train.optimizer``,
``train.train_step`` and ``cfg.remat``, for one arch of every family.

The reference's parameters come into the port through
``convert.params_from_numpy``; the ssm and hybrid blocks get seeded decay
rates and step biases and no skip term, and the vlm non-zero gates, so that
the gradients run through the carried SSD state and the cross-attention
(the reference's initialisation keeps both near silent). Each arch's
reference results are computed once per module.

Tolerances: flash gradients rtol 2e-4, atol 2e-5 (the reference's own
``tests/test_layers.py``); the optimizer within 1e-6; the cross entropy
within 1e-6; a model's loss within 1e-5 and each gradient leaf within 1e-4
of its own max |g|; three AdamW steps' losses within 1e-4. Parameters are
not compared after AdamW steps element by element: m̂/√v̂ turns gradients
near zero into ±1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch import random as rnd
from repro_torch.launch import dryrun
from repro_torch.models import layers, mamba2, moe
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

B, S = 2, 64  # two attention chunks of 32 (the flash path); four SSD chunks of 16
FAMILIES = {"dense": "granite-8b", "moe": "deepseek-moe-16b", "audio": "musicgen-medium",
            "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b", "vlm": "llama-3.2-vision-90b"}
ARCHS = list(FAMILIES.values())
STEPS_CFG = dict(lr=1e-2, warmup_steps=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small models: where several test
    workers share the cores, torch's default pool waits on busy cores and
    runs many times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().cpu().numpy()


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# -------------------------------------------------------------- flash
def _flash_inputs(dtype=np.float32):
    rng = np.random.RandomState(0)
    q = rng.randn(2, 32, 4, 8).astype(dtype)
    k, v = rng.randn(2, 32, 2, 8).astype(dtype), rng.randn(2, 32, 2, 8).astype(dtype)
    return q, k, v, rng.randn(2, 32, 4, 8).astype(np.float32)


@pytest.mark.parametrize("window", [None, 7])
def test_flash_gradients_follow_the_reference(window):
    q, k, v, co = _flash_inputs()
    kw = dict(impl="block_causal", chunk=8, window=window)
    want = jax.grad(lambda *a: jnp.sum(jlayers.attention(*a, **kw) * co), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = layers.attention(tq, tk, tv, **kw)
    got = torch.autograd.grad((out * _t(co)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=2e-4, atol=2e-5)
    # the port's own dense path agrees too, and the forward's bits are the
    # no-grad forward's
    dense = layers.attention(tq, tk, tv, impl="masked_full", window=window)
    for g, d in zip(got, torch.autograd.grad((dense * _t(co)).sum(), (tq, tk, tv))):
        np.testing.assert_allclose(_n(g), _n(d), rtol=2e-4, atol=2e-5)
    with torch.no_grad():
        assert torch.equal(layers.attention(tq, tk, tv, **kw), out)
        flat, _, _ = layers._flash_fwd(tq.reshape(2, 32, 2, 2, 8), tk, tv, window, 8)
        assert torch.equal(flat.reshape(out.shape), out)


def test_flash_keeps_o_s_residuals_and_returns_the_input_dtypes():
    q, k, v, co = _flash_inputs()
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = layers.attention(tq, tk, tv, impl="block_causal", chunk=8)
    tile = 2 * 2 * 2 * 8 * 8  # [B, KV, G, c, c]: one tile's probabilities
    assert saved and max(saved) <= tq.numel() and len(saved) <= 8, saved
    assert sum(n == tile for n in saved) == 0
    qb, kb, vb = (_t(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    out = layers.attention(qb, kb, vb, impl="block_causal", chunk=8)
    got = torch.autograd.grad((out.float() * _t(co)).sum(), (qb, kb, vb))
    assert all(g.dtype == torch.bfloat16 and g.shape == t.shape for g, t in zip(got, (qb, kb, vb)))


# ---------------------------------------------------------- optimizer
def _tree(rng):
    """Keys inserted out of sorted order: the leaf order must be sorted."""
    return {"w": rng.randn(5, 3).astype(np.float32),
            "b": {"z": rng.randn(4).astype(np.float32), "a": rng.randn(2, 2).astype(np.float32)}}


def _torch_tree(tree):
    return convert.params_from_numpy(tree, device="cpu")


def test_schedule_norm_and_clip_follow_the_reference():
    ocfg = opt.AdamWConfig(lr=2e-3, warmup_steps=4, total_steps=20)
    jcfg = jopt.AdamWConfig(lr=2e-3, warmup_steps=4, total_steps=20)
    for step in (0, 1, 3, 4, 5, 12, 20, 25):
        np.testing.assert_allclose(float(opt.schedule(ocfg, torch.tensor(step, dtype=torch.int32))),
                                   float(jopt.schedule(jcfg, jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=1e-12)
    tree = _tree(np.random.RandomState(0))
    np.testing.assert_allclose(float(opt.global_norm(_torch_tree(tree))),
                               float(jopt.global_norm(tree)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        got, gn = opt.clip_by_global_norm(_torch_tree(tree), max_norm)
        want, wn = jopt.clip_by_global_norm(tree, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        for g, w in zip(opt.leaves(got), _flat(want)):
            np.testing.assert_allclose(_n(g), w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [0.3, 10.0])
def test_adamw_update_follows_the_reference(clip):
    rng = np.random.RandomState(1)
    params, grads = _tree(rng), _tree(rng)
    state = {"m": _tree(rng), "v": jax.tree.map(lambda a: np.abs(a) * 0.1, _tree(rng)),
             "step": np.int32(3)}
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jstate = {"m": state["m"], "v": state["v"], "step": jnp.asarray(3, jnp.int32)}
    wp, ws, wm = jopt.adamw_update(jcfg, params, grads, jstate)
    tstate = {"m": _torch_tree(state["m"]), "v": _torch_tree(state["v"]),
              "step": torch.tensor(3, dtype=torch.int32)}
    gp, gs, gm = opt.adamw_update(ocfg, _torch_tree(params), _torch_tree(grads), tstate)
    for g, w in zip([*opt.leaves(gp), *opt.leaves(gs["m"]), *opt.leaves(gs["v"])],
                    [*_flat(wp), *_flat(ws["m"]), *_flat(ws["v"])]):
        np.testing.assert_allclose(_n(g), w, rtol=1e-6, atol=1e-6)
    assert gs["step"].dtype == torch.int32 and int(gs["step"]) == int(ws["step"]) == 4
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)
    fresh = opt.adamw_init(_torch_tree(params))
    assert int(fresh["step"]) == 0 and fresh["step"].dtype == torch.int32
    assert all(float(t.abs().sum()) == 0 for t in opt.leaves(fresh["m"]))


@pytest.mark.parametrize("vocab", [260, None])
def test_cross_entropy_masks_the_padding_columns(vocab):
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 9, 300).astype(np.float32) * 3
    logits[..., 260:] += 5.0  # padding columns that would dominate if not masked
    labels = rng.randint(0, 260, (2, 9)).astype(np.int32)
    got = ts.cross_entropy(_t(logits), _t(labels), vocab=vocab)
    want = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), vocab=vocab)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------- every family
_REF: dict = {}


def _stress(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _stress(v, rng)
        elif k in ("a_log", "dt_bias"):
            out[k] = rng.uniform(-3.0, -1.0, v.shape).astype(v.dtype)
        elif k == "d_skip":
            out[k] = np.zeros_like(v)
        elif k in ("gate_attn", "gate_mlp"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        else:
            out[k] = v
    return out


def _inputs(jcfg):
    toks = np.random.RandomState(0).randint(0, jcfg.vocab, (B, S)).astype(np.int32)
    img = (np.random.RandomState(1).randn(B, jcfg.n_image_tokens, jcfg.d_model)
           .astype(np.float32) * 0.5 if jcfg.family == "vlm" else None)
    return toks, img


def _reference(arch):
    """The reference's parameters, loss, gradients and three AdamW steps'
    losses for ``arch``, computed once. The steps are ``make_train_step``'s
    with one micro-batch spelled out (``value_and_grad`` of ``loss_fn``,
    then ``adamw_update``), so that one compiled gradient serves the loss
    and gradient test and the three steps."""
    if arch not in _REF:
        jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        params = _stress(jax.tree.map(np.asarray, jp), np.random.RandomState(7))
        toks, img = _inputs(jcfg)
        value_and_grad = jax.jit(jax.value_and_grad(
            lambda p: jts.loss_fn(jcfg, p, toks, toks, img)[0]))
        update = jax.jit(lambda p, g, s: jopt.adamw_update(jopt.AdamWConfig(**STEPS_CFG), p, g, s))
        loss, grads = value_and_grad(params)
        p, state, losses = params, jopt.adamw_init(params), []
        for _ in range(3):
            step_loss, g = value_and_grad(p)
            p, state, _ = update(p, g, state)
            losses.append(float(step_loss))
        _REF[arch] = dict(params=params, toks=toks, img=img, loss=float(loss),
                          grads=jax.tree_util.tree_flatten_with_path(grads)[0], losses=losses)
    return _REF[arch]


def _port(arch, **kw):
    ref = _reference(arch)
    cfg = configs.reduced_config(configs.get_config(arch)).replace(**kw)
    img = _t(ref["img"]) if ref["img"] is not None else None
    return cfg, convert.params_from_numpy(ref["params"], device="cpu"), _t(ref["toks"]), img


def _grads(cfg, params, toks, img):
    live = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, parts = ts.loss_fn(cfg, live, toks, toks, img)
    grads = torch.autograd.grad(loss, list(opt.leaves(live)))
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_follow_the_reference(arch):
    ref = _reference(arch)
    loss, parts, grads = _grads(*_port(arch))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=0, atol=1e-5)
    assert float(parts["ce"]) > 0 and np.isfinite(float(parts["aux"]))
    assert len(grads) == len(ref["grads"])
    for g, (path, w) in zip(grads, ref["grads"]):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        err = float(np.abs(_n(g) - w).max())
        assert err <= 1e-4 * max(scale, 1e-30), (jax.tree_util.keystr(path), err, scale)
    moving = [jax.tree_util.keystr(p) for p, w in ref["grads"] if np.abs(np.asarray(w)).max() > 0]
    if arch == "llama-3.2-vision-90b":
        assert any("cross_layers" in p and "wq" in p for p in moving)
    if arch in ("mamba2-130m", "zamba2-1.2b"):
        assert any("a_log" in p for p in moving)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_track_the_reference(arch):
    ref = _reference(arch)
    cfg, params, toks, img = _port(arch)
    state = opt.adamw_init(params)
    step = ts.make_train_step(cfg, opt.AdamWConfig(**STEPS_CFG))
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, toks, toks, img)
        losses.append(float(m["loss"]))
        assert m["grad_norm"].dtype == m["lr"].dtype == torch.float32
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=1e-4)
    assert losses[-1] < losses[0], losses
    assert int(state["step"]) == 3


@pytest.mark.parametrize("arch", ["granite-8b", "llama-3.2-vision-90b"])
def test_grad_accum_matches_the_full_batch(arch):
    """As ``tests/test_layers.py`` holds the reference: the same step with
    ``grad_accum`` micro-batches (4 for granite on [4, 32] tokens; 2 for the
    vlm, whose image embeddings split with the tokens)."""
    cfg, params, toks, img = _port(arch)
    accum, toks = (4, _t(np.random.RandomState(1).randint(0, cfg.vocab, (4, 32)))) \
        if arch == "granite-8b" else (2, toks)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0)
    clone = lambda: opt.tree_map(torch.clone, params)
    p1, _, m1 = ts.make_train_step(cfg, ocfg)(clone(), opt.adamw_init(params), toks, toks, img)
    pa, _, ma = ts.make_train_step(cfg.replace(grad_accum=accum), ocfg)(
        clone(), opt.adamw_init(params), toks, toks, img)
    np.testing.assert_allclose(float(m1["loss"]), float(ma["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(ma["grad_norm"]), rtol=1e-4)
    for a, b in list(zip(opt.leaves(p1), opt.leaves(pa)))[:8]:
        np.testing.assert_allclose(_n(a), _n(b), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="micro-batches"):
        ts.make_train_step(cfg.replace(grad_accum=3), ocfg)(clone(), opt.adamw_init(params),
                                                            toks, toks, img)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_bit_equal_gradients(arch):
    cfg, params, toks, img = _port(arch)
    loss, _, plain = _grads(cfg, params, toks, img)
    r_loss, _, remat = _grads(cfg.replace(remat=True), params, toks, img)
    assert torch.equal(loss, r_loss)
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))
    with torch.no_grad():  # inference does not checkpoint, and its bits stay
        a = tf.forward(cfg.replace(remat=True), params, toks, img)[0]
        assert torch.equal(a, tf.forward(cfg, params, toks, img)[0])


def test_moe_gradient_with_dropped_tokens_follows_the_reference():
    """Capacity factor 0.5: at least half of the (token, expert) pairs are
    dropped, all written to the one slot the dispatch slices away; the
    gradients of the output and the aux loss within 1e-4 of each leaf's
    max |g| (the reduced configs are dropless)."""
    jcfg = jconfigs.reduced_config(jconfigs.get_config("deepseek-moe-16b")).replace(
        capacity_factor=0.5)
    cfg = configs.reduced_config(configs.get_config("deepseek-moe-16b")).replace(
        capacity_factor=0.5)
    jp = jax.tree.map(np.asarray, jmoe.init_moe_params(jcfg, jax.random.PRNGKey(5)))
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, jcfg.d_model).astype(np.float32)
    co = rng.randn(2, 16, jcfg.d_model).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_ffn(jcfg, p, x)
        return jnp.sum(out * co) + aux

    want = jax.tree.leaves(jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x))
    live = opt.tree_map(lambda a: _t(a).requires_grad_(), jp)
    xs = _t(x).requires_grad_()
    out, aux = moe.moe_ffn(cfg, live, xs)
    got = torch.autograd.grad((out * _t(co)).sum() + aux, [*opt.leaves(live), xs])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(_n(g) - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1e-30)


def test_ssd_gradient_is_finite_and_sequential_past_the_exp_overflow():
    """A decay of about 1.9 a token (``a_log`` 1) over 64-token chunks
    overflows ``exp`` above the diagonal (exponents up to about 120): the
    chunked SSD's gradient must stay finite and equal the sequential
    recurrence's (``mamba_decode`` token by token), within 1e-4 of each
    leaf's max |g|."""
    cfg = configs.reduced_config(configs.get_config("mamba2-130m")).replace(ssm_chunk=64)
    p = mamba2.init_mamba_params(cfg, rnd.key(3), device="cpu")
    p["a_log"] = torch.full_like(p["a_log"], 1.0)
    rng = np.random.RandomState(3)
    x = _t(rng.randn(1, 2 * cfg.ssm_chunk, cfg.d_model).astype(np.float32))
    co = _t(rng.randn(1, 2 * cfg.ssm_chunk, cfg.d_model).astype(np.float32))
    dims = mamba2.mamba_dims(cfg)

    def grads(sequential):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xs = x.detach().requires_grad_()
        if sequential:
            conv = torch.zeros(1, cfg.ssm_conv - 1, dims["conv_dim"])
            ssm = torch.zeros(1, dims["nheads"], cfg.ssm_headdim, dims["n"])
            outs = []
            for t in range(xs.shape[1]):
                o, (conv, ssm) = mamba2.mamba_decode(cfg, leaves, xs[:, t], conv, ssm)
                outs.append(o)
            out = torch.stack(outs, dim=1)
        else:
            out = mamba2.mamba_forward(cfg, leaves, xs)
        return torch.autograd.grad((out * co).sum(), [xs, *leaves.values()])

    for a, b in zip(grads(False), grads(True)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)


def test_param_shardings_and_the_train_state():
    cfg = configs.reduced_config(configs.get_config("granite-8b"))
    with pytest.raises(ValueError, match="use_mesh"):  # outside a mesh
        ts.make_train_step(cfg, param_shardings={"embed": None})
    with dryrun.fake_mesh(2), pytest.raises(ValueError, match="is not"):  # another tree
        ts.make_train_step(cfg, param_shardings={"embed": None})
    params, state = ts.init_train_state(cfg, rnd.key(0), device="cpu")
    jp = jtf.init_params(jconfigs.reduced_config(jconfigs.get_config("granite-8b")),
                         jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in opt.leaves(params)] == [a.shape for a in jax.tree.leaves(jp)]
    assert [tuple(t.shape) for t in opt.leaves(state["m"])] == [a.shape for a in jax.tree.leaves(jp)]
    assert not any(t.requires_grad for t in opt.leaves(params))
