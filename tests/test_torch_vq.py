"""``repro_torch.vq`` held against ``repro.vq`` on the CPU, and the
reference's own ``tests/test_vq.py`` cases run on the port.

The reference's reduced granite-8b parameters come into the port through
``convert.params_from_numpy``. The port fits its codebooks through
``repro_torch.BWKM``; the reference's fits are never run here (a fit costs
it seconds), so comparisons hand the port's centroids to the reference.
Tolerances: rows and logits within 1e-5 (1e-4 across packages over a
decode), codes bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import vq as jvq
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro_torch import configs, convert, vq
from repro_torch import random as rnd
from repro_torch.data.chunks import ChunkSource
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as train_ckpt

B, P, GEN = 2, 16, 8
K_FIT = 8


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfigs.reduced_config(jconfigs.get_config("granite-8b"))
    cfg = configs.reduced_config(configs.get_config("granite-8b"))
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, P), 0, cfg.vocab))
    return cfg, params, prompts, jcfg, jparams


@pytest.fixture(scope="module")
def codebook(setup):
    cfg, params, prompts, *_ = setup
    return vq.fit_kv_codebook(cfg, params, prompts, k=K_FIT, chunk_size=64, prompt_batch=2,
                              max_iters=3, seed=2)


@pytest.fixture(scope="module")
def rand(setup):
    cfg, params, prompts, *_ = setup
    return vq.random_kv_codebook(cfg, params, prompts, k=K_FIT, seed=3, chunk_size=64,
                                 prompt_batch=2)


def _ref_codebook(cb):
    return jvq.KVCodebook(cb.k_centroids, cb.v_centroids, cb.meta)


def _rows(setup, layer=0, kind="k"):
    cfg, params, prompts, *_ = setup
    src = vq.CacheDumpSource(cfg, params, prompts, layer=layer, kind=kind, chunk_size=64)
    return np.concatenate(list(src.chunks()))


# ----------------------------------------------------------- CacheDumpSource
def test_source_satisfies_chunk_source_protocol(setup):
    cfg, params, prompts, *_ = setup
    src = vq.CacheDumpSource(cfg, params, prompts, layer=0, kind="k", chunk_size=24)
    assert isinstance(src, ChunkSource)
    sc = src.n_points // (B * cfg.n_kv_heads)
    assert src.n_points == B * sc * cfg.n_kv_heads
    assert src.dim == cfg.hd


def test_source_chunks_are_exact_and_repeatable(setup):
    cfg, params, prompts, *_ = setup
    src = vq.CacheDumpSource(cfg, params, prompts, layer=1, kind="v", chunk_size=24)
    first, second = list(src.chunks()), list(src.chunks())
    assert len(first) == src.n_chunks
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    for c in first[:-1]:
        assert c.shape == (24, cfg.hd)
    assert sum(c.shape[0] for c in first) == src.n_points


def test_source_chunk_at_matches_iteration(setup):
    cfg, params, prompts, *_ = setup
    src = vq.CacheDumpSource(cfg, params, prompts, layer=0, kind="v", chunk_size=24)
    seq = list(src.chunks())
    for i in (0, len(seq) // 2, len(seq) - 1):
        np.testing.assert_array_equal(src.chunk_at(i), seq[i])


@pytest.mark.parametrize("layer,kind,prompt_batch", [(0, "k", 2), (1, "v", 1)])
def test_source_rows_are_the_references(setup, layer, kind, prompt_batch):
    cfg, params, prompts, jcfg, jparams = setup
    kw = dict(layer=layer, kind=kind, chunk_size=24, prompt_batch=prompt_batch)
    src = vq.CacheDumpSource(cfg, params, prompts, **kw)
    jsrc = jvq.CacheDumpSource(jcfg, jparams, prompts, **kw)
    assert (src.n_points, src.n_chunks, src.dim) == (jsrc.n_points, jsrc.n_chunks, jsrc.dim)
    for a, b in zip(src.chunks(), jsrc.chunks()):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for i in (0, src.n_chunks - 1):
        np.testing.assert_allclose(src.chunk_at(i), jsrc.chunk_at(i), atol=1e-5)


def test_source_rejects_state_space_families():
    with pytest.raises(ValueError):
        vq.n_kv_layers(configs.reduced_config(configs.get_config("mamba2-130m")))


# ------------------------------------------------------------------- fitting
def test_codebook_fits_through_streaming_engine(codebook, setup):
    cfg = setup[0]
    audit = codebook.meta["layers"]
    assert len(audit) == 2 * cfg.n_layers  # one per (layer, K/V)
    assert all(m["engine"] == "streaming" for m in audit)
    assert all(m["n_points"] == B * P * cfg.n_kv_heads for m in audit)
    assert codebook.meta["distances_total"] > 0
    assert codebook.k_centroids.shape == (cfg.n_layers, K_FIT, cfg.hd)
    assert np.isfinite(codebook.k_centroids).all() and np.isfinite(codebook.v_centroids).all()


def test_random_codebook_draws_the_references_rows(rand, setup):
    cfg, params, prompts, jcfg, jparams = setup
    want = jvq.random_kv_codebook(jcfg, jparams, prompts, k=K_FIT, seed=3, chunk_size=64,
                                  prompt_batch=2)
    np.testing.assert_allclose(rand.k_centroids, want.k_centroids, atol=1e-5)
    np.testing.assert_allclose(rand.v_centroids, want.v_centroids, atol=1e-5)


def test_bwkm_beats_random_codebook_mse(codebook, rand, setup):
    rows = _rows(setup)

    def mse(cb):
        c = cb.k_centroids[0]
        recon = vq.dequantize_rows(vq.quantize_rows(rows, c, device="cpu"), c).numpy()
        return float(np.mean(np.sum((rows - recon) ** 2, axis=1)))

    assert mse(codebook) < mse(rand)


# --------------------------------------------------- quantize == assignment
def test_codes_are_the_references(codebook):
    rng = np.random.RandomState(5)
    rows = rng.randn(5000, codebook.dim).astype(np.float32)  # two chunks, the last ragged
    got = vq.quantize_rows(rows, codebook.k_centroids[1], device="cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jvq.quantize_rows(rows, codebook.k_centroids[1]))


def test_round_trip_mse_equals_assignment_d1(codebook, setup):
    rows = _rows(setup)
    c = codebook.k_centroids[0]
    recon = vq.dequantize_rows(vq.quantize_rows(rows, c, device="cpu"), c).numpy()
    mse_roundtrip = float(np.mean(np.sum((rows - recon) ** 2, axis=1)))
    _, d1, _ = ops.assign_top2(torch.from_numpy(rows), torch.from_numpy(c))
    assert np.allclose(mse_roundtrip, float(d1.mean()), rtol=1e-5)
    _, jd1, _ = jops.assign_top2(jnp.asarray(rows), jnp.asarray(c))
    assert np.allclose(mse_roundtrip, float(jnp.mean(jd1)), rtol=1e-5)


def test_quantize_dequantize_cache_round_trip(codebook, setup):
    cfg, params, prompts, *_ = setup
    _, cache = tf.prefill(cfg, params, torch.from_numpy(prompts))
    qcache = vq.quantize_cache(codebook, cache)
    assert qcache["k_codes"].dtype == torch.uint8
    assert qcache["k_codes"].shape == cache["k"].shape[:-1]
    assert torch.equal(qcache["slot_pos"], cache["slot_pos"])
    want = jvq.quantize_cache(_ref_codebook(codebook), jax.tree.map(jnp.asarray, {
        k: v.numpy() for k, v in cache.items()}))
    np.testing.assert_array_equal(qcache["v_codes"].numpy(), np.asarray(want["v_codes"]))
    recon = vq.dequantize_cache(codebook, qcache)
    assert recon["k"].shape == cache["k"].shape
    np.testing.assert_array_equal(recon["k"].numpy(), np.asarray(
        jvq.dequantize_cache(_ref_codebook(codebook), want)["k"]))
    # one uint8 code replaces an hd-dim f32 vector
    assert vq.kv_cache_nbytes(qcache) * 4 * cfg.hd == vq.kv_cache_nbytes(cache)


# -------------------------------------------------------------- code dtypes
def test_code_dtype_bounds_are_the_references():
    for k in (1, 2, 256, 257, 65536):
        want = jvq.code_dtype_for(k)
        assert torch.empty(0, dtype=vq.code_dtype_for(k)).numpy().dtype == want
    for k in (0, 65537):
        with pytest.raises(ValueError):
            vq.code_dtype_for(k)


def test_uint16_codebook_quantizes(setup):
    cfg = setup[0]
    rng = np.random.RandomState(0)
    cb = vq.KVCodebook(rng.randn(cfg.n_layers, 300, cfg.hd), rng.randn(cfg.n_layers, 300, cfg.hd))
    assert cb.code_dtype == torch.uint16
    rows = rng.randn(50, cfg.hd).astype(np.float32)
    codes = vq.quantize_rows(rows, cb.k_centroids[0], device="cpu")
    assert codes.dtype == torch.uint16 and int(codes.long().max()) < 300
    want = jvq.quantize_rows(rows, cb.k_centroids[0])
    assert want.dtype == np.uint16
    np.testing.assert_array_equal(codes.numpy(), want)


# ----------------------------------------------------------------- save/load
def test_save_load_bit_identity_across_the_packages(codebook, tmp_path):
    vq.save_codebook(tmp_path / "cb", codebook)
    for load in (vq.load_codebook, jvq.load_codebook):
        loaded = load(tmp_path / "cb")
        np.testing.assert_array_equal(loaded.k_centroids, codebook.k_centroids)
        np.testing.assert_array_equal(loaded.v_centroids, codebook.v_centroids)
        assert loaded.meta["k"] == K_FIT
        assert [m["engine"] for m in loaded.meta["layers"]] == ["streaming"] * len(
            codebook.meta["layers"])
    jvq.save_codebook(tmp_path / "ref", _ref_codebook(codebook), step=3)
    back = vq.load_codebook(tmp_path / "ref")
    np.testing.assert_array_equal(back.v_centroids, codebook.v_centroids)
    assert back.meta == codebook.meta


def test_load_rejects_foreign_checkpoints(tmp_path):
    train_ckpt.save(tmp_path / "other", 0, {"s": {"x": np.zeros(3, np.float32)}},
                    {"artifact": "something_else"})
    jckpt.save(tmp_path / "ref", 0, {"s": {"x": np.zeros(3, np.float32)}}, {"schema": 2})
    for d in ("other", "ref"):
        with pytest.raises(ValueError):
            vq.load_codebook(tmp_path / d, step=0)
    with pytest.raises(FileNotFoundError):
        vq.load_codebook(tmp_path / "missing")


# ------------------------------------------------------------- decode parity
def _exact(cfg, cache):
    L = cfg.n_layers
    return vq.KVCodebook(cache["k"].numpy().reshape(L, -1, cfg.hd),
                         cache["v"].numpy().reshape(L, -1, cfg.hd))


def test_decode_parity_exact_codebook(setup):
    """Codebook = the cache's own rows → lossless quantization → the
    quantized step reproduces the raw step's logits (within 1e-5)."""
    cfg, params, prompts, *_ = setup
    _, cache = tf.prefill(cfg, params, torch.from_numpy(prompts), max_seq_len=P + GEN)
    exact = _exact(cfg, cache)
    qcache = vq.quantize_cache(exact, cache)
    before = {k: v.clone() for k, v in qcache.items()}
    tok = torch.zeros(B, dtype=torch.int32)
    raw, _ = tf.decode(cfg, params, cache, tok, P)
    quant, qcache2 = vq.decode_quantized(cfg, params, torch.from_numpy(exact.k_centroids),
                                         torch.from_numpy(exact.v_centroids), qcache, tok, P)
    np.testing.assert_allclose(raw.numpy(), quant.numpy(), atol=1e-5)
    assert qcache2["k_codes"].dtype == qcache["k_codes"].dtype
    assert all(torch.equal(before[k], qcache[k]) for k in before)  # functional


def test_decode_quantized_follows_the_reference(codebook, setup):
    cfg, params, prompts, jcfg, jparams = setup
    _, cache = tf.prefill(cfg, params, torch.from_numpy(prompts), max_seq_len=P + GEN)
    qcache = vq.quantize_cache(codebook, cache)
    jq = {k: jnp.asarray(v.numpy()) for k, v in qcache.items()}
    kcb, vcb = torch.from_numpy(codebook.k_centroids), torch.from_numpy(codebook.v_centroids)
    tok = np.zeros(B, np.int32)
    for i in range(2):
        got, qcache = vq.decode_quantized(cfg, params, kcb, vcb, qcache, torch.from_numpy(tok), P + i)
        want, jq = jvq.decode_quantized(jcfg, jparams, jnp.asarray(codebook.k_centroids),
                                        jnp.asarray(codebook.v_centroids), jq, jnp.asarray(tok),
                                        jnp.asarray(P + i, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_array_equal(qcache["k_codes"].numpy(), np.asarray(jq["k_codes"]))
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)


def test_decode_drift_bounded_and_better_than_random(codebook, rand, setup):
    """Fitted-codebook logit drift against fp is pinned (< 2.0 on the
    reduced config) and smaller than a random codebook's at equal k, over a
    short greedy rollout."""
    cfg, params, prompts, *_ = setup

    def rollout_drift(cb):
        _, cache = tf.prefill(cfg, params, torch.from_numpy(prompts), max_seq_len=P + GEN)
        qcache = vq.quantize_cache(cb, cache)
        kcb, vcb = torch.from_numpy(cb.k_centroids), torch.from_numpy(cb.v_centroids)
        tok = torch.zeros(B, dtype=torch.int32)
        total = 0.0
        for i in range(4):
            raw, cache = tf.decode(cfg, params, cache, tok, P + i)
            quant, qcache = vq.decode_quantized(cfg, params, kcb, vcb, qcache, tok, P + i)
            total += float((raw - quant).abs().max())
            tok = torch.argmax(raw, dim=-1).to(torch.int32)
        return total

    drift_bwkm, drift_rand = rollout_drift(codebook), rollout_drift(rand)
    assert np.isfinite(drift_bwkm)
    assert drift_bwkm < 2.0, f"quantized logit drift regressed: {drift_bwkm}"
    assert drift_bwkm < drift_rand


def test_generate_quantized_runs(codebook, setup):
    cfg, params, prompts, *_ = setup
    toks = vq.generate_quantized(cfg, params, codebook, prompts, GEN)
    assert toks.shape == (B, GEN) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab


def test_teacher_forced_nll_follows_the_reference_and_orders_codebooks(codebook, rand, setup):
    """fp NLL equals the reference's (1e-5); BWKM beats random at equal k."""
    cfg, params, prompts, jcfg, jparams = setup
    from repro_torch.launch import serve

    gen = serve.generate(cfg, params, torch.from_numpy(prompts), GEN)
    eval_toks = np.concatenate([prompts, gen.numpy()], axis=1)
    nll_f = vq.teacher_forced_nll(cfg, params, eval_toks, prompt_len=P)
    want = jvq.teacher_forced_nll(jcfg, jparams, eval_toks, prompt_len=P)
    np.testing.assert_allclose(nll_f, want, rtol=1e-5)
    nll_b = vq.teacher_forced_nll(cfg, params, eval_toks, prompt_len=P, codebook=codebook)
    nll_r = vq.teacher_forced_nll(cfg, params, eval_toks, prompt_len=P, codebook=rand)
    assert np.isfinite([nll_f, nll_b, nll_r]).all()
    assert nll_b < nll_r, f"bwkm nll {nll_b} must beat random {nll_r}"


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b", "llama-3.2-vision-90b"])
def test_quantized_decode_refuses_other_families(arch):
    cfg = configs.reduced_config(configs.get_config(arch))
    with pytest.raises(NotImplementedError):
        vq.decode_quantized(cfg, {}, None, None, {}, torch.zeros(1), 0)


# ------------------------------------------------------------ router seeding
def test_router_from_centroids_unit_columns_like_the_reference():
    c = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    w = vq.router_from_centroids(c, device="cpu")
    assert w.shape == (8, 4)
    np.testing.assert_allclose(torch.linalg.vector_norm(w, dim=0).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jvq.router_from_centroids(c)), atol=1e-6)


def test_router_dead_centroid_yields_zero_not_nan():
    c = np.zeros((3, 6), np.float32)
    c[0] = 1.0
    w = vq.router_from_centroids(torch.from_numpy(c)).numpy()
    assert np.isfinite(w).all()
    np.testing.assert_array_equal(w[:, 1:], 0.0)
    np.testing.assert_allclose(np.linalg.norm(w[:, 0]), 1.0, atol=1e-6)
    np.testing.assert_array_equal(w, np.asarray(jvq.router_from_centroids(c)))


def test_seed_router_and_session_refresh():
    rng = np.random.RandomState(1)
    h = rng.randn(512, 16).astype(np.float32)
    w1, session = vq.seed_router(h, 4, seed=0, max_iters=3, device="cpu")
    assert w1.shape == (16, 4) and bool(torch.isfinite(w1).all())
    w2, session2 = vq.seed_router(rng.randn(256, 16).astype(np.float32), 4, session=session)
    assert session2 is session and bool(torch.isfinite(w2).all())
    with pytest.raises(ValueError):
        vq.seed_router(h, 7, session=session)


def test_install_router_moe_forward():
    cfg = configs.reduced_config(configs.get_config("deepseek-moe-16b"))
    params = tf.init_params(cfg, rnd.key(0), device="cpu")
    rng = np.random.RandomState(2)
    w = vq.router_from_centroids(rng.randn(cfg.n_experts, cfg.d_model), device="cpu")
    newp = vq.install_router(params, w)
    assert newp is not params
    assert newp["layers"]["moe"]["router"].shape == params["layers"]["moe"]["router"].shape
    assert not torch.equal(newp["layers"]["moe"]["router"], params["layers"]["moe"]["router"])
    logits, _, _ = tf.forward(cfg, newp, torch.from_numpy(rng.randint(0, cfg.vocab, (2, 8))))
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError):
        vq.install_router({"layers": {}}, w)


def test_replace_router_validation():
    p = {"router": torch.zeros(4, 6, 3)}
    assert moe.replace_router(p, np.ones((6, 3), np.float32))["router"].shape == (4, 6, 3)
    with pytest.raises(ValueError):
        moe.replace_router(p, np.ones((5, 3), np.float32))
    with pytest.raises(ValueError):
        moe.replace_router(p, np.full((6, 3), np.nan, np.float32))
