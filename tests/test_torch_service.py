"""The port's online clustering service held against the JAX reference on
the CPU: ``decay_stats`` and ``split_blocks_virtual``, the checkpoint format
(integrity, retention, and checkpoints carried across between the two
packages), the session on the reference's drifting stream, resume ≡
uninterrupted bit for bit, the batched predictor, and ``BWKM.partial_fit``.

Inputs come from numpy seeds. ``JaxKey`` (``test_torch_bwkm``) stands in
for the session's key where the port must draw the reference's numbers.
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bwkm import JaxKey

import repro
import repro_torch
from repro.core import partition as jpart
from repro.core.bwkm import BWKMConfig as JBWKMConfig
from repro.data import chunks as jck
from repro.service import BWKMSession as JSession
from repro.service import ServiceConfig as JServiceConfig
from repro.service import BatchedPredictor as JPredictor
from repro.service import load_session as jload_session
from repro.service import run_service as jrun_service
from repro.service import save_session as jsave_session
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.core import partition as part_mod
from repro_torch.core.bwkm import BWKMConfig
from repro_torch.data import chunks as ck
from repro_torch.service import (
    BatchedPredictor,
    BWKMSession,
    ServiceConfig,
    load_session,
    resume_service,
    run_service,
    save_session,
    session_state_template,
)
from repro_torch.service import session as session_mod
from repro_torch.testing.faults import CrashingSource, InjectedCrash
from repro_torch.train import checkpoint as ckpt

CHUNK_ROWS = 256
N_CHUNKS = 8
DIM = 4
K = 3

# the reference's crash suite (tests/test_service_recovery.py)
CONFIG = ServiceConfig(
    base=BWKMConfig(k=K, max_iters=4, lloyd_max_iters=20),
    decay=0.9,
    refit_boundary_frac=0.02,
    seed=5,
)
JCONFIG = JServiceConfig(
    base=JBWKMConfig(k=K, max_iters=4, lloyd_max_iters=20),
    decay=0.9,
    refit_boundary_frac=0.02,
    seed=5,
)


@pytest.fixture(scope="module")
def stream() -> np.ndarray:
    """The reference's drifting stream: the cluster centres jump halfway
    through, so the boundary trigger refits."""
    rng = np.random.RandomState(11)
    centers = rng.randn(K, DIM).astype(np.float32) * 4.0
    chunks = []
    for i in range(N_CHUNKS):
        c = centers + (2.5 if i >= N_CHUNKS // 2 else 0.0)
        lab = rng.randint(0, K, CHUNK_ROWS)
        chunks.append((c[lab] + 0.3 * rng.randn(CHUNK_ROWS, DIM)).astype(np.float32))
    return np.concatenate(chunks)


@pytest.fixture(scope="module")
def reference(stream):
    """The reference session over the whole stream, and its metrics."""
    session = JSession(JCONFIG)
    metrics = jrun_service(session, jck.ArrayChunkSource(stream, CHUNK_ROWS))
    return session, metrics


@pytest.fixture(scope="module")
def uninterrupted(stream):
    """The port's session over the whole stream with its own key."""
    session = BWKMSession(CONFIG, device="cpu")
    metrics = run_service(session, ck.ArrayChunkSource(stream, CHUNK_ROWS))
    assert len(metrics) == N_CHUNKS
    assert any(m["refit"] for m in metrics[1:]), "the drift never triggered a refit"
    return session, metrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread: with several test workers on the
    cores, each worker's intra-op pool spinning on every core slowed this
    file several times over (the tolerances hold at any thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _state_arrays(state) -> dict[str, np.ndarray]:
    """Every array of a session state of either package, under the
    checkpoint's key names; a key as its two stored words."""
    part = state.partition
    key = state.key
    if isinstance(key, rnd.TorchKey):
        key = rnd.key_to_words(key)
    out = {f"partition§{f}": np.asarray(getattr(part, f)) for f in part._fields}
    out.update(
        centroids=np.asarray(state.centroids), d1=np.asarray(state.d1),
        d2=np.asarray(state.d2), key=np.asarray(key), batches=np.asarray(state.batches),
        points=np.asarray(state.points),
    )
    return out


def _assert_bit_identical(a, b) -> None:
    la, lb = _state_arrays(a), _state_arrays(b)
    assert la.keys() == lb.keys()
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        np.testing.assert_array_equal(la[name], lb[name], err_msg=name, strict=True)


# ------------------------------------------------- decay and virtual splits
def _partition(seed=0, capacity=16, n_blocks=10, d=3):
    """A partition with tight boxes, counts of 0, 1 and more, and each
    representative drawn inside its box, so it falls on either side of the
    split plane."""
    rng = np.random.RandomState(seed)
    lo = rng.randn(capacity, d).astype(np.float32) * 3
    hi = lo + rng.rand(capacity, d).astype(np.float32) * 2
    count = rng.randint(2, 9, capacity).astype(np.float32)
    count[[2, 5]] = [0.0, 1.0]  # an empty and a singleton block: neither splits
    rep = lo + rng.rand(capacity, d).astype(np.float32) * (hi - lo)
    active = np.arange(capacity) < n_blocks
    return {
        "lo": np.where(active[:, None], lo, 3.0e38).astype(np.float32),
        "hi": np.where(active[:, None], hi, -3.0e38).astype(np.float32),
        "psum": np.where(active[:, None], rep * count[:, None], 0).astype(np.float32),
        "count": np.where(active, count, 0).astype(np.float32),
        "active": active,
        "block_id": np.zeros(0, np.int32),
        "n_blocks": np.int32(n_blocks),
    }


def _jax_partition(p):
    return jpart.Partition(**{k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("gamma", [0.9, 0.5, 1.0])
def test_decay_stats_is_bit_equal_to_the_reference(gamma):
    p = _partition(1)
    got = convert.partition_to_numpy(
        part_mod.decay_stats(convert.partition_from_numpy(p, device="cpu"), gamma)
    )
    want = jpart.decay_stats(_jax_partition(p), gamma)
    for f in ("psum", "count", "lo", "hi"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_blocks_virtual_is_bit_equal_to_the_reference(seed):
    """Every active block is chosen, but the free rows take only some: the
    rest do not fit and must write nothing."""
    p = _partition(seed)
    chosen = np.asarray(p["active"]).copy()
    part = convert.partition_from_numpy(p, device="cpu")
    jp = _jax_partition(p)
    plan = part_mod.split_plan(part, torch.from_numpy(chosen))
    jplan = jpart.split_plan(jp, jnp.asarray(chosen))
    for f in plan._fields:
        np.testing.assert_array_equal(getattr(plan, f).numpy(), np.asarray(getattr(jplan, f)))
    fits = plan.fits.numpy()
    assert 0 < fits.sum() < chosen.sum()  # some blocks do not fit
    rep_ax = (p["psum"] / np.maximum(p["count"], 1)[:, None])[
        np.arange(16), plan.axis.numpy()
    ]
    right = rep_ax > plan.mid.numpy()
    assert (fits & right).any() and (fits & ~right).any()  # both sides inherit
    got = convert.partition_to_numpy(part_mod.split_blocks_virtual(part, plan))
    want = jpart.split_blocks_virtual(jp, jplan)
    for f in convert.PARTITION_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------- checkpoint format
def _tree(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "model": {
            "w": torch.from_numpy(rng.randn(8, 4).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(4).astype(np.float32)),
        }
    }


def _template() -> dict:
    return {"model": {"w": torch.zeros(8, 4), "b": torch.zeros(4)}}


def _roundtrip_ok(directory, step, state) -> None:
    restored, _ = ckpt.restore(directory, step, _template(), device="cpu")
    assert torch.equal(restored["model"]["w"], state["model"]["w"])
    assert torch.equal(restored["model"]["b"], state["model"]["b"])


def test_resave_existing_step_replaces_content(tmp_path):
    ckpt.save(tmp_path, 3, _tree(1))
    ckpt.save(tmp_path, 3, _tree(2))  # re-saving the same step must not crash
    _roundtrip_ok(tmp_path, 3, _tree(2))
    assert not list(tmp_path.glob(".tmp_step_*"))
    assert not list(tmp_path.glob(".old_step_*"))


def test_save_clears_stale_tmp_debris(tmp_path):
    stale = tmp_path / ".tmp_step_00000005"
    stale.mkdir(parents=True)
    (stale / "junk").write_text("from a save that died mid-write")
    ckpt.save(tmp_path, 5, _tree())
    _roundtrip_ok(tmp_path, 5, _tree())
    assert not stale.exists()


def test_manifest_carries_checksums_and_verify_passes(tmp_path):
    final = ckpt.save(tmp_path, 1, _tree())
    manifest = json.loads((final / "manifest.json").read_text())
    assert set(manifest["checksums"]) == set(manifest["keys"]) == {"model§b", "model§w"}
    assert ckpt.verify(final)


@pytest.mark.parametrize("damage", ["bit_flip", "truncation"])
def test_restore_detects_damage(damage, tmp_path):
    final = ckpt.save(tmp_path, 1, _tree())
    if damage == "bit_flip":
        # one array changed, the container still valid, the manifest kept
        data = dict(np.load(final / "state.npz"))
        data["model§w"] = data["model§w"].copy()
        data["model§w"].reshape(-1).view(np.uint8)[5] ^= 0x10
        np.savez(final / "state.npz", **data)
    else:
        raw = (final / "state.npz").read_bytes()
        (final / "state.npz").write_bytes(raw[: len(raw) // 2])
    assert not ckpt.verify(final)
    with pytest.raises(ckpt.CheckpointCorruptionError) as ei:
        ckpt.restore(tmp_path, 1, _template(), device="cpu")
    if damage == "bit_flip":
        assert "CRC-32" in str(ei.value) and "'model§w'" in str(ei.value)


def test_pre_checksum_checkpoints_still_restore(tmp_path):
    final = ckpt.save(tmp_path, 1, _tree())
    manifest = json.loads((final / "manifest.json").read_text())
    del manifest["checksums"]
    (final / "manifest.json").write_text(json.dumps(manifest))
    assert ckpt.verify(final)
    _roundtrip_ok(tmp_path, 1, _tree())


@pytest.mark.parametrize("keep", [2, None])
def test_keep_last_n_retention(keep, tmp_path):
    for step in range(1, 6):
        ckpt.save(tmp_path, step, _tree(step), keep_last_n=keep)
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == (["step_00000004", "step_00000005"] if keep else
                    [f"step_{s:08d}" for s in range(1, 6)])
    assert ckpt.latest_step(tmp_path) == 5


def test_gc_never_deletes_newest_verified(tmp_path):
    for step in (1, 2, 3):
        ckpt.save(tmp_path, step, _tree(step))
    (tmp_path / "step_00000003" / "state.npz").write_bytes(b"garbage")
    ckpt._gc(tmp_path, 1)  # the window holds step 3 alone, and it is corrupt
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_00000002", "step_00000003"]
    _roundtrip_ok(tmp_path, 2, _tree(2))


def test_train_checkpoint_restores_the_references_files(tmp_path):
    """A tree saved by ``repro.train.checkpoint`` restores here bit-equal,
    and the reverse, with the same keys and checksums."""
    from repro.train import checkpoint as jckpt

    tree = _tree(4)
    jtree = {"model": {k: jnp.asarray(v.numpy()) for k, v in tree["model"].items()}}
    jckpt.save(tmp_path / "ref", 2, jtree)
    _roundtrip_ok(tmp_path / "ref", 2, tree)
    ckpt.save(tmp_path / "port", 2, tree)
    back, _ = jckpt.restore(tmp_path / "port", 2, jtree)
    for k in ("w", "b"):
        np.testing.assert_array_equal(np.asarray(back["model"][k]), tree["model"][k].numpy())
    m_ref, m_port = (
        json.loads((tmp_path / d / "step_00000002" / "manifest.json").read_text())
        for d in ("ref", "port")
    )
    assert m_ref == m_port


# -------------------------------------------------- session checkpoints
def _random_state(seed: int, capacity: int = 16, d: int = 3, k: int = 4):
    """A state with active rows with mass, a zero-weight active row (a
    virtual-split child), inactive rows with stale values and a key."""
    rng = np.random.RandomState(seed)
    n_active = rng.randint(2, capacity + 1)
    active = np.arange(capacity) < n_active
    count = np.where(active, rng.rand(capacity) * 10, 0.0).astype(np.float32)
    count[rng.randint(0, n_active)] = 0.0
    lo = rng.randn(capacity, d).astype(np.float32)
    t = torch.from_numpy
    part = part_mod.Partition(
        lo=t(lo), hi=t(lo + rng.rand(capacity, d).astype(np.float32)),
        psum=t(rng.randn(capacity, d).astype(np.float32)), count=t(count),
        active=t(active), block_id=torch.zeros(0, dtype=torch.int32),
        n_blocks=torch.tensor(n_active, dtype=torch.int32),
    )
    return session_mod.SessionState(
        partition=part, centroids=t(rng.randn(k, d).astype(np.float32)),
        d1=t(rng.rand(capacity).astype(np.float32)),
        d2=t((rng.rand(capacity) + 1).astype(np.float32)),
        key=rnd.key(seed).fold_in(17),
        batches=torch.tensor(rng.randint(0, 1000), dtype=torch.int32),
        points=torch.tensor(float(rng.randint(0, 10**6))),
    )


def _session_with(state) -> BWKMSession:
    session = BWKMSession(CONFIG, device="cpu")
    session.state = state
    return session


@pytest.mark.parametrize("which", ["random_1", "random_2", "empty_template"])
def test_session_state_round_trip_is_bit_identical(which, tmp_path):
    state = (session_state_template(8, 2, 3, device="cpu") if which == "empty_template"
             else _random_state(int(which[-1])))
    save_session(tmp_path, _session_with(state), cursor=7)
    loaded, cursor = load_session(tmp_path, device="cpu")
    assert cursor == 7 and loaded.config == CONFIG
    _assert_bit_identical(state, loaded.state)


def test_live_session_round_trip_keeps_working_bit_for_bit(stream, tmp_path):
    session = BWKMSession(CONFIG, device="cpu")
    run_service(session, ck.ArrayChunkSource(stream, CHUNK_ROWS), max_chunks=5)
    save_session(tmp_path, session, cursor=5)
    loaded, _ = load_session(tmp_path, device="cpu")
    _assert_bit_identical(session.state, loaded.state)
    nxt = stream[5 * CHUNK_ROWS : 6 * CHUNK_ROWS]
    assert session.partial_fit(nxt) == loaded.partial_fit(nxt)
    _assert_bit_identical(session.state, loaded.state)


def test_key_round_trip_continues_the_same_stream(tmp_path):
    state = _random_state(9)
    save_session(tmp_path, _session_with(state), cursor=1)
    loaded, _ = load_session(tmp_path, device="cpu")
    assert [k.seed for k in rnd.split(loaded.state.key, 3)] == [
        k.seed for k in rnd.split(state.key, 3)
    ]
    u = rnd.uniform(rnd.split(loaded.state.key)[1], (5,), device="cpu")
    assert torch.equal(u, rnd.uniform(rnd.split(state.key)[1], (5,), device="cpu"))
    assert rnd.key_from_words(rnd.key_to_words(rnd.key(2**63 + 12345))).seed == 2**63 + 12345


def test_load_session_edge_cases(tmp_path):
    assert load_session(tmp_path / "nothing_here", device="cpu") is None
    session = _session_with(_random_state(4))
    save_session(tmp_path / "ck", session, cursor=2)
    save_session(tmp_path / "ck", session, cursor=5)
    assert load_session(tmp_path / "ck", device="cpu")[1] == 5  # the latest wins
    assert load_session(tmp_path / "ck", step=2, device="cpu")[1] == 2
    mpath = tmp_path / "ck" / "step_00000005" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["extra"]["schema"] = 999
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="schema"):
        load_session(tmp_path / "ck", device="cpu")


def test_uninitialized_session_cannot_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="uninitialized"):
        save_session(tmp_path, BWKMSession(CONFIG, device="cpu"), cursor=0)


def test_corrupt_session_checkpoint_is_refused_by_name(uninterrupted, tmp_path):
    save_session(tmp_path, uninterrupted[0], cursor=8)
    path = tmp_path / "step_00000008" / "state.npz"
    data = dict(np.load(path))
    data["session§partition§psum"].reshape(-1).view(np.uint8)[3] ^= 0x01
    np.savez(path, **data)
    with pytest.raises(ckpt.CheckpointCorruptionError, match="'session§partition§psum'"):
        load_session(tmp_path, device="cpu")


def _small_stream(n_chunks=6, rows=128, d=3):
    return np.random.RandomState(11).randn(n_chunks * rows, d).astype(np.float32)


def test_service_keep_checkpoints_gc(tmp_path):
    cfg = ServiceConfig(base=BWKMConfig(k=3, max_iters=3, lloyd_max_iters=10), seed=7,
                        keep_checkpoints=2)
    session = BWKMSession(cfg, device="cpu")
    run_service(session, ck.ArrayChunkSource(_small_stream(), 128),
                checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert len(list(tmp_path.glob("step_*"))) == 2
    assert load_session(tmp_path, device="cpu")[1] == 6


def test_service_manifest_carries_health(tmp_path):
    x = _small_stream()
    x[200] = np.nan  # one poisoned row: the session quarantines it
    cfg = ServiceConfig(base=BWKMConfig(k=3, max_iters=3, lloyd_max_iters=10), seed=7)
    session = BWKMSession(cfg, device="cpu")
    run_service(session, ck.ArrayChunkSource(x, 128), checkpoint_dir=str(tmp_path))
    step = ckpt.latest_step(tmp_path)
    manifest = json.loads((tmp_path / f"step_{step:08d}" / "manifest.json").read_text())
    assert manifest["extra"]["health"]["quarantined_rows"] == 1
    assert manifest["extra"]["health"]["degraded"] is True
    assert load_session(tmp_path, device="cpu")[0].health.quarantined_rows == 1


# --------------------------------------------- across the two packages
def test_reference_checkpoint_restores_in_the_port_bit_equal(reference, tmp_path):
    jsession, _ = reference
    jsave_session(tmp_path / "ref", jsession, cursor=N_CHUNKS)
    session, cursor = load_session(tmp_path / "ref", device="cpu")
    assert cursor == N_CHUNKS
    assert dataclasses.asdict(session.config) == dataclasses.asdict(jsession.config)
    _assert_bit_identical(jsession.state, session.state)
    save_session(tmp_path / "port", session, cursor=N_CHUNKS)
    extra = [
        json.loads((tmp_path / d / f"step_{N_CHUNKS:08d}" / "manifest.json").read_text())
        for d in ("ref", "port")
    ]
    assert extra[0] == extra[1]


def test_port_checkpoint_restores_in_the_reference_bit_equal(uninterrupted, tmp_path):
    session, _ = uninterrupted
    save_session(tmp_path, session, cursor=N_CHUNKS)
    jsession, cursor = jload_session(tmp_path)
    assert cursor == N_CHUNKS
    assert dataclasses.asdict(jsession.config) == dataclasses.asdict(session.config)
    _assert_bit_identical(session.state, jsession.state)


# ------------------------------------------- the session against the reference
def test_session_follows_the_reference_on_the_drifting_stream(stream, reference, monkeypatch):
    monkeypatch.setattr(session_mod, "_session_key", lambda seed: JaxKey(jax.random.PRNGKey(seed)))
    jsession, want = reference
    session = BWKMSession(CONFIG, device="cpu")
    got = run_service(session, ck.ArrayChunkSource(stream, CHUNK_ROWS))
    assert len(got) == len(want) == N_CHUNKS
    assert any(m["refit"] for m in want[1:])
    for g, w in zip(got, want):
        assert (g["batch"], g["n_points"], g["refit"], g["n_splits"], g["n_blocks"]) == (
            w["batch"], w["n_points"], w["refit"], w["n_splits"], w["n_blocks"]
        )
        assert abs(g["boundary_frac"] - w["boundary_frac"]) <= 1e-5
        np.testing.assert_allclose(g["error"], w["error"], rtol=1e-3)
    np.testing.assert_allclose(
        session.state.centroids.numpy(), np.asarray(jsession.state.centroids), rtol=1e-3, atol=1e-4
    )
    assert float(session.state.points) == float(jsession.state.points) == N_CHUNKS * CHUNK_ROWS


# ------------------------------------------------ crash and resume, in the port
def _make_source(kind, stream, tmp_path):
    if kind == "array":
        return ck.ArrayChunkSource(stream, CHUNK_ROWS)
    paths = ck.write_npy_shards(stream, tmp_path / "shards", rows_per_shard=300)
    return ck.ShardedFileSource(paths, CHUNK_ROWS)


@pytest.mark.parametrize("kind", ["array", "shards"])
@pytest.mark.parametrize("crash_at", [1, 3, 6])
def test_resume_from_checkpoint_is_bit_identical_to_uninterrupted(
    kind, crash_at, stream, uninterrupted, tmp_path
):
    source = _make_source(kind, stream, tmp_path)
    ckpt_dir = str(tmp_path / "ckpt")
    with pytest.raises(InjectedCrash):
        run_service(BWKMSession(CONFIG, device="cpu"), CrashingSource(source, crash_at),
                    checkpoint_dir=ckpt_dir, checkpoint_every=2)
    # crash_at = 1 dies before the first checkpoint: the resume starts afresh
    resumed, metrics = resume_service(ckpt_dir, source, config=CONFIG, device="cpu")
    cursor = (crash_at // 2) * 2
    assert sum(m["n_points"] for m in metrics) == (N_CHUNKS - cursor) * CHUNK_ROWS
    ref_session, ref_metrics = uninterrupted
    assert metrics == ref_metrics[cursor:]
    _assert_bit_identical(ref_session.state, resumed.state)
    probe = stream[::N_CHUNKS]
    assert torch.equal(resumed.predict(probe), ref_session.predict(probe))


@pytest.mark.parametrize("kind", ["array", "shards"])
def test_resume_after_clean_finish_is_a_noop(kind, stream, uninterrupted, tmp_path):
    source = _make_source(kind, stream, tmp_path)
    session = BWKMSession(CONFIG, device="cpu")
    run_service(session, source, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3)
    resumed, metrics = resume_service(str(tmp_path / "ck"), source, device="cpu")
    assert metrics == []
    _assert_bit_identical(session.state, resumed.state)
    _assert_bit_identical(uninterrupted[0].state, resumed.state)


def test_resume_midstream_is_bit_exact(stream, uninterrupted, tmp_path):
    source = ck.ArrayChunkSource(stream, CHUNK_ROWS)
    half = BWKMSession(CONFIG, device="cpu")
    run_service(half, source, checkpoint_dir=str(tmp_path), checkpoint_every=4,
                max_chunks=N_CHUNKS // 2)
    resumed, metrics = resume_service(str(tmp_path), source, device="cpu")
    assert len(metrics) == N_CHUNKS - N_CHUNKS // 2
    _assert_bit_identical(uninterrupted[0].state, resumed.state)


def test_resume_without_checkpoint_or_config_raises(stream, tmp_path):
    with pytest.raises(ValueError, match="no checkpoint"):
        resume_service(str(tmp_path), ck.ArrayChunkSource(stream, CHUNK_ROWS), device="cpu")


# ----------------------------------------------------------- quarantine
def test_quarantine_and_the_noop_metrics_schema(stream):
    session = BWKMSession(CONFIG, device="cpu")
    nothing = session.partial_fit(np.full((4, DIM), np.nan, np.float32))
    assert session.state is None and nothing["n_points"] == 0 and nothing["quarantined"] == 4
    first = stream[:CHUNK_ROWS].copy()
    first[[3, 9]] = [np.inf, np.nan, 0, 0]
    real = session.partial_fit(first)
    assert real["n_points"] == CHUNK_ROWS - 2
    assert session.health.quarantined_rows == 6
    nan_batch = np.full((5, DIM), np.nan, np.float32)
    noop = session.partial_fit(nan_batch)
    assert set(real) <= set(noop)
    assert noop == {"batch": 1, "n_points": 0, "quarantined": 5, "boundary_frac": 0.0,
                    "refit": False, "n_splits": 0, "n_blocks": real["n_blocks"],
                    "error": real["error"]}
    assert int(session.state.batches) == 1 and session.health.quarantined_rows == 11
    clean = BWKMSession(CONFIG, device="cpu")
    clean.partial_fit(np.delete(stream[:CHUNK_ROWS], [3, 9], 0))
    _assert_bit_identical(clean.state, session.state)  # the filter is exact
    with pytest.raises(ValueError, match="batch dim"):
        session.partial_fit(np.zeros((3, DIM + 1), np.float32))
    with pytest.raises(ValueError, match="non-empty"):
        session.partial_fit(np.zeros((0, DIM), np.float32))


# ------------------------------------------------------- batched predictor
RNG = np.random.RandomState(0)
CENTROIDS = (RNG.randn(5, 3) * 4).astype(np.float32)


def _brute_labels(x):
    return ((x[:, None, :] - CENTROIDS[None]) ** 2).sum(-1).argmin(1).astype(np.int32)


def test_concurrent_requests_coalesce_into_chunk_calls():
    predictor = BatchedPredictor(CENTROIDS, chunk_size=64, device="cpu")
    reference = JPredictor(CENTROIDS, chunk_size=64)
    sizes = [7, 100, 31, 64, 3, 57]
    reqs = [RNG.randn(s, 3).astype(np.float32) * 4 for s in sizes]
    tickets = [None] * len(reqs)

    def submit(i):
        tickets[i] = predictor.submit(reqs[i])

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not any(t.done for t in tickets)
    assert predictor.flush() == len(reqs)
    assert predictor.stats["n_kernel_calls"] == -(-sum(sizes) // 64)
    assert predictor.stats["n_flushes"] == 1
    for t, r, want in zip(tickets, reqs, reference.predict_many(reqs)):
        got = t.result(timeout=5)
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        np.testing.assert_array_equal(got, _brute_labels(r))
        np.testing.assert_array_equal(got, want)
    assert predictor.stats == reference.stats


def test_ragged_final_batch_is_padded_inert():
    predictor = BatchedPredictor(CENTROIDS, chunk_size=32, device="cpu")
    reqs = [RNG.randn(s, 3).astype(np.float32) * 4 for s in (30, 11)]  # 41 rows
    out = predictor.predict_many(reqs)
    assert [o.shape[0] for o in out] == [30, 11]
    for o, r in zip(out, reqs):
        np.testing.assert_array_equal(o, _brute_labels(r))
    assert predictor.stats["n_kernel_calls"] == 2
    assert predictor.stats["rows_padded"] == 2 * 32 - 41


def test_transform_requests_batch_separately_from_predict():
    predictor = BatchedPredictor(CENTROIDS, chunk_size=16, device="cpu")
    xp = RNG.randn(10, 3).astype(np.float32)
    xt = RNG.randn(12, 3).astype(np.float32)
    tp = predictor.submit(xp, kind="predict")
    tt = predictor.submit(xt, kind="transform")
    predictor.flush()
    np.testing.assert_array_equal(tp.result(), _brute_labels(xp))
    want = JPredictor(CENTROIDS, chunk_size=16).transform(xt)
    np.testing.assert_allclose(tt.result(), want, rtol=1e-5, atol=1e-5)
    assert predictor.stats["n_kernel_calls"] == 2  # one per kind, not per request


def test_predictor_validates_inputs():
    predictor = BatchedPredictor(CENTROIDS, chunk_size=8, device="cpu")
    with pytest.raises(ValueError, match="request"):
        predictor.submit(np.zeros((3, 7), np.float32))
    with pytest.raises(ValueError, match="kind"):
        predictor.submit(np.zeros((3, 3), np.float32), kind="cluster")
    with pytest.raises(TimeoutError):
        predictor.submit(np.zeros((3, 3), np.float32)).result(timeout=0.01)
    with pytest.raises(ValueError, match="chunk_size"):
        BatchedPredictor(CENTROIDS, chunk_size=0, device="cpu")
    with pytest.raises(ValueError, match="centroids"):
        BatchedPredictor(CENTROIDS[0], device="cpu")


# ------------------------------------------------------------ the estimator
def test_partial_fit_is_the_session(stream, uninterrupted):
    model = repro_torch.BWKM(device="cpu", service=CONFIG)
    for i in range(N_CHUNKS):
        assert model.partial_fit(stream[i * CHUNK_ROWS : (i + 1) * CHUNK_ROWS]) is model
    session, metrics = uninterrupted
    assert model.engine_ == "service" and model.n_iter_ == N_CHUNKS
    assert model.session_.last_metrics == metrics[-1]
    assert torch.equal(model.centroids_, session.state.centroids)
    assert torch.equal(model.predict(stream), session.predict(stream))
    assert model.transform(stream[:10]).shape == (10, K)
    assert model.score(stream) > 0


def test_partial_fit_default_service_wraps_the_models_config_and_seed(stream):
    model = repro_torch.BWKM(k=K, device="cpu", seed=5, max_iters=4, lloyd_max_iters=20)
    model.partial_fit(stream[:CHUNK_ROWS]).partial_fit(stream[CHUNK_ROWS : 2 * CHUNK_ROWS])
    assert model.session_.config == ServiceConfig(base=model.config, seed=5)
    session = BWKMSession(ServiceConfig(base=model.config, seed=5), device="cpu")
    session.partial_fit(stream[:CHUNK_ROWS])
    session.partial_fit(stream[CHUNK_ROWS : 2 * CHUNK_ROWS])
    assert torch.equal(model.centroids_, session.centroids)


def test_service_argument_checks_match_the_reference():
    for kwargs in ({"k": K + 1}, {"config": BWKMConfig(k=K)}):
        with pytest.raises(ValueError) as got:
            repro_torch.BWKM(device="cpu", service=CONFIG, **kwargs)
        jkw = {"k": K + 1} if "k" in kwargs else {"config": JBWKMConfig(k=K)}
        with pytest.raises(ValueError) as want:
            repro.BWKM(service=JCONFIG, **jkw)
        assert str(got.value) == str(want.value)
    model = repro_torch.BWKM(device="cpu", service=CONFIG)
    assert model.config == CONFIG.base and model.service is CONFIG
    with pytest.raises(TypeError, match="ServiceConfig"):
        BWKMSession(CONFIG.base, device="cpu")
    with pytest.raises(ValueError, match="decay"):
        ServiceConfig(base=CONFIG.base, decay=0.0)


def test_service_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = ck.ArrayChunkSource(_small_stream(), 128)
    for call in (
        lambda: BWKMSession(CONFIG),
        lambda: load_session(tmp_path),
        lambda: resume_service(str(tmp_path), src, config=CONFIG),
        lambda: BatchedPredictor(CENTROIDS),
        lambda: session_state_template(4, 2, 2),
        lambda: repro_torch.BWKM(service=CONFIG),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert BWKMSession(CONFIG, device="cpu").device.type == "cpu"
    assert BatchedPredictor(CENTROIDS, device="cpu").centroids.device.type == "cpu"
