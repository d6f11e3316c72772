"""The port's measured autotune (``repro_torch.kernels.autotune``) on the CPU.

The reference's autotune tests (``tests/test_kernels_gpu.py``), ported with
an injected ``measure`` and the backend ``"cuda"``, then the port's own:
a CUDA-graph capture returns the analytic plan and persists nothing, an
entry made on another card is a miss, a refused candidate is skipped and
counted while a failing analytic plan raises, and no candidate varies what
would move a bit (the fold's CTA count, B3's and B5's rows a thread). That
every candidate is bit-equal on the card is ``tests/test_torch_cuda.py``'s.
"""

import json

import pytest
import torch

from repro_torch.kernels import autotune, ops
from repro_torch.kernels.distance_assign import PlanError
from repro_torch.roofline import analysis


@pytest.fixture()
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.clear_memo()
    yield tmp_path / "autotune.json"
    autotune.clear_memo()


# ------------------------------------------------ the reference's eight cases
def test_autotune_measures_once_then_serves_cache(fresh_cache):
    calls = []

    def fake_measure(plan):
        calls.append(plan["knobs"])
        # make a non-analytic candidate the winner so "measured" is
        # distinguishable from "analytic echoed back"
        return 1.0 if len(calls) == 1 else 0.5 + 0.01 * len(calls)

    blk = autotune.blocking("assign_update", n=4096, d=32, k=64, measure=fake_measure)
    assert blk["source"] == "measured"
    assert blk["candidates_timed"] == len(calls) > 1
    assert blk["speedup_vs_analytic"] >= 1.0
    assert blk["knobs"] == calls[1]  # the 0.5 s candidate won

    n_calls = len(calls)
    hit = autotune.blocking("assign_update", n=4096, d=32, k=64, measure=fake_measure)
    assert hit["source"] == "cache"
    assert len(calls) == n_calls  # a cache hit must NOT re-time
    assert hit["knobs"] == blk["knobs"] and hit["bk"] == blk["bk"]


def test_autotune_never_returns_slower_than_analytic(fresh_cache):
    # the analytic plan (the first candidate) is fastest: the tuner keeps it
    times = iter([0.1] + [0.2] * 64)
    blk = autotune.blocking("min_sqdist_update", n=2048, d=16, k=128,
                            measure=lambda p: next(times))
    ana = analysis.min_sqdist_blocking(16, 128, n=2048)
    assert blk["source"] == "measured"
    assert (blk["bn"], blk["bl"], blk["ctas"]) == (ana["bn"], ana["bl"], ana["ctas"])
    assert blk["knobs"] == {} and blk["speedup_vs_analytic"] == 1.0


def test_autotune_cache_survives_process_reload(fresh_cache):
    autotune.blocking("assign_update", n=1024, d=8, k=16, measure=lambda p: 0.1)
    autotune.clear_memo()  # a new process: memo empty, file present
    hit = autotune.blocking("assign_update", n=1024, d=8, k=16,
                            measure=lambda p: pytest.fail("cache hit must not re-time"))
    assert hit["source"] == "cache"
    assert fresh_cache.exists()


def test_autotune_no_device_falls_back_to_analytic(fresh_cache):
    if torch.cuda.is_available():
        pytest.skip("this host HAS a GPU; the fallback branch is unreachable")
    blk = autotune.blocking("assign_update", n=4096, d=32, k=64)
    ana = analysis.assign_update_blocking(32, 64, n=4096)
    assert blk["source"] == "analytic"
    assert (blk["bn"], blk["bk"], blk["fold"]) == (ana["bn"], ana["bk"], ana["fold"])
    entry = json.loads(fresh_cache.read_text())["entries"]["assign_update|n4096|d32|K64|float32|cuda"]
    assert entry["source"] == "analytic" and entry["device"] is None


def test_autotune_disabled_env_is_pure_analytic(fresh_cache, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    blk = autotune.blocking("assign_update", n=4096, d=32, k=64,
                            measure=lambda p: pytest.fail("disabled autotune must not time"))
    assert blk["source"] == "analytic"
    assert blk["knobs"] == {}
    assert not fresh_cache.exists()


def test_autotune_bucket_shares_nearby_n(fresh_cache):
    assert autotune.n_bucket(1) == 1024  # floor
    assert autotune.n_bucket(1025) == 2048
    assert autotune.cache_key("assign_update", 1500, 8, 4, torch.float32, "cuda") == \
        autotune.cache_key("assign_update", 2048, 8, 4, torch.bfloat16, "cuda").replace(
            "bfloat16", "float32"
        ) == "assign_update|n2048|d8|K4|float32|cuda"


def test_autotune_candidates_analytic_first_and_within_budget():
    for seam, tile in [("assign_update", "bk"), ("assign_update_pruned", "bk"),
                       ("min_sqdist_update", "bl")]:
        cands = autotune.candidate_blockings(seam, 32, 64)
        ana = (analysis.min_sqdist_blocking(32, 64) if seam == "min_sqdist_update"
               else analysis.assign_update_blocking(32, 64, pruned=seam != "assign_update"))
        assert cands[0]["knobs"] == {}
        assert (cands[0]["bn"], cands[0][tile]) == (ana["bn"], ana[tile])
        assert len(cands) > 1
        budget = analysis.kernel_budget_bytes("cuda")
        assert all(c["smem_bytes"] <= budget for c in cands)
        assert all(c["fold"]["smem_bytes"] <= budget for c in cands if "fold" in c)
        seen = {autotune._plan_ints(c) for c in cands}
        assert len(seen) == len(cands)  # no duplicate timings


def test_autotune_unknown_seam_raises():
    with pytest.raises(ValueError, match="unknown seam"):
        autotune.blocking("frobnicate", n=1, d=1, k=1)
    with pytest.raises(ValueError, match="cuda"):
        autotune.blocking("assign_update", n=1, d=1, k=1, backend="gpu")


# ------------------------------------------------------------ the port's own
def test_a_capture_returns_the_analytic_plan_and_persists_nothing(fresh_cache, monkeypatch):
    monkeypatch.setattr(autotune, "_device_name", lambda: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    blk = autotune.blocking("assign_update", n=65_536, d=19, k=27)
    assert blk["source"] == "analytic" and blk["knobs"] == {}
    assert not fresh_cache.exists() and not autotune._memo
    # a warm cache is served inside a capture
    monkeypatch.setattr(autotune, "_capturing", lambda: False)
    autotune.blocking("assign_update", n=65_536, d=19, k=27, measure=lambda p: 0.1)
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    assert autotune.blocking("assign_update", n=65_536, d=19, k=27)["source"] == "cache"


def test_an_entry_made_on_another_card_is_a_miss(fresh_cache, monkeypatch):
    calls = []

    def measure(plan):
        calls.append(1)
        return 0.1

    monkeypatch.setattr(autotune, "_device_name", lambda: "NVIDIA H100 80GB HBM3")
    autotune.blocking("min_sqdist_update", n=5_000, d=19, k=112, measure=measure)
    timed = len(calls)
    assert autotune.blocking("min_sqdist_update", n=5_000, d=19, k=112,
                             measure=measure)["source"] == "cache"
    assert len(calls) == timed
    monkeypatch.setattr(autotune, "_device_name", lambda: "NVIDIA H200")
    again = autotune.blocking("min_sqdist_update", n=5_000, d=19, k=112, measure=measure)
    assert again["source"] == "measured" and again["device"] == "NVIDIA H200"
    assert len(calls) == 2 * timed


def test_a_refused_candidate_is_skipped_and_a_failing_analytic_plan_raises(fresh_cache):
    def measure(plan):
        if plan["knobs"].get("ctas"):
            raise PlanError("refused")
        return 0.3 if plan["knobs"] else 0.2

    blk = autotune.blocking("assign_update", n=20_000, d=19, k=27, measure=measure)
    assert blk["candidates_refused"] == 3 and blk["knobs"] == {}
    assert blk["candidates_timed"] + 3 == len(
        autotune.candidate_blockings("assign_update", 19, 27, n=32_768))
    autotune.clear_memo()

    def broken(plan):
        raise PlanError("the analytic plan does not launch")

    with pytest.raises(PlanError):
        autotune.blocking("assign_update_pruned", n=20_000, d=19, k=27, measure=broken)


@pytest.mark.parametrize("n,d,k", [(5_000_000, 19, 561), (14_528, 19, 27), (65_536, 19, 2001),
                                   (300, 14_433, 1), (1_000, 40, 70)])
def test_no_candidate_varies_what_would_move_a_bit(n, d, k):
    """The fold's CTA count (partials summed in CTA order), B3's rows a
    thread (which rows skip together) and B5's (one cost partial a row
    tile) are the analytic plan's in every candidate."""
    for seam in autotune.SEAMS:
        cands = autotune.candidate_blockings(seam, d, k, n=n)
        ana = cands[0]
        for c in cands:
            if "fold" in c:
                assert c["fold"]["ctas"] == ana["fold"]["ctas"] == min(128, -(-n // 256))
            if seam != "assign_update":
                assert c["rows_per_thread"] == ana["rows_per_thread"] \
                    == analysis.default_rows_per_thread(n, d)
        knobs = set().union(*(c["knobs"] for c in cands))
        allowed = {"bn", "bk", "ctas", "fold_stages", "fold_part_floats"} \
            if seam == "assign_update" else {"bk", "bl", "ctas", "fold_stages", "fold_part_floats"}
        assert knobs <= allowed


def test_a_hit_resolves_the_plan_at_the_callers_n(fresh_cache, monkeypatch):
    monkeypatch.setattr(autotune, "_device_name", lambda: "NVIDIA H100 80GB HBM3")
    autotune.blocking("assign_update_pruned", n=131_072, d=19, k=27,
                      measure=lambda p: 0.1 if p["knobs"] else 0.2)
    # the same bucket (131,072), fewer rows than four a thread need
    small = autotune.blocking("assign_update_pruned", n=100_000, d=19, k=27,
                              measure=lambda p: pytest.fail("a hit must not time"))
    assert small["source"] == "cache" and small["rows_per_thread"] == 1
    big = autotune.blocking("assign_update_pruned", n=131_072, d=19, k=27)
    assert big["rows_per_thread"] == 4 and big["knobs"] == small["knobs"]


def test_the_cpu_path_never_consults_autotune(monkeypatch):
    monkeypatch.setattr(autotune, "blocking", lambda *a, **kw: pytest.fail("consulted"))
    g = torch.Generator().manual_seed(0)
    x, c = torch.randn(300, 5, generator=g), torch.randn(7, 5, generator=g)
    w = torch.ones(300)
    ops.assign_top2(x, c)
    out = ops.assign_update(x, w, c)
    ops.assign_update_pruned(x, w, c, out.assign, torch.rand(300, generator=g) < 0.5)
    ops.min_sqdist_update(x, w, c, torch.ones(7), torch.full((300,), 1e30))
