"""The port's clustering drivers beside the reference's, on the CPU.

``repro_torch.launch.cluster.main`` and ``repro_torch.launch.serve``'s
``cluster_main`` run with ``--device cpu`` at a small size next to
``repro.launch.cluster.main`` and ``repro.launch.serve.cluster_main`` on the
same arguments; ``serve --task lm --kv-quantize`` runs on the CPU and
reports the reference's keys. ``JaxKey`` (``test_torch_bwkm``) stands in for the port's
keys so both draw the same numbers: the same stop reason, iterations and
blocks, errors and distances within ``tests/test_golden.py``'s tolerances
(error rtol 1e-3, distances rtol 0.05).
"""

import ast
import inspect
import textwrap

import jax
import numpy as np
import pytest
import torch
from test_torch_bwkm import JaxKey

from repro.launch import cluster as jcluster
from repro.launch import serve as jserve
from repro_torch import random as rnd
from repro_torch.launch import cluster, serve
from repro_torch.launch.mesh import make_smoke_mesh

CLUSTER_ARGS = ["--dataset", "CIF", "--scale", "0", "--k", "3", "--max-iters", "3"]
SERVE_ARGS = ["--k", "3", "--dim", "4", "--stream-chunks", "6", "--chunk-rows", "256",
              "--requests", "8", "--request-rows", "50", "--serve-chunk-size", "128"]


@pytest.fixture
def jax_keys(monkeypatch):
    monkeypatch.setattr(rnd, "key", lambda seed: JaxKey(jax.random.PRNGKey(seed)))


def test_cluster_driver_follows_the_reference(jax_keys):
    got = cluster.main(CLUSTER_ARGS + ["--device", "cpu"])["bwkm"]
    want = jcluster.main(CLUSTER_ARGS)["bwkm"]
    assert (got["stop"], got["iterations"], got["blocks"]) == \
        (want["stop"], want["iterations"], want["blocks"])
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-3)
    np.testing.assert_allclose(got["distances"], want["distances"], rtol=0.05)


def test_cluster_driver_compares_the_baselines_and_runs_distributed():
    out = cluster.main(CLUSTER_ARGS + ["--device", "cpu", "--compare"])
    assert set(out) == {"bwkm", "forgy", "km++", "kmc2", "mb100", "grid-rpkm"}
    assert min(v["relative_error"] for v in out.values()) == 0.0
    assert all(np.isfinite(v["error"]) and v["distances"] > 0 for v in out.values())
    dist = cluster.main(CLUSTER_ARGS + ["--device", "cpu", "--distributed"])["bwkm"]
    assert dist["iterations"] >= 1 and np.isfinite(dist["error"])


def test_serve_clusters_driver_follows_the_reference(jax_keys):
    got = serve.main(["--task", "clusters", *SERVE_ARGS, "--device", "cpu"])
    want = jserve.cluster_main(SERVE_ARGS)
    assert len(got["metrics"]) == len(want["metrics"]) == 6
    for g, w in zip(got["metrics"], want["metrics"]):
        assert (g["batch"], g["n_points"], g["refit"], g["n_splits"], g["n_blocks"]) == (
            w["batch"], w["n_points"], w["refit"], w["n_splits"], w["n_blocks"])
        np.testing.assert_allclose(g["error"], w["error"], rtol=1e-3)
    assert got["predictor_stats"] == want["predictor_stats"]
    assert [lab.shape for lab in got["labels"]] == [lab.shape for lab in want["labels"]]
    x = serve.drifting_stream(1, 6, 256, 4, 3)
    np.testing.assert_array_equal(x, jserve.drifting_stream(1, 6, 256, 4, 3))


def test_serve_resumes_from_its_checkpoints_and_lm_waits_for_the_models(tmp_path):
    args = ["--task", "clusters", *SERVE_ARGS, "--device", "cpu",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    first = serve.main(args)
    assert len(first["metrics"]) == 6
    again = serve.main(args)  # the stream is consumed: a resume is a no-op
    assert again["metrics"] == []
    assert torch.equal(again["session"].centroids, first["session"].centroids)
    # the models came with ROADMAP A15: --task lm runs, and needs the card
    # unless the caller passes the CPU
    out = serve.main(["--task", "lm", "--batch", "2", "--prompt-len", "8", "--gen", "3"],
                     device="cpu")
    assert out["tokens"].shape == (2, 3) and out["tokens"].dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--task", "lm"])


def _reference_report_keys() -> set[str]:
    """The keys of the ``report`` dict literal of the reference's
    ``_kv_quantize_report`` (read from its source, not run), and of the
    result it updates."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jserve._kv_quantize_report)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "report":
            return {k.value for k in node.value.keys} | {"tokens", "tok_per_s"}
    raise AssertionError("no report literal in the reference")


def test_serve_lm_kv_quantize_reports_the_references_keys(capsys):
    out = serve.main(["--task", "lm", "--kv-quantize", "--batch", "2", "--prompt-len", "16",
                      "--gen", "6", "--fit-prompts", "4"], device="cpu")
    assert set(out) == _reference_report_keys()
    printed = capsys.readouterr().out
    assert printed.count("[serve:vq]") == 3 and "codebook fit in" in printed
    assert out["codebook_k"] == 8 and out["tokens_vq"].shape == (2, 6)
    assert out["cache_bytes_fp"] == 64 * out["cache_bytes_vq"]  # f32 hd = 16 → one uint8
    assert np.isfinite([out["ppl_fp16"], out["ppl_bwkm"], out["ppl_random"]]).all()


def test_smoke_mesh_is_one_rank_and_torn_down():
    import torch.distributed as dist

    with make_smoke_mesh("cpu") as mesh:
        assert tuple(mesh.mesh_dim_names) == ("data",) and dist.get_world_size() == 1
        with pytest.raises(RuntimeError, match="process group exists"):
            with make_smoke_mesh("cpu"):
                pass
    assert not dist.is_initialized()
