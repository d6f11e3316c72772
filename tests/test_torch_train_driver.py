"""The port's training driver (``repro_torch.launch.train``) on the CPU, as
``tests/test_system.py`` runs the reference's: granite-8b reduced, 12 steps
with a checkpoint every 6, then a resume to 14. The resumed steps are bit
for bit those of an uninterrupted run with the same schedule, and the
reference's ``train.checkpoint.restore`` reads the port's checkpoint into
its own tree.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.launch import train
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ARGS = ["--arch", "granite-8b", "--reduced", "--batch", "2", "--seq", "64", "--ckpt-every", "6",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small models: where several test
    workers share the cores, torch's default pool waits on busy cores and
    runs many times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_driver_lowers_its_loss_and_resumes(tmp_path):
    out = train.main([*ARGS, "--steps", "12", "--lr", "5e-3", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 12 and np.isfinite(out["losses"]).all()
    assert out["final_loss"] < out["losses"][0]
    assert ckpt.latest_step(tmp_path) == 12
    out2 = train.main([*ARGS, "--steps", "14", "--ckpt-dir", str(tmp_path)])
    assert len(out2["losses"]) == 14 - 12  # resumed from step 12
    # the reference restores the port's checkpoint into its own tree
    jcfg = jconfigs.reduced_config(jconfigs.get_config("granite-8b"))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    jstate, extra = jckpt.restore(tmp_path, 12, {"params": jp, "opt": jopt.adamw_init(jp)})
    cfg = configs.reduced_config(configs.get_config("granite-8b"))
    params, state = ts.init_train_state(cfg, rnd.key(0), device="cpu")
    mine, extra2 = ckpt.restore(tmp_path, 12, {"params": params, "opt": state}, device="cpu")
    assert extra["step"] == extra2["step"] == 12 and extra["arch"] == "granite-8b"
    assert int(jstate["opt"]["step"]) == int(mine["opt"]["step"]) == 12
    jflat = [*jax.tree.leaves(jstate["params"]), *jax.tree.leaves(jstate["opt"]["m"]),
             *jax.tree.leaves(jstate["opt"]["v"])]
    got = [*opt.leaves(mine["params"]), *opt.leaves(mine["opt"]["m"]),
           *opt.leaves(mine["opt"]["v"])]
    assert len(jflat) == len(got) == 3 * len(jax.tree.leaves(jp))
    for a, b in zip(jflat, got):
        assert a.shape == b.shape and a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

def test_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path):
    whole = train.main([*ARGS, "--steps", "14", "--ckpt-dir", str(tmp_path / "a")])
    assert ckpt.latest_step(tmp_path / "a") == 12
    resumed = train.main([*ARGS, "--steps", "14", "--ckpt-dir", str(tmp_path / "a")])
    assert resumed["losses"] == whole["losses"][12:]
    plain = train.main([*ARGS, "--steps", "14"])
    assert plain["losses"] == whole["losses"]


def test_train_driver_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "granite-8b", "--reduced", "--steps", "1"])
