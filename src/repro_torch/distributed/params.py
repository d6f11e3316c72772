"""Parameter, cache and input layouts on the ``"data"`` mesh, by leaf name.

Counterpart of ``repro.distributed.params``. The reference shards every
weight matrix two ways: its "fan-in-ish" dimension over the data-parallel
axes (FSDP) and its "parallel" dimension over the model axis. The port keeps
the reference's name tables (:data:`_RULES`, :func:`_moe_rule`,
:data:`_CACHE_RULES`) and resolves them as the reference's ``_dim_spec``
does on a mesh without a model axis (``src/repro/distributed/sharding.py``):

* a ``"batch"`` entry becomes ``Shard(dim)`` over ``"data"`` where the
  number of ranks divides that dimension, and leaves the dimension whole
  where it does not (the reference drops an axis that does not divide);
* ``"tensor"``, ``"expert"``, ``"seq"`` and ``"model"`` leave it whole.

Each function returns a tree shaped like its input whose leaves are
``torch.distributed.tensor`` placement tuples, one entry per mesh dimension:
``(Shard(d),)`` or ``(Replicate(),)``. The port runs no FSDP step
(``train_step.make_train_step`` refuses ``param_shardings``): these
placements serve the dry run's per-device accounting
(``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs import ArchConfig
from repro_torch.distributed import sharding as sh

__all__ = ["param_shardings", "cache_shardings", "input_shardings"]

# name -> logical spec for the *unstacked* leaf (trailing dims)
_RULES: dict[str, tuple] = {
    "embed": ("tensor", "batch"),
    "out_head": ("batch", "tensor"),
    "wq": ("batch", "tensor"),
    "wk": ("batch", "tensor"),
    "wv": ("batch", "tensor"),
    "wo": ("tensor", "batch"),
    "w1": ("batch", "tensor"),
    "w3": ("batch", "tensor"),
    "w2": ("tensor", "batch"),
    "router": (None, None),
    "in_proj": ("batch", "tensor"),
    "out_proj": ("tensor", "batch"),
    "shared_in": ("batch", "tensor"),
    "conv_w": (None, None),
}


def _moe_rule(cfg: ArchConfig, name: str) -> tuple:
    """MoE expert tensors (rank 3 under a ``moe`` key), by the reference's
    MoE mode on the current model axis (of size 1 in the port)."""
    from repro_torch.models.moe import moe_mode

    mode = moe_mode(cfg.n_experts, max(sh.axis_size("model"), 1))
    if name in ("w1", "w3"):
        return {
            "ep": ("expert", "batch", None),
            "ep_split": (None, "batch", "tensor"),
            "tp": (None, "batch", "tensor"),
        }[mode]
    if name == "w2":
        return {
            "ep": ("expert", None, "batch"),
            "ep_split": (None, "tensor", "batch"),
            "tp": (None, "tensor", "batch"),
        }[mode]
    raise KeyError(name)


_CACHE_RULES: dict[str, tuple] = {
    # [L, B, S, kv, hd]: batch over data; the reference's cache seq goes over
    # its model axis, which the port does not have
    "k": (None, "batch", "seq", None, None),
    "v": (None, "batch", "seq", None, None),
    "xk": (None, "batch", None, None, None),
    "xv": (None, "batch", None, None, None),
    "slot_pos": ("batch", "seq"),
    "conv": (None, "batch", None, None),
    "ssm": (None, "batch", "tensor", None, None),
}


def _dim_axis(entry, size: int) -> str | None:
    """One logical entry resolved to the mesh: ``"data"`` where it names the
    data-parallel axes and their ranks divide ``size``, else ``None``."""
    if entry is None:
        return None
    resolved: list[str] = []
    for name in entry if isinstance(entry, tuple) else (entry,):
        if name == "batch":
            resolved.extend(sh.batch_axes())
        elif name in ("pod", "data"):
            if name in sh.batch_axes():
                resolved.append(name)
        elif name not in ("seq", "tensor", "expert", "model"):
            raise ValueError(f"unknown logical axis {name!r}")
    resolved = list(dict.fromkeys(resolved))
    total = 1
    for name in resolved:
        total *= sh.axis_size(name)
    if not resolved or size % total:
        return None
    return resolved[0]


def _placements(logical, shape) -> tuple:
    """The placement tuple of a leaf of ``shape`` under ``logical``."""
    from torch.distributed.tensor import Replicate, Shard

    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} for a leaf of shape {tuple(shape)}")
    for dim, (entry, size) in enumerate(zip(logical, shape)):
        if _dim_axis(entry, int(size)) is not None:
            return (Shard(dim),)
    return (Replicate(),)


def _require_mesh() -> None:
    if sh.current_mesh() is None:
        raise RuntimeError("the layouts are resolved on the current mesh: "
                           "call inside use_mesh(mesh)")


def _map_with_names(fn, tree: Any, names: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, (*names, k)) for k, v in tree.items()}
    return fn(names, tree)


def _leaf_logical(cfg: ArchConfig, names: tuple, leaf) -> tuple:
    name = names[-1]
    rank = leaf.ndim
    if "moe" in names and "shared" not in names and name in ("w1", "w3", "w2") and rank >= 3:
        logical = _moe_rule(cfg, name)
    elif name in _RULES:
        logical = _RULES[name]
    else:
        logical = (None,) * min(rank, 1)  # norms, biases, scalars: replicated
    return (None,) * (rank - len(logical)) + tuple(logical)  # stacked layer axes


def param_shardings(cfg: ArchConfig, params: Any) -> Any:
    """The placement tree of a parameter tree (``init_params``' on any
    device, or ``adamw_init``'s moments, which share its names)."""
    _require_mesh()
    return _map_with_names(lambda n, leaf: _placements(_leaf_logical(cfg, n, leaf), leaf.shape),
                           params)


def _cache_logical(names: tuple, leaf) -> tuple:
    logical = _CACHE_RULES[names[-1]]
    pad = leaf.ndim - len(logical)
    return (None,) * pad + tuple(logical[-leaf.ndim:] if pad < 0 else logical)


def cache_shardings(cfg: ArchConfig, cache: Any) -> Any:
    """The placement tree of a decode cache (``init_cache`` or
    ``cache_specs``)."""
    _require_mesh()
    return _map_with_names(lambda n, leaf: _placements(_cache_logical(n, leaf), leaf.shape),
                           cache)


def input_shardings(cfg: ArchConfig, specs: dict) -> dict:
    """Placements of the step inputs that ``configs.input_specs`` builds:
    the batch dimension over ``"data"`` where it divides, ``pos``
    replicated."""
    _require_mesh()
    out: dict[str, Any] = {}
    for name, v in specs.items():
        if name == "cache":
            out[name] = cache_shardings(cfg, v)
        elif name in ("tokens", "labels"):
            out[name] = _placements(("batch", None), v.shape)
        elif name == "image_embeds":
            out[name] = _placements(("batch", None, None), v.shape)
        elif name == "token":
            out[name] = _placements(("batch",), v.shape)
        elif name == "pos":
            out[name] = _placements((), ())
        else:
            raise KeyError(name)
    return out
