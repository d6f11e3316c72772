"""Session checkpointing on the ``train/checkpoint.py`` npz + manifest format.

Counterpart of ``repro.service.checkpoint``. One checkpoint is the whole
:class:`~repro_torch.service.session.SessionState` (partition boxes and
statistics, centroids, the top-2 bound state, the key, the batch and point
counters) plus a manifest holding the stream cursor and the
:class:`ServiceConfig`: enough to rebuild the session with nothing else.
Save is atomic, restore is bit-identical (npz keeps arrays exactly; dtypes
are those of the template), and the step number is the stream cursor.

The key is stored as the reference stores one, ``uint32[2]`` under
``session§key`` (``random.key_to_words``), and every other array under the
reference's name and dtype, so a checkpoint written by either package
restores in the other with every array bit-equal.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import torch

from repro_torch import random as rnd
from repro_torch.core.bwkm import BWKMConfig
from repro_torch.core.partition import Partition
from repro_torch.device import resolve_device
from repro_torch.health import RunHealth
from repro_torch.service.session import BWKMSession, ServiceConfig, SessionState
from repro_torch.train import checkpoint as train_ckpt

__all__ = ["load_session", "save_session", "session_state_template"]

_SCHEMA = 1


def session_state_template(
    capacity: int, d: int, k: int, *, device: str | torch.device = "cuda"
) -> SessionState:
    """The all-inactive, zero-mass state of these sizes on ``device``: the
    shapes and dtypes ``load_session`` restores into."""
    device = resolve_device(device)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    part = Partition(
        lo=zeros(capacity, d),
        hi=zeros(capacity, d),
        psum=zeros(capacity, d),
        count=zeros(capacity),
        active=zeros(capacity, dtype=torch.bool),
        block_id=zeros(0, dtype=torch.int32),
        n_blocks=zeros(dtype=torch.int32),
    )
    return SessionState(
        partition=part,
        centroids=zeros(k, d),
        d1=zeros(capacity),
        d2=zeros(capacity),
        key=rnd.key(0),
        batches=zeros(dtype=torch.int32),
        points=zeros(),
    )


def _config_from_manifest(d: dict[str, Any]) -> ServiceConfig:
    d = dict(d)
    return ServiceConfig(base=BWKMConfig(**d.pop("base")), **d)


def save_session(
    directory: str | pathlib.Path,
    session: BWKMSession,
    *,
    cursor: int,
    health: RunHealth | None = None,
    keep_last_n: int | None = None,
) -> pathlib.Path:
    """Write ``<dir>/step_<cursor>/`` atomically. ``cursor`` is the index of
    the first stream chunk the session has NOT consumed. ``health``
    replaces the session's own ledger in the manifest (``run_service``
    passes it merged with the source's); ``keep_last_n`` goes to the
    retention of ``train.checkpoint.save``."""
    state = session.state
    if state is None:
        raise ValueError("cannot checkpoint an uninitialized session")
    if health is None:
        health = session.health
    extra = {
        "schema": _SCHEMA,
        "cursor": int(cursor),
        "capacity": int(state.partition.capacity),
        "d": int(state.partition.dim),
        "k": int(state.centroids.shape[0]),
        "batches": int(state.batches),
        "points": float(state.points),
        "config": dataclasses.asdict(session.config),
        "health": health.as_dict() if health is not None else {},
    }
    stored = state._replace(key=rnd.key_to_words(state.key))
    return train_ckpt.save(
        directory, int(cursor), {"session": stored}, extra, keep_last_n=keep_last_n
    )


def load_session(
    directory: str | pathlib.Path,
    *,
    step: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[BWKMSession, int] | None:
    """Restore ``(session, cursor)`` from the latest (or the given)
    checkpoint onto ``device``; ``None`` when the directory holds none."""
    device = resolve_device(device)
    if step is None:
        step = train_ckpt.latest_step(directory)
        if step is None:
            return None
    manifest = json.loads(
        (pathlib.Path(directory) / f"step_{step:08d}" / "manifest.json").read_text()
    )
    extra = manifest["extra"]
    if extra.get("schema") != _SCHEMA:
        raise ValueError(f"checkpoint schema {extra.get('schema')!r} != supported {_SCHEMA}")
    template = session_state_template(extra["capacity"], extra["d"], extra["k"], device=device)
    template = template._replace(key=rnd.key_to_words(template.key))
    restored, _ = train_ckpt.restore(directory, step, {"session": template}, device=device)
    state = restored["session"]
    session = BWKMSession(_config_from_manifest(extra["config"]), device=device)
    session.state = state._replace(key=rnd.key_from_words(state.key))
    session.health = RunHealth.from_dict(extra.get("health"))
    return session, int(extra["cursor"])
