"""Checkpoint save/restore with integrity checks and retention.

Counterpart of ``repro.train.checkpoint``, on the same on-disk format, so
either package restores the other's checkpoints: ``<dir>/step_<n:08d>/``
holds ``state.npz`` (one array per leaf) and ``manifest.json`` (the step,
the sorted keys, a CRC-32 per array under ``checksums``, and the caller's
``extra``). A leaf's key is its path joined with ``"§"``, built as
``jax.tree_util.tree_flatten_with_path`` builds it: a dict's keys in sorted
order, a NamedTuple's field names. Leaves are tensors or numpy arrays;
:func:`restore` gives each back as its template leaf is, a tensor on the
``device`` asked for or a numpy array; ``shardings=`` places leaves one by
one (a tree of ``torch.device``s shaped like the template).

Integrity: :func:`restore` re-hashes every array it loads and raises
:class:`CheckpointCorruptionError` naming the first bad key, so a truncated
or bit-flipped checkpoint fails loudly. :func:`save` is atomic (written
under ``.tmp_step_<n>`` and renamed) and replace-safe: re-saving a step
moves the old directory aside before the new one is renamed in, and clears
the debris of a save that died mid-write. ``keep_last_n`` deletes older
steps but never the newest one that verifies. Checkpoints written before
checksums existed (no ``checksums`` field) verify and restore.

The reference's ``shardings=`` is a tree of ``NamedSharding``s, one
placement per leaf, where elastic resharding happens. The port's takes, per
leaf, a ``torch.device`` (the leaf whole on that device) or a placement
tuple of ``distributed.params`` (``(Shard(d),)`` or ``(Replicate(),)``):
inside ``sharding.use_mesh``, each rank then gets its slice of the stored
whole leaf (``distributed.fsdp.shard_tree``), whatever W the checkpoint
was saved at. :func:`save` given the same placements takes this rank's
shards, gathers each leaf whole, and writes the same format from rank 0
(every rank returns once the checkpoint is in place). The state the
sharded plane checkpoints (centroids and boxes) is replicated, so each
rank restores it whole onto its own device.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import zipfile
import zlib
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as sh

__all__ = [
    "CheckpointCorruptionError",
    "latest_step",
    "restore",
    "save",
    "verify",
]

_SEP = "§"


class CheckpointCorruptionError(RuntimeError):
    """A stored array's checksum does not match its manifest entry (or a
    manifest/npz file is missing or unreadable)."""


def _children(tree: Any) -> list[tuple[str, Any]] | None:
    """``(key, subtree)`` pairs of a dict or NamedTuple in the reference's
    order; ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    return None


def _leaves(tree: Any, prefix: str) -> Iterator[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _leaves(v, f"{prefix}{_SEP}{k}" if prefix else k)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save(
    directory: str | pathlib.Path,
    step: int,
    state: dict[str, Any],
    extra: dict | None = None,
    *,
    keep_last_n: int | None = None,
    shardings: dict[str, Any] | None = None,
) -> pathlib.Path:
    """Write ``<dir>/step_<n>/state.npz`` and its manifest, atomically;
    replace-safe when the step already exists. ``keep_last_n`` deletes
    older steps after a successful write. ``shardings`` (placement trees
    under some of ``state``'s names, inside ``use_mesh``) marks those trees
    as this rank's shards: every rank calls, the leaves are gathered whole
    and rank 0 writes."""
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    if shardings:
        if sh.current_mesh() is None:
            raise ValueError("save(shardings=...) gathers shards over the mesh: call inside "
                             "sharding.use_mesh(mesh)")
        state = {k: fsdp.full_tree(v, shardings[k]) if k in shardings else v
                 for k, v in state.items()}
        if sh._mesh_rank() != 0 or sh.group_rank((sh.MODEL,)) != 0:
            _barrier()
            return final
        try:
            return save(directory, step, state, extra, keep_last_n=keep_last_n)
        finally:
            _barrier()
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():  # debris from a save that died mid-write
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = {}
    for name, tree in state.items():
        for k, leaf in _leaves(tree, ""):
            flat[f"{name}{_SEP}{k}"] = _to_numpy(leaf)
    np.savez(tmp / "state.npz", **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "checksums": {k: _crc(v) for k, v in flat.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        # swap, not delete-then-rename: a crash between the two renames
        # still leaves one complete directory
        old = directory / f".old_step_{step:08d}"
        if old.exists():
            shutil.rmtree(old)
        final.rename(old)
        tmp.rename(final)
        shutil.rmtree(old)
    else:
        tmp.rename(final)
    if keep_last_n is not None:
        _gc(directory, keep_last_n)
    return final


def _barrier() -> None:
    """Every rank of the current mesh waits for the others (a barrier a
    mesh dimension: past the last, every rank has entered the first)."""
    import torch.distributed as dist

    mesh = sh.current_mesh()
    for name in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(name))


def _steps(directory: pathlib.Path) -> list[tuple[int, pathlib.Path]]:
    return sorted(
        (int(p.name.split("_")[1]), p) for p in directory.glob("step_*") if p.is_dir()
    )


def _gc(directory: pathlib.Path, keep_last_n: int) -> None:
    """Delete step directories beyond the ``keep_last_n`` newest, except
    the newest step that passes :func:`verify`: retention must never
    destroy the only restorable checkpoint."""
    keep_last_n = max(1, int(keep_last_n))
    steps = _steps(directory)
    newest_verified = next((p for _, p in reversed(steps) if verify(p)), None)
    for _, p in steps[:-keep_last_n]:
        if p != newest_verified:
            shutil.rmtree(p)


def verify(step_dir: str | pathlib.Path) -> bool:
    """True iff the step directory's arrays all match their manifest
    checksums. A checkpoint without checksums verifies: there is nothing to
    check it against."""
    step_dir = pathlib.Path(step_dir)
    try:
        manifest = json.loads((step_dir / "manifest.json").read_text())
        data = np.load(step_dir / "state.npz")
    except (OSError, ValueError, json.JSONDecodeError, zipfile.BadZipFile):
        return False
    sums = manifest.get("checksums")
    try:
        if set(manifest["keys"]) - set(data.files):
            return False
        if sums is None:
            return True
        return all(_crc(data[k]) == int(v) for k, v in sums.items())
    except (KeyError, ValueError, OSError, zlib.error, zipfile.BadZipFile):
        return False
    finally:
        data.close()


def latest_step(directory: str | pathlib.Path) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = _steps(directory)
    return steps[-1][0] if steps else None


def _like(arr: np.ndarray, leaf: Any, device: torch.device) -> Any:
    """``arr`` as the template ``leaf`` is: a tensor of its dtype on
    ``device``, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        np_dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
        return torch.from_numpy(arr.astype(np_dtype, order="C")).to(device)
    return arr.astype(np.asarray(leaf).dtype)


def _rebuild(tree: Any, prefix: str, load, place: Any = None) -> Any:
    """``tree`` with each leaf loaded; ``place`` is the matching subtree of
    placements (or ``None``)."""
    kids = _children(tree)
    if kids is None:
        return load(prefix, tree, place)
    places = dict(_children(place) or ())
    vals = [_rebuild(v, f"{prefix}{_SEP}{k}" if prefix else k, load, places.get(k))
            for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip((k for k, _ in kids), vals))
    return type(tree)(*vals)


def restore(
    directory: str | pathlib.Path,
    step: int,
    state_template: dict[str, Any],
    shardings: dict[str, Any] | None = None,
    *,
    device: str | torch.device = "cuda",
) -> tuple[dict[str, Any], dict]:
    """Restore ``step`` into the structure of ``state_template``, tensors
    on ``device``. ``shardings`` (the template's structure) places each
    leaf it names: a ``torch.device`` or device name puts it whole on that
    device; a placement tuple (inside ``use_mesh``) gives this rank its
    slice of it on ``device`` (the template holds whole shapes, on any
    device, ``"meta"`` too). Every array is checked against its manifest
    checksum first; a mismatch raises :class:`CheckpointCorruptionError`
    naming the key."""
    device = resolve_device(device)
    directory = pathlib.Path(directory) / f"step_{step:08d}"
    try:
        data = np.load(directory / "state.npz")
        manifest = json.loads((directory / "manifest.json").read_text())
    except (OSError, ValueError, json.JSONDecodeError, zipfile.BadZipFile) as e:
        raise CheckpointCorruptionError(f"checkpoint {directory} is unreadable: {e}") from e
    sums = manifest.get("checksums")  # absent on checkpoints from before checksums

    def load(key: str, leaf: Any, place: Any) -> Any:
        try:
            arr = data[key]
        except (KeyError, OSError, ValueError, zipfile.BadZipFile, zlib.error) as e:
            raise CheckpointCorruptionError(
                f"checkpoint {directory}: array {key!r} is missing or unreadable: {e}"
            ) from e
        if sums is not None and key in sums and _crc(arr) != int(sums[key]):
            raise CheckpointCorruptionError(
                f"checkpoint {directory} is corrupt: array {key!r} fails its CRC-32 "
                "manifest check (truncated or bit-flipped storage); restore from an "
                "older step"
            )
        if arr.shape != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint {directory}: array {key!r} has shape {arr.shape}, the "
                f"template {tuple(leaf.shape)}"
            )
        if place is None:
            return _like(arr, leaf, device)
        if isinstance(place, tuple):
            if sh.current_mesh() is None:
                raise ValueError("restore(shardings=<placements>) slices leaves for this rank: "
                                 "call inside sharding.use_mesh(mesh)")
            return fsdp.shard_tree(_like(arr, leaf, torch.device("cpu")), place).to(device)
        return _like(arr, torch.as_tensor(leaf), resolve_device(place))

    shardings = shardings or {}
    try:
        # keys as save writes them: a leaf at the top is "<name>§"
        out = {
            name: _rebuild(
                tree, "", lambda k, leaf, place, name=name: load(f"{name}{_SEP}{k}", leaf, place),
                shardings.get(name),
            )
            for name, tree in state_template.items()
        }
    finally:
        data.close()
    return out, manifest["extra"]
