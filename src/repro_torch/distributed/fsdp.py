"""FSDP over the batch axes of the mesh (``"data"``, with ``"pod"``
pod-major): each rank stores 1/W of every weight matrix, gathers a
layer's weights where the layer runs, and gets back only its own slice of
their gradient.

The reference has no module like this: GSPMD partitions the jitted step
from the layouts of ``repro.distributed.params``. The port lays the tree
out by the same layouts (``distributed.params.param_shardings``, a
placement a mesh dimension) and runs the collectives itself:

* :func:`shard_tree` cuts each leaf to this rank's contiguous slice along
  every dimension a mesh dimension shards (ranks in order; a dimension
  over ``("pod", "data")`` pod-major); a ``Replicate()`` leaf stays whole.
  :func:`full_tree` puts the whole tree back on every rank.
* :func:`gather` and :func:`gather_tree` are the models' seams: an
  all-gather over the batch axes of a shard, in the dtype the model uses
  the leaf in (``cfg.dtype`` where the model casts at use), whose backward
  reduces the f32 gradient over those ranks and returns this rank's slice
  of the mean (a reduce-scatter). A leaf split over ``"model"`` keeps its
  model shard: the tensor-parallel layers (``distributed.tp``) use it as
  it is. A layer gathered inside ``cfg.remat``'s checkpoint is gathered
  again in the backward, so no layer stays whole.
* :func:`lookup` is the embedding's seam: the table is sharded on its
  columns, so where a rank looks up fewer rows than the table has, the
  ranks exchange those rows (an all-to-all), not the table, and the rows'
  gradients the same way back; else the table is gathered.
* :func:`mean_over_ranks` and :func:`sum_over_ranks` reduce f32 tensors
  (the replicated leaves' gradients and the loss; the squared norm).

Every collective is one ``all_reduce`` a mesh dimension: NCCL and gloo
both take it on CUDA tensors, so W gloo ranks can share one card. A
gather or an all-to-all is an ``all_reduce`` SUM of a zero-filled
``[W, ...]`` buffer in which each rank fills its own slots, as
``sharding._gather`` builds a gather (exact: each entry has one non-zero
term). The partials of a reduction are added in rank order (two ranks: one
``all_reduce`` of the operand, whose one addition has no order), so a given
W gives the same bits from run to run. Each call is counted in
``sharding.COLLECTIVE_COUNTS`` by the dry run's operand convention
(``repro_torch.launch.dryrun``): an all-gather by the rank's shard in the
dtype gathered, an all-to-all by the rank's send buffer, a
reduce-scatter or an all-reduce by the whole f32 operand.

On one batch rank every batch collective here is the identity and issues
nothing, so the steps keep the bits of the unsharded path. On the meta
device (the dry run's trace) a gather makes the whole leaf and a
reduce-scatter the shard, the tensors a native all-gather and
reduce-scatter allocate, without the ``[W, ...]`` buffers of the emulation;
the calls are counted all the same.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import sharding as sh

__all__ = ["active", "batch_dim", "check_places", "full_tree", "gather", "gather_tree",
           "layer_places", "lookup", "mean_over_ranks", "model_dim", "shard_tree",
           "sum_over_ranks", "use_dtype"]


def world() -> int:
    """Ranks over the batch axes."""
    return sh.group_size(sh.batch_axes())


def active() -> bool:
    """True on a mesh of more than one rank, where shards differ from
    their leaves."""
    return sh.current_mesh() is not None and (world() > 1 or sh.axis_size(sh.MODEL) > 1)


def _axes_of(placement) -> tuple[str, ...]:
    """The mesh dimensions of a placement tuple, by its length (the
    layouts of ``sharding.LAYOUTS``)."""
    for names in sh.LAYOUTS:
        if len(names) == len(placement):
            return names
    raise ValueError(f"a placement tuple of {len(placement)} entries: {placement}")


def _shard_dims(placement) -> dict[str, int]:
    """``{mesh dimension: the tensor dimension it shards}``."""
    from torch.distributed.tensor import Shard

    return {n: p.dim for n, p in zip(_axes_of(placement), placement) if isinstance(p, Shard)}


def batch_dim(placement) -> int | None:
    """The tensor dimension a placement tuple shards over the batch axes,
    ``None`` where it is whole over them."""
    dims = _shard_dims(placement)
    return next((dims[a] for a in (sh.POD, sh.DATA) if a in dims), None)


def model_dim(placement) -> int | None:
    """The tensor dimension a placement tuple shards over ``"model"``."""
    return _shard_dims(placement).get(sh.MODEL)


def _map(fn, tree: Any, places: Any) -> Any:
    if isinstance(tree, dict):
        if not isinstance(places, dict) or set(places) != set(tree):
            raise ValueError("the placement tree does not match the parameter tree: "
                             f"{sorted(tree)} against "
                             f"{sorted(places) if isinstance(places, dict) else places}")
        return {k: _map(fn, v, places[k]) for k, v in tree.items()}
    if isinstance(places, dict) or not isinstance(places, tuple):
        raise ValueError(f"a leaf of shape {tuple(tree.shape)} has placement {places!r}")
    return fn(tree, places)


def check_places(tree: Any, places: Any) -> None:
    """Raise unless ``places`` is a placement tree shaped like ``tree``."""
    _map(lambda leaf, p: None, tree, places)


def layer_places(places: Any, lead: int = 1) -> Any:
    """The placement tree of one layer of a stack with ``lead`` leading
    layer axes (``Shard(d)`` becomes ``Shard(d - lead)``)."""
    from torch.distributed.tensor import Shard

    if isinstance(places, dict):
        return {k: layer_places(v, lead) for k, v in places.items()}
    if any(isinstance(p, Shard) and p.dim < lead for p in places):
        raise ValueError(f"a layer axis is sharded: {places}")
    return tuple(Shard(p.dim - lead) if isinstance(p, Shard) else p for p in places)


def _slices(placement) -> dict[int, tuple[int, int]]:
    """``{tensor dimension: (this rank's index, parts)}`` under a placement
    tuple: the mesh dimensions splitting a dimension in order, outer first."""
    out: dict[int, tuple[int, int]] = {}
    for name, d in _shard_dims(placement).items():
        idx, parts = out.get(d, (0, 1))
        out[d] = (idx * sh.axis_size(name) + sh.group_rank((name,)), parts * sh.axis_size(name))
    return out


def shard_tree(tree: Any, placements: Any) -> Any:
    """This rank's leaves of ``tree`` under ``placements``: a sharded leaf
    as its contiguous slice along each sharded dimension (ranks in order),
    a ``Replicate()`` leaf whole; every leaf a new tensor."""

    def one(leaf, p):
        for d, (idx, parts) in _slices(p).items():
            n = leaf.shape[d]
            if n % parts:
                raise ValueError(f"dimension {d} of a leaf of shape {tuple(leaf.shape)} does not "
                                 f"split over {parts} ranks")
            leaf = leaf.narrow(d, idx * (n // parts), n // parts)
        return leaf.clone()

    return _map(one, tree, placements)


def full_tree(shards: Any, placements: Any) -> Any:
    """The whole tree on every rank, from every rank's ``shards`` (each
    leaf gathered in its own dtype, over the batch axes, then over
    ``"model"``)."""

    def one(s, p):
        b, m = batch_dim(p), model_dim(p)
        if b is not None:
            s = _all_gather(s, b)
        if m is not None:
            s = _all_gather(s, m, (sh.MODEL,))
        return s.clone() if b is None and m is None else s

    return _map(one, shards, placements)


# ------------------------------------------------------------ the collectives
def _exchange(t: torch.Tensor, kind: str, nbytes: int, axes=None) -> torch.Tensor:
    """``[G, *t.shape]``: every rank's ``t`` over the group of ``axes``
    (default: the batch axes) in rank order, by one ``all_reduce`` of a
    zero-filled buffer (exact: each entry has one non-zero term), counted
    as ``kind`` with ``nbytes``."""
    return sh._gather(t, axes, kind=kind, nbytes=nbytes)


def _count(kind: str, nbytes: int) -> None:
    """Count a call that the meta device does not make."""
    sh.COLLECTIVE_COUNTS[kind]["bytes"] += nbytes
    sh.COLLECTIVE_COUNTS[kind]["count"] += 1


def _all_gather(s: torch.Tensor, dim: int, axes=None) -> torch.Tensor:
    """The whole tensor along ``dim`` from every rank's shard ``s`` over the
    group of ``axes`` (default: the batch axes)."""
    axes = sh.batch_axes() if axes is None else axes
    nbytes = s.numel() * s.element_size()
    if s.device.type == "meta":
        _count("all-gather", nbytes)
        shape = list(s.shape)
        shape[dim] *= sh.group_size(axes)
        return torch.empty(shape, dtype=s.dtype, device="meta")
    buf = _exchange(s, "all-gather", nbytes, axes)  # [G, ..., n/G, ...]
    return buf.movedim(0, dim).flatten(dim, dim + 1)


def _rank_order_sum(parts: torch.Tensor) -> torch.Tensor:
    acc = parts[0].clone()
    for r in range(1, parts.shape[0]):
        acc += parts[r]
    return acc


def _sum(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Every rank's f32 ``t`` summed in rank order, counted as ``kind``
    with the bytes of ``t``. Two ranks add their two terms in one
    ``all_reduce`` of ``t`` (the sum of two floats does not depend on
    their order); more ranks exchange their terms and add them here."""
    nbytes = t.numel() * 4
    if t.device.type == "meta":
        _count(kind, nbytes)
        return t.clone()
    if world() == 2:
        return sh._all_reduce(t.clone(), kind=kind, nbytes=nbytes)
    return _rank_order_sum(_exchange(t, kind, nbytes))


def _reduce_scatter_mean(g: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the mean over ranks of the f32
    leaves ``g``."""
    n = g.shape[dim] // world()
    return _sum(g, "reduce-scatter").narrow(dim, sh._mesh_rank() * n, n) / world()


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The f32 tensor ``t`` summed over the batch ranks in rank order (one
    all-reduce); ``t`` itself on one batch rank."""
    return _sum(t.float(), "all-reduce") if world() > 1 else t


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """:func:`sum_over_ranks` divided by W."""
    return sum_over_ranks(t) / world() if world() > 1 else t


# ------------------------------------------------------------ gather at use
class _Gather(torch.autograd.Function):
    """All-gather a shard in ``dtype``; the backward is the reduce-scatter
    of the mean f32 gradient, in the shard's dtype, on the forward's mesh
    (the mesh is thread-local, and a CUDA backward runs on the autograd
    engine's own thread)."""

    @staticmethod
    def forward(ctx, s, dim, dtype):
        ctx.dim, ctx.stored, ctx.mesh = dim, s.dtype, sh.current_mesh()
        return _all_gather(s.to(dtype), dim)

    @staticmethod
    def backward(ctx, g):
        with sh.use_mesh(ctx.mesh):
            return _reduce_scatter_mean(g.float(), ctx.dim).to(ctx.stored), None, None


def use_dtype(cfg, leaf: torch.Tensor):
    """The dtype a leaf is gathered in: ``cfg.dtype`` where the model casts
    parameters at use, else its own."""
    return cfg.dtype if cfg.cast_params_before_use and leaf.is_floating_point() else leaf.dtype


def gather(cfg, leaf: torch.Tensor, placement, dtype=None) -> torch.Tensor:
    """The leaf for use from this rank's shard ``leaf``: a leaf sharded
    over the batch axes all-gathered over them in ``dtype`` (default
    :func:`use_dtype`; differentiable: its gradient comes back as this
    rank's slice of the mean over ranks), its model shard kept; a leaf whole
    over them as it is. On one batch rank, the leaf cast to that dtype."""
    d = batch_dim(placement)
    if d is None:
        return leaf
    dtype = dtype or use_dtype(cfg, leaf)
    if world() == 1:
        return leaf.to(dtype)
    return _Gather.apply(leaf, d, dtype)


class _Lookup(torch.autograd.Function):
    """The rows of a table sharded on its columns (``[V, D/W]`` a rank)
    for this rank's token ids ``[n]`` (the same n on every rank): the ids
    are all-gathered, every rank looks every rank's ids up in its columns,
    and the rows go to their ranks (an all-to-all of ``n × D`` a rank). The
    backward sends each rank's row gradients to the columns' owners (an
    all-to-all of ``n × D`` f32) and adds them into the shard's gradient,
    ranks in order, divided by W. The table itself never moves."""

    @staticmethod
    def forward(ctx, shard, ids):
        ctx.mesh, ctx.stored, ctx.vocab = sh.current_mesh(), shard.dtype, shard.shape[0]
        w, r, n, cols = world(), sh._mesh_rank(), ids.numel(), shard.shape[1]
        nbytes = n * w * cols * shard.element_size()
        if shard.device.type == "meta":
            _count("all-gather", n * 8)
            _count("all-to-all", nbytes)
            ctx.save_for_backward(torch.empty((w, n), dtype=torch.int64, device="meta"))
            return torch.empty((n, w * cols), dtype=shard.dtype, device="meta")
        every = _exchange(ids.reshape(-1).long(), "all-gather", n * 8)  # [W, n]
        ctx.save_for_backward(every)
        buf = torch.zeros((w, n, w * cols), dtype=shard.dtype, device=shard.device)
        buf[:, :, r * cols:(r + 1) * cols] = shard[every]  # every rank's rows, my columns
        return sh._all_reduce(buf, kind="all-to-all", nbytes=nbytes)[r]

    @staticmethod
    def backward(ctx, g):
        (every,) = ctx.saved_tensors
        with sh.use_mesh(ctx.mesh):
            w, r = world(), sh._mesh_rank()
            n, cols = g.shape[0], g.shape[1] // w
            if g.device.type == "meta":
                _count("all-to-all", g.numel() * 4)
                grad = torch.empty((ctx.vocab, cols), dtype=torch.float32, device="meta")
            else:
                rows = _exchange(g.float(), "all-to-all", g.numel() * 4)  # [W, n, D]
                mine = rows[:, :, r * cols:(r + 1) * cols].reshape(w * n, cols)
                grad = torch.zeros((ctx.vocab, cols), dtype=torch.float32, device=g.device)
                grad.index_put_((every.reshape(-1),), mine, accumulate=True)
            return (grad / w).to(ctx.stored), None


def lookup(cfg, table: torch.Tensor, placement, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (rows ``[*ids.shape, D]`` in the table's dtype) from
    this rank's shard of the table. A table sharded on its columns moves
    whichever is smaller: the rows the ranks look up (the all-to-all of
    :class:`_Lookup`) where a rank looks up fewer rows than the table has,
    else the table (:func:`gather`, as stored); a whole table, or one
    rank's, is indexed directly. The ranks look up as many ids each, so
    they all take the same branch."""
    d = batch_dim(placement)
    if d is None or world() == 1:
        return table[ids.long()]
    if d != table.ndim - 1:
        raise ValueError(f"a table sharded on dimension {d}: lookup takes one sharded on its "
                         "columns")
    if ids.numel() >= table.shape[0]:
        return gather(cfg, table, placement, dtype=table.dtype)[ids.long()]
    return _Lookup.apply(table, ids.reshape(-1)).reshape(*ids.shape, -1)


def gather_tree(cfg, tree: dict, places: dict) -> dict:
    """:func:`gather` over a (layer's) tree and its placement tree."""
    return _map(lambda leaf, p: gather(cfg, leaf, p), tree, places)
