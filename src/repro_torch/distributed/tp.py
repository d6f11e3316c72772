"""The collectives of the model axis: tensor and sequence parallelism over
the mesh's ``"model"`` dimension, Megatron-style.

The reference lets GSPMD insert these from the layouts of
``repro.distributed.params`` and the ``shard(...)`` constraints of its
models; the port's layers (``models.transformer``, ``models.moe``) call
them where the layout changes:

* :func:`gather_seq`: the residual stream, split on the sequence between
  layers, gathered whole before a column-parallel product (an all-gather;
  its backward adds the M ranks' gradients and keeps this rank's part, a
  reduce-scatter);
* :func:`scatter_sum`: the partial products of a row-parallel product
  added over the ranks, this rank keeping its part of the sequence (a
  reduce-scatter; its backward an all-gather), and :func:`all_sum`, the
  same with the whole result on every rank (an all-reduce; its backward
  an all-reduce);
* :func:`all_to_all`: the MoE's exchange of capacity buffers and of
  expert weights (its backward the exchange back);
* :func:`all_max` (no gradient), the vocab-parallel loss's row max.

Every backward is its forward's adjoint, so a rank's gradient is the
gradient of the sum of the ranks' losses; the train step weights each
rank's loss by 1/M and adds the gradients of the leaves whole over
``"model"`` over the ranks (``train.train_step``).

As ``distributed.fsdp``'s, each collective is ``all_reduce`` over the model
group, exact where it moves data (a zero-filled ``[M, ...]`` buffer with one
non-zero term an entry), its sums taken in f32 in rank order, so a given M
gives the same bits from run to run and gloo ranks can share a card. A sum
of row-parallel partials in a lower precision is added in f32 and rounded
once. The calls are counted in ``sharding.COLLECTIVE_COUNTS`` by the dry
run's operand convention: an all-gather by the rank's shard, a
reduce-scatter, an all-reduce and an all-to-all by the rank's operand, each
in its dtype. On the meta device each makes the tensor a native collective
would and moves nothing. The mesh is captured where a function runs, so a
backward on the autograd engine's thread (a CUDA backward) finds it.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as sh

__all__ = ["active", "all_max", "all_sum", "all_to_all", "gather_seq", "model_rank",
           "model_size", "scatter_sum"]

_AXES = (sh.MODEL,)


def model_size() -> int:
    return sh.axis_size(sh.MODEL)


def model_rank() -> int:
    return sh.group_rank(_AXES)


def active() -> bool:
    """True on a mesh whose ``"model"`` dimension has more than one rank."""
    return model_size() > 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``t`` put together along ``dim`` in rank order."""
    return fsdp._all_gather(t.contiguous(), dim, _AXES)


def _sum(t: torch.Tensor, kind: str, dtype) -> torch.Tensor:
    """Every rank's ``t`` added in f32 in rank order, rounded to ``dtype``."""
    if t.device.type == "meta":
        fsdp._count(kind, _nbytes(t))
        return torch.empty(t.shape, dtype=dtype, device="meta")
    parts = fsdp._exchange(t.contiguous(), kind, _nbytes(t), _AXES)
    acc = parts[0].float()
    for r in range(1, parts.shape[0]):
        acc = acc + parts[r].float()
    return acc.to(dtype)


def _part(t: torch.Tensor, dim: int) -> torch.Tensor:
    n = t.shape[dim] // model_size()
    return t.narrow(dim, model_rank() * n, n)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.mesh = dim, sh.current_mesh()
        return _gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        with sh.use_mesh(ctx.mesh):
            if g.device.type == "meta":
                fsdp._count("reduce-scatter", _nbytes(g))
                return _part(g, ctx.dim).clone(), None
            return _part(_sum(g, "reduce-scatter", g.dtype), ctx.dim).contiguous(), None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, dtype):
        ctx.dim, ctx.mesh, ctx.dtype = dim, sh.current_mesh(), x.dtype
        if x.device.type == "meta":
            fsdp._count("reduce-scatter", _nbytes(x))
            return torch.empty(_part(x, dim).shape, dtype=dtype, device="meta")
        return _part(_sum(x, "reduce-scatter", dtype), dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        with sh.use_mesh(ctx.mesh):
            return _gather(g, ctx.dim).to(ctx.dtype), None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.mesh, ctx.dtype = sh.current_mesh(), x.dtype
        return _sum(x, "all-reduce", dtype)

    @staticmethod
    def backward(ctx, g):
        with sh.use_mesh(ctx.mesh):
            return _sum(g, "all-reduce", ctx.dtype), None


def _exchange_all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``x [M, ...]`` (part j for rank j) → ``[M, ...]`` (part i from rank
    i), the rank's send buffer counted."""
    m, r = model_size(), model_rank()
    if x.device.type == "meta":
        fsdp._count("all-to-all", _nbytes(x))
        return torch.empty_like(x)
    buf = torch.zeros((m, *x.shape), dtype=x.dtype, device=x.device)  # [src, dst, ...]
    buf[r] = x
    return sh._all_reduce(buf, kind="all-to-all", nbytes=_nbytes(x), axes=_AXES)[:, r].clone()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh = sh.current_mesh()
        return _exchange_all_to_all(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        with sh.use_mesh(ctx.mesh):
            return _exchange_all_to_all(g.contiguous())


def gather_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The ranks' parts of ``x`` put together along ``dim`` (the sequence
    of the residual stream, the heads of a product, a weight's model
    shard); differentiable."""
    return _GatherSeq.apply(x, dim)


def scatter_sum(x: torch.Tensor, dim: int = 1, dtype=None) -> torch.Tensor:
    """The ranks' ``x`` added (in f32, rank order), this rank's part along
    ``dim`` kept, in ``dtype`` (default ``x``'s); differentiable."""
    return _ScatterSum.apply(x, dim, dtype or x.dtype)


def all_sum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The ranks' ``x`` added (in f32, rank order), whole on every rank, in
    ``dtype`` (default ``x``'s); differentiable."""
    return _AllSum.apply(x, dtype or x.dtype)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``x [M, ...]``, part ``j`` sent to rank ``j``; returns ``[M, ...]``,
    part ``i`` from rank ``i``; differentiable."""
    if x.shape[0] != model_size():
        raise ValueError(f"an all-to-all over {model_size()} ranks of a [{x.shape[0]}, ...] buffer")
    return _AllToAll.apply(x)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of the ranks' ``x`` (no gradient: a shift)."""
    x = x.detach()
    if x.device.type == "meta":
        fsdp._count("all-reduce", _nbytes(x))
        return x.clone()
    return sh._all_reduce(x.clone(), op="max", axes=_AXES)
