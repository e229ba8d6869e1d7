"""The collectives of data-parallel steps: what GSPMD inserts into the
JAX package's sharded step, written out.

A step under ``with mesh:`` (:class:`~stil_tta_torch.parallel.mesh.Mesh`)
draws its views for the global batch on every rank from generators that
are in step, so the single-process stream is reproduced. The net's
forward then runs through :func:`sharded`: each rank takes its rows of
each segment of the global batch (``[labelled; unlabelled]``), runs the
forward on them, and the outputs are gathered back to the global batch in
the single-process order. The targets, losses, buffers and metrics after
it run on the global batch on every rank alike, so every rank computes
the same global loss; the gather's backward therefore keeps the rank's
slice and sums nothing, and :func:`all_reduce_grads` sums the
parameters' gradients over the ranks once, before the optimizer step
(``train/optim.py:step``). Every rank ends the step with the same state.

Inside the sharded forward the operations that couple rows see the
global batch: train-mode BatchNorm all-reduces its kernel sums
(``ops/batch_norm.py:BNTrain``), the int8 activation scale takes the
global max (:func:`global_max`), SAINT's intersample attention attends
over every rank's rows (:func:`gather_rows` with ``summed``: each rank's
rows get the gradients of every rank's queries), and dropout masks are
drawn for the global shape and cut to the rank's rows
(:func:`uniform_rows`).

Each all-reduce and all-gather runs inside a profiler range named
``dp.all_reduce`` or ``dp.all_gather``, so a profile of a step reads the
host time spent in collectives, the waits included.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from stil_tta_torch.parallel.mesh import Mesh, rank_rows

Tensor = torch.Tensor

_mesh: Optional[Mesh] = None      # the mesh of the running ``with mesh:``
_shard: Optional["Shard"] = None  # set while a sharded forward runs


def enter(mesh: Mesh) -> None:
    global _mesh
    if _mesh is not None:
        raise RuntimeError("a mesh is active already: meshes do not nest")
    _mesh = mesh


def leave(mesh: Mesh) -> None:
    global _mesh
    if _mesh is not mesh:
        raise RuntimeError("left a mesh that is not the active one")
    _mesh = None


def active_mesh() -> Optional[Mesh]:
    """The mesh of the running ``with mesh:``, or None."""
    return _mesh


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """A sharded forward's rows: ``index`` holds the global positions of
    the rank's rows in their local order, ``order`` takes the rows of
    the ranks' outputs stacked in rank order to the global order, and
    ``rows`` counts the global batch."""

    mesh: Mesh
    index: Tensor
    order: Tensor
    rows: int


def active_shard() -> Optional[Shard]:
    """The shard of the sharded forward running now, or None."""
    return _shard


def _shard_of(mesh: Mesh, segments: Sequence[int], device) -> Shard:
    """The rank's rows of a global batch made of ``segments``: its share
    of each segment in turn (``[l_r; u_r]`` of ``[l; u]``)."""
    starts = [sum(segments[:i]) for i in range(len(segments))]

    def index(rank: int) -> Tensor:
        return torch.cat([start + rank_rows(n, rank, mesh.size)
                          for start, n in zip(starts, segments)])

    stacked = torch.cat([index(r) for r in range(mesh.size)])
    return Shard(mesh, index(mesh.rank).to(device),
                 torch.argsort(stacked).to(device), int(sum(segments)))


def all_reduce(mesh: Mesh, t: Tensor, op=dist.ReduceOp.SUM) -> Tensor:
    """``t`` reduced over every rank of ``mesh`` (its groups in turn), in
    place; ``t`` must be contiguous."""
    with torch.profiler.record_function("dp.all_reduce"):
        for group in mesh.groups:
            dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(mesh: Mesh, t: Tensor, dim: int) -> Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    with torch.profiler.record_function("dp.all_gather"):
        dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim)


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows of ``x`` along ``dim``, in the global
    order. Backward: the rank's rows of the gradient; with ``summed``,
    of the gradient summed over the ranks first (when each rank's
    downstream reads only its own rows)."""

    @staticmethod
    def forward(ctx, x: Tensor, shard: Shard, dim: int, summed: bool):
        ctx.shard, ctx.dim, ctx.summed = shard, dim, summed
        return _all_gather(shard.mesh, x, dim).index_select(dim, shard.order)

    @staticmethod
    def backward(ctx, g: Tensor):
        if ctx.summed:
            g = all_reduce(ctx.shard.mesh, g.contiguous().clone())
        return g.index_select(ctx.dim, ctx.shard.index), None, None, None


def gather_rows(x: Tensor, shard: Shard, dim: int = 0,
                summed: bool = False) -> Tensor:
    """The global batch of ``x``, whose ``dim`` holds the rank's rows of
    ``shard`` (see :class:`_GatherRows`)."""
    if x.shape[dim] != shard.index.numel():
        raise ValueError(f"gather_rows: {x.shape[dim]} rows along dim "
                         f"{dim}, the shard has {shard.index.numel()}")
    return _GatherRows.apply(x, shard, dim, summed)


def _map(fn: Callable[[Tensor], Tensor], out):
    if isinstance(out, Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {k: _map(fn, v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_map(fn, v) for v in out)
    if out is None:
        return None
    raise TypeError(f"sharded: cannot gather a {type(out).__name__}")


def sharded(fn: Callable, segments: Sequence[int], *args,
            local: bool = False, **kwargs):
    """``fn(*args, **kwargs)`` with the global-batch semantics: outside a
    mesh, the call itself. Under a mesh, the tensors of ``args`` (each
    holding the ``sum(segments)`` rows of the global batch along its first
    axis) are cut to the rank's rows of each segment, ``fn`` runs on them
    with the shard active, and every tensor of its output (a tensor, or
    dicts, tuples and lists of them) is gathered back to the global
    batch. With ``local`` the tensors hold the rank's rows already (cut
    on the host by :func:`rank_index`). ``kwargs`` and the other ``args``
    pass as they are. Raises ``ValueError`` when the mesh's size does not
    divide a segment."""
    global _shard
    mesh = active_mesh()
    if mesh is None:
        return fn(*args, **kwargs)
    if _shard is not None:
        raise RuntimeError("sharded: a sharded forward is running already")
    tensors = [a for a in args if isinstance(a, Tensor)]
    if not tensors:
        raise ValueError("sharded: no tensor to cut into rows")
    shard = _shard_of(mesh, segments, tensors[0].device)
    rows = shard.index.numel() if local else shard.rows
    for a in tensors:
        if a.shape[0] != rows:
            raise ValueError(f"sharded: an input of {a.shape[0]} rows, "
                             f"{rows} expected")
    if not local:
        args = [a.index_select(0, shard.index) if isinstance(a, Tensor)
                else a for a in args]
    _shard = shard
    try:
        out = fn(*args, **kwargs)
    finally:
        _shard = None
    return _map(lambda t: gather_rows(t, shard), out)


def rank_index(mesh: Mesh, segments: Sequence[int]) -> Tensor:
    """The positions, on the CPU, of ``mesh``'s rank's rows of a global
    batch made of ``segments``: what :func:`sharded` cuts."""
    return _shard_of(mesh, segments, "cpu").index


def global_max(t: Tensor) -> Tensor:
    """The max of ``t`` over the ranks of the running sharded forward
    (``t`` itself outside one)."""
    if _shard is None:
        return t
    return all_reduce(_shard.mesh, t.contiguous().clone(),
                      dist.ReduceOp.MAX)


def uniform_rows(shape: Sequence[int], row_dim: int, device) -> Tensor:
    """Uniform [0, 1) draws of ``shape`` from the device's default
    generator. In a sharded forward, whose ``row_dim`` holds the rank's
    rows, they are the rank's rows of one draw for the global batch, so
    every layout draws the masks of the single process."""
    if _shard is None:
        return torch.rand(tuple(shape), device=device)
    if shape[row_dim] != _shard.index.numel():
        raise ValueError(f"uniform_rows: {shape[row_dim]} rows along dim "
                         f"{row_dim}, the shard has {_shard.index.numel()}")
    full = list(shape)
    full[row_dim] = _shard.rows
    return torch.rand(full, device=device).index_select(row_dim,
                                                        _shard.index)


@torch.no_grad()
def all_reduce_grads(mesh: Mesh, params: Sequence[Tensor]) -> None:
    """Sum the gradients of ``params`` over the ranks, in place: one
    all-reduce for each gradient dtype, of the gradients flattened."""
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        all_reduce(mesh, flat)
        for g, v in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(v)
