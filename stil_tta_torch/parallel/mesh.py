"""Data parallelism over ``torch.distributed``, the port of
``stil_tta_tpu/parallel/mesh.py``.

The JAX package shards the batch over a ``Mesh(('data',))`` and lets
GSPMD insert the collectives; a sharded step equals the unsharded step
at the same global batch. Here every rank is one process, a
:class:`Mesh` names the ranks' layout and the process groups its
reductions run over, and a step run inside ``with mesh:`` keeps the
global-batch semantics by the collectives of
:mod:`stil_tta_torch.parallel.collectives`: each rank runs the net's
forward on its rows of the global batch, and everything after it on the
gathered global batch.

Process groups: gloo for CPU tensors; NCCL where each rank has a card of
its own; gloo on CUDA tensors where several ranks of a node share a card
(NCCL refuses two ranks on one device). A group that fails to form raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


def backend_for(device_type: str, local_ranks: int, cards: int) -> str:
    """The process group's backend: NCCL on ``cuda`` when the
    ``local_ranks`` ranks on this node have a card of their own among its
    ``cards``, else gloo (CPU tensors, or ranks sharing a card, which NCCL
    refuses). The count is per node: on several nodes every rank may have
    a card of its own although the world outnumbers one node's cards."""
    if device_type == "cuda" and local_ranks <= cards:
        return "nccl"
    return "gloo"


def init_process_group(device: str = "cuda", rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       address: Optional[str] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    ``rank``, ``world_size`` and ``address`` (``tcp://host:port``) default
    to what ``python -m torch.distributed.run`` sets (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``). On ``cuda`` a rank
    takes card ``LOCAL_RANK`` (else its rank) modulo the cards it sees;
    the backend is :func:`backend_for` of the ranks on this node
    (``LOCAL_WORLD_SIZE``, else the whole world)."""
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = (int(os.environ["WORLD_SIZE"]) if world_size is None
             else int(world_size))
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count < 1:
            raise RuntimeError("init_process_group: no CUDA card")
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    else:
        count = 0
    backend = backend_for(dev.type,
                          int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                          count)
    dist.init_process_group(backend, init_method=address or "env://",
                            rank=rank, world_size=world)
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks' layout for data parallelism: ``shape`` is ``(n,)`` or
    ``(dcn, ici)``, rank ``r`` at the row-major position ``r``, so the
    batch axis runs over the flattened (dcn, ici) order. ``groups``
    are the stages a sum over the batch runs through, innermost axis
    first (within an ICI group, then across DCN); ``group`` holds every
    rank, for the gathers.

    Inside ``with mesh:`` the train steps, the BatchNorms, the int8
    activation scale, SAINT's intersample attention, the dropout masks,
    :class:`~stil_tta_torch.serve.Predictor` and the optimizer step take
    the global-batch semantics
    (:mod:`stil_tta_torch.parallel.collectives`)."""

    shape: Tuple[int, ...]
    groups: Tuple[object, ...]
    group: object
    rank: int

    @property
    def size(self) -> int:
        return int(torch.Size(self.shape).numel())

    def __enter__(self) -> "Mesh":
        from stil_tta_torch.parallel import collectives
        collectives.enter(self)
        return self

    def __exit__(self, *exc) -> None:
        from stil_tta_torch.parallel import collectives
        collectives.leave(self)


def _world() -> Tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group "
                           "first")
    return dist.get_rank(), dist.get_world_size()


def create_mesh(n_ranks: Optional[int] = None) -> Mesh:
    """A 1-axis mesh over every rank of the default group (``n_ranks``,
    if given, must be its size)."""
    rank, world = _world()
    if n_ranks is not None and int(n_ranks) != world:
        raise ValueError(f"create_mesh({n_ranks}): the process group has "
                         f"{world} ranks")
    group = dist.group.WORLD
    return Mesh((world,), (group,), group, rank)


def create_hybrid_mesh(ici_size: int, dcn_size: int) -> Mesh:
    """A ``(dcn_size, ici_size)`` mesh: rank ``d * ici_size + i`` at
    (d, i). A sum over the batch runs within each ICI group (the ranks of
    one d) and then across DCN (the ranks of one i), as XLA lowers the
    multi-slice gradient reduction; every rank calls this with the same
    sizes."""
    rank, world = _world()
    if ici_size * dcn_size != world:
        raise ValueError(f"create_hybrid_mesh({ici_size}, {dcn_size}): the "
                         f"process group has {world} ranks")
    mine = {}
    # every rank creates every group, in one order
    for d in range(dcn_size):
        members = [d * ici_size + i for i in range(ici_size)]
        g = dist.new_group(members)
        if rank in members:
            mine["ici"] = g
    for i in range(ici_size):
        members = [d * ici_size + i for d in range(dcn_size)]
        g = dist.new_group(members)
        if rank in members:
            mine["dcn"] = g
    return Mesh((dcn_size, ici_size), (mine["ici"], mine["dcn"]),
                dist.group.WORLD, rank)


def rank_rows(n: int, rank: int, size: int) -> torch.Tensor:
    """The positions, in order, of rank ``rank``'s rows of a global batch
    of ``n`` rows over ``size`` ranks: its equal, contiguous share. Raises
    ``ValueError`` when ``size`` does not divide ``n``, as a sharded
    leading axis must divide. A micro-batched step cuts the global batch
    into chunks first, and each chunk's forward takes the rank's share of
    that chunk."""
    if n % size:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{size} ranks")
    per = n // size
    return torch.arange(per) + rank * per


@torch.no_grad()
def replicate(mesh: Mesh, module: nn.Module) -> None:
    """Make ``module``'s parameters and buffers on every rank a copy of
    rank 0's, in place."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
