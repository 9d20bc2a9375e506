"""Collective communication API (port of
``paddle1_tpu/distributed/collective.py``: ``ReduceOp``, ``Group``,
``new_group``, ``get_group``, ``is_initialized``,
``destroy_process_group``, ``all_reduce``, ``broadcast``, ``all_gather``,
``reduce``, ``barrier``, ``get_rank``, ``get_world_size``).

The JAX package runs one process for all devices, and a collective is a
named-axis operation inside an SPMD trace. The port runs one process per
rank, so a collective is a ``torch.distributed`` call on the group's
process group: NCCL on the card, gloo on the CPU
(``parallel.init_parallel_env`` picks). The semantics are the
reference's:

* ``all_reduce``, ``broadcast`` and ``reduce`` update their tensor in
  place and return it; ``reduce`` leaves every rank but ``dst`` with its
  input, as the reference's all-reduce-and-mask does; ``broadcast``'s
  ``src`` and ``reduce``'s ``dst`` are ranks IN the group;
* ``AVG`` is the SUM divided by the group's size, on every backend;
* where no process group exists, a group of one rank is the identity, as
  the reference's eager world-size-1 collectives are
  (``collective.py:234``); a group of more ranks raises.

:func:`differentiable_all_reduce` is the SUM all-reduce as an autograd
function whose backward all-reduces the cotangent with SUM, the
"psum <-> psum" rule of the reference.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.errors import (InvalidArgumentError, PreconditionNotMetError)
from . import env

__all__ = ["ReduceOp", "Group", "new_group", "get_group",
           "destroy_process_group", "is_initialized", "all_reduce",
           "all_gather", "reduce", "broadcast", "barrier", "get_rank",
           "get_world_size", "differentiable_all_reduce"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A communicator group: this process's rank in it (-1 when not a
    member), its size, its id, the global ranks it holds, and its
    ``torch.distributed`` process group (None where none exists)."""

    def __init__(self, rank: int, nranks: int, gid: int = 0,
                 ranks: Optional[List[int]] = None, process_group=None):
        self.rank = rank
        self.nranks = nranks
        self.id = gid
        self.ranks = ranks if ranks is not None else list(range(nranks))
        self.process_group = process_group

    @property
    def world_size(self) -> int:
        return self.nranks

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(rank={self.rank}, nranks={self.nranks}, "
                f"id={self.id})")


_group_lock = threading.Lock()
_group_map: Dict[int, Group] = {}
_next_gid = [1]


def is_initialized() -> bool:
    return dist.is_initialized()


def _get_default_group() -> Group:
    if dist.is_initialized():
        ws = dist.get_world_size()
        return Group(dist.get_rank(), ws, gid=0, ranks=list(range(ws)),
                     process_group=dist.group.WORLD)
    ws = env.get_world_size()
    return Group(env.get_rank(), ws, gid=0, ranks=list(range(ws)))


def destroy_process_group(group: Optional[Group] = None) -> None:
    with _group_lock:
        if group is None:
            _group_map.clear()
            if dist.is_initialized():
                dist.destroy_process_group()
            return
        _group_map.pop(group.id, None)
    if group.process_group is not None and dist.is_initialized():
        dist.destroy_process_group(group.process_group)


def new_group(ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None) -> Group:
    """A group over ``ranks`` (default: every rank). With a process group
    initialized this is a collective call: every rank of the default
    group makes it, members or not."""
    with _group_lock:
        gid = _next_gid[0]
        _next_gid[0] += 1
    me = get_rank()
    ranks = sorted(ranks) if ranks is not None else \
        list(range(get_world_size()))
    grank = ranks.index(me) if me in ranks else -1
    pg = None
    if dist.is_initialized():
        pg = dist.new_group(ranks=ranks, backend=backend)
        if grank < 0:
            pg = None
    g = Group(grank, len(ranks), gid=gid, ranks=ranks, process_group=pg)
    with _group_lock:
        _group_map[gid] = g
    return g


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _get_default_group()
    with _group_lock:
        if gid not in _group_map:
            raise PreconditionNotMetError(f"Group {gid} not created")
        return _group_map[gid]


def get_rank(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.rank
    return dist.get_rank() if dist.is_initialized() else env.get_rank()


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() \
        else env.get_world_size()


def _active(group: Optional[Group]) -> Optional[Group]:
    """The group a collective runs on, or None when it is the identity:
    this rank is not a member, or no process group exists and the group
    has one rank."""
    g = group if group is not None else _get_default_group()
    if g.rank < 0:
        return None
    if g.process_group is None:
        if g.nranks > 1:
            raise PreconditionNotMetError(
                f"a collective over {g.nranks} ranks needs a process "
                "group: call distributed.init_parallel_env() first")
        return None
    return g


# ---------------------------------------------------------------------------
# collectives


def all_reduce(tensor: torch.Tensor, op: int = ReduceOp.SUM,
               group: Optional[Group] = None,
               sync_op: bool = True) -> torch.Tensor:
    """In-place all-reduce over the group; returns ``tensor``. The host
    does not wait for it (the collective is ordered on the card's stream
    like any kernel); ``sync_op`` is accepted for the API."""
    g = _active(group)
    if g is None:
        return tensor
    if op == ReduceOp.AVG:
        if not tensor.is_floating_point():
            raise InvalidArgumentError(
                f"all_reduce AVG needs a floating tensor, got {tensor.dtype}")
        dist.all_reduce(tensor, dist.ReduceOp.SUM, group=g.process_group)
        return tensor.div_(g.nranks)
    if op not in _TORCH_OPS:
        raise InvalidArgumentError(f"unknown ReduceOp {op!r}")
    dist.all_reduce(tensor, _TORCH_OPS[op], group=g.process_group)
    return tensor


def reduce(tensor: torch.Tensor, dst: int = 0, op: int = ReduceOp.SUM,
           group: Optional[Group] = None,
           sync_op: bool = True) -> torch.Tensor:
    """Reduce to group rank ``dst``: it receives the reduction, every
    other rank keeps its input (the reference's all-reduce and mask)."""
    g = _active(group)
    if g is None:
        return tensor
    red = all_reduce(tensor.clone(), op, g)
    if g.rank == dst:
        tensor.copy_(red)
    return tensor


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[Group] = None,
              sync_op: bool = True) -> torch.Tensor:
    """In-place broadcast from group rank ``src``; returns ``tensor``."""
    g = _active(group)
    if g is None:
        return tensor
    if not 0 <= src < g.nranks:
        raise InvalidArgumentError(
            f"broadcast src {src} is not a rank of {g}")
    dist.broadcast(tensor, src=g.ranks[src], group=g.process_group)
    return tensor


def all_gather(tensor_list: Optional[List[torch.Tensor]],
               tensor: torch.Tensor, group: Optional[Group] = None,
               sync_op: bool = True) -> torch.Tensor:
    """Every rank's ``tensor``, in group-rank order: appended to
    ``tensor_list`` (when given) and returned stacked ``[nranks, ...]``."""
    g = _active(group)
    if g is None:
        parts = [tensor]
    else:
        parts = [torch.empty_like(tensor, memory_format=torch.contiguous_format)
                 for _ in range(g.nranks)]
        dist.all_gather(parts, tensor.contiguous(), group=g.process_group)
    if tensor_list is not None:
        tensor_list.extend(parts)
    return torch.stack(parts)


def barrier(group: Optional[Group] = None) -> None:
    g = _active(group)
    if g is not None:
        dist.barrier(group=g.process_group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, dist.ReduceOp.SUM, group=group.process_group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, dist.ReduceOp.SUM, group=ctx.group.process_group)
        return g, None


def differentiable_all_reduce(x: torch.Tensor,
                              group: Optional[Group] = None) -> torch.Tensor:
    """``SUM`` over the group of ``x``, out of place and differentiable:
    the backward all-reduces the cotangent with ``SUM`` (the gradient of
    a sum over ranks, each rank's loss depending on every rank's ``x``).
    One collective each way. The identity where :func:`all_reduce` is."""
    g = _active(group)
    if g is None:
        return x
    return _AllReduceSum.apply(x, g)
