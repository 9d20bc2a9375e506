"""Collective communication API (port of
``paddle1_tpu/distributed/collective.py``, its whole ``__all__``:
``ReduceOp``, ``Group``, ``new_group``, ``get_group``, ``is_initialized``,
``destroy_process_group``, ``all_reduce``, ``broadcast``, ``all_gather``,
``all_gather_object``, ``reduce``, ``reduce_scatter``, ``scatter``,
``alltoall``/``all_to_all``, ``send``/``recv``, ``isend``/``irecv``,
``wait``, ``barrier``, ``get_rank``, ``get_world_size``, ``split``,
``hierarchical_all_reduce`` and the Megatron pairs ``_c_identity``,
``_mp_allreduce``, ``_c_concat``, ``_c_split``).

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
"psum <-> psum" rule of the reference. The Megatron pairs are autograd
functions over the model-parallel group (the ``mp`` binding of
``env.spmd_axes``, else the hybrid group's, else the identity):
``_c_identity`` is the identity forward and a SUM all-reduce backward
(Megatron's f), ``_mp_allreduce`` the SUM all-reduce forward and the
identity backward (g), ``_c_concat`` gathers the last dimension forward
and takes this rank's slice backward, ``_c_split`` the converse.

Gloo takes CUDA tensors in every collective here (probed on the H100's
torch by ``tools/torch_hybrid_phases.py --gloo-probe``: all-reduce,
broadcast, all-gather, reduce-scatter, the single-tensor all-gather,
all-to-all, also with uneven splits, and scatter), so two ranks can
share one card over gloo, as ``chip_smoke.py``'s cross-rank checks run
them; NCCL takes one rank a card. Nothing is staged through host memory.
Gloo does not move CUDA tensors point to point: its TCP transport is
handed the device pointer (the probe: ``send``/``recv`` and
``batch_isend_irecv`` fail with ``writev ... Bad address``,
``isend``/``irecv`` abort the process), so :func:`send`, :func:`recv`,
:func:`isend` and :func:`irecv` of a device tensor over gloo raise
``UnavailableError`` before any transfer, and the pipeline's and the
sequence ring's handoffs are :func:`shift`, a collective.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.errors import (InvalidArgumentError, PreconditionNotMetError,
                           UnavailableError)
from . import env

__all__ = ["ReduceOp", "Group", "new_group", "get_group",
           "destroy_process_group", "is_initialized", "all_reduce",
           "all_gather", "reduce", "broadcast", "barrier", "get_rank",
           "get_world_size", "differentiable_all_reduce",
           "all_gather_object", "reduce_scatter", "scatter", "alltoall",
           "all_to_all", "send", "recv", "isend", "irecv", "wait", "split",
           "hierarchical_all_reduce", "all_gather_into", "shift", "exchange",
           "broadcast_bytes", "axis_group", "_c_identity",
           "_mp_allreduce",
           "_c_concat", "_c_split"]


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
    member), its size, its id, the global ranks it holds, the mesh axis
    it spans (``axis``, as the JAX package's; None for a free rank list)
    and its ``torch.distributed`` process group (None where none
    exists)."""

    def __init__(self, rank: int, nranks: int, gid: int = 0,
                 ranks: Optional[List[int]] = None, process_group=None,
                 axis: Optional[str] = None):
        self.rank = rank
        self.nranks = nranks
        self.id = gid
        self.ranks = ranks if ranks is not None else list(range(nranks))
        self.process_group = process_group
        self.axis = axis

    @property
    def world_size(self) -> int:
        return self.nranks

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(rank={self.rank}, nranks={self.nranks}, "
                f"id={self.id}, axis={self.axis!r})")


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
    if group.process_group is not None and dist.is_initialized() and \
            group.process_group is not dist.group.WORLD:
        dist.destroy_process_group(group.process_group)


def new_group(ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None,
              axis: Optional[str] = None) -> Group:
    """A group over ``ranks`` (default: every rank), spanning the mesh
    axis ``axis`` where given. With a process group initialized, a group
    of every rank runs on the default process group, one of fewer ranks
    but more than one is a new process group (a collective call: every
    rank of the default group makes it, members or not), and one of a
    single rank in a larger world has none (its collectives are the
    identity)."""
    with _group_lock:
        gid = _next_gid[0]
        _next_gid[0] += 1
    me = get_rank()
    ranks = sorted(ranks) if ranks is not None else \
        list(range(get_world_size()))
    grank = ranks.index(me) if me in ranks else -1
    pg = None
    if dist.is_initialized():
        if ranks == list(range(dist.get_world_size())):
            pg = dist.group.WORLD
        elif len(ranks) > 1:
            pg = dist.new_group(ranks=ranks, backend=backend)
            if grank < 0:
                pg = None
    g = Group(grank, len(ranks), gid=gid, ranks=ranks, process_group=pg,
              axis=axis)
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


# ---------------------------------------------------------------------------
# the rest of the collectives


def _reduce_scatter_fn():
    """torch's single-tensor reduce-scatter (renamed
    ``reduce_scatter_single`` in newer torch, ``reduce_scatter_tensor``
    before)."""
    return getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor


def _all_gather_fn():
    """torch's single-tensor all-gather (``all_gather_single``, else
    ``all_gather_into_tensor``)."""
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


def _reduce_op(op: int):
    if op == ReduceOp.AVG:
        return dist.ReduceOp.SUM
    if op not in _TORCH_OPS:
        raise InvalidArgumentError(f"unknown ReduceOp {op!r}")
    return _TORCH_OPS[op]


def all_gather_object(object_list: list, obj: Any,
                      group: Optional[Group] = None) -> None:
    """Every rank's picklable ``obj``, in group-rank order, appended to
    ``object_list``."""
    g = _active(group)
    if g is None:
        object_list.append(obj)
        return
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.process_group)
    object_list.extend(out)


def reduce_scatter(tensor: torch.Tensor, tensor_or_tensor_list,
                   op: int = ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op: bool = True) -> torch.Tensor:
    """Reduce over the group and keep this rank's chunk, written into
    ``tensor`` (returned). The input is ``[n * chunk, ...]`` or a list of
    n chunks; chunk i goes to group rank i. ``AVG`` divides the SUM by
    the group's size."""
    src = torch.cat(list(tensor_or_tensor_list)) \
        if isinstance(tensor_or_tensor_list, (list, tuple)) \
        else tensor_or_tensor_list
    g = _active(group)
    if g is None:
        return tensor.copy_(src.reshape(tensor.shape))
    if src.shape[0] != g.nranks * tensor.shape[0]:
        raise InvalidArgumentError(
            f"reduce_scatter: input of {src.shape[0]} rows is not "
            f"{g.nranks} x the output's {tensor.shape[0]}")
    out = tensor if tensor.is_contiguous() else tensor.contiguous()
    _reduce_scatter_fn()(out, src.contiguous(), _reduce_op(op),
                         group=g.process_group)
    if out is not tensor:
        tensor.copy_(out)
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return tensor


def all_gather_into(out: torch.Tensor, shard: torch.Tensor,
                    group: Optional[Group] = None) -> torch.Tensor:
    """Every rank's ``shard`` concatenated along dim 0 into ``out``
    (``[n * rows, ...]``), in group-rank order: one collective, the
    inverse of :func:`reduce_scatter` (the ZeRO engine gathers its
    parameters with it)."""
    g = _active(group)
    if g is None:
        if out.data_ptr() != shard.data_ptr():
            out.copy_(shard.reshape(out.shape))
        return out
    _all_gather_fn()(out, shard.contiguous(), group=g.process_group)
    return out


def scatter(tensor: torch.Tensor,
            tensor_list: Optional[List[torch.Tensor]] = None,
            src: int = 0, group: Optional[Group] = None,
            sync_op: bool = True) -> torch.Tensor:
    """Group rank ``src``'s ``tensor_list[i]`` into group rank i's
    ``tensor`` (returned). Only ``src`` needs the list; without a group
    the first entry is the result (the JAX package's eager form)."""
    g = _active(group)
    if g is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    if not 0 <= src < g.nranks:
        raise InvalidArgumentError(f"scatter src {src} is not a rank of {g}")
    parts = None
    if g.rank == src:
        if not tensor_list or len(tensor_list) != g.nranks:
            raise InvalidArgumentError(
                f"scatter: src needs {g.nranks} tensors, got "
                f"{0 if not tensor_list else len(tensor_list)}")
        parts = [t.contiguous() for t in tensor_list]
    out = tensor if tensor.is_contiguous() else tensor.contiguous()
    dist.scatter(out, parts, src=g.ranks[src], group=g.process_group)
    if out is not tensor:
        tensor.copy_(out)
    return tensor


def alltoall(in_tensor_list, out_tensor_list: Optional[list] = None,
             group: Optional[Group] = None, sync_op: bool = True):
    """All-to-all: ``in_tensor_list[j]`` (a list of n tensors, or a tensor
    whose leading dimension is n) goes to group rank j; returns what every
    rank sent this one, stacked ``[n, ...]`` in group-rank order, and
    appends its parts to ``out_tensor_list`` when given."""
    ins = list(in_tensor_list) if isinstance(in_tensor_list, (list, tuple)) \
        else list(torch.unbind(in_tensor_list, 0))
    g = _active(group)
    if g is None:
        outs = ins
    else:
        if len(ins) != g.nranks:
            raise InvalidArgumentError(
                f"alltoall: {len(ins)} inputs for a group of {g.nranks}")
        ins = [t.contiguous() for t in ins]
        outs = [torch.empty_like(t) for t in ins]
        dist.all_to_all(outs, ins, group=g.process_group)
    if out_tensor_list is not None:
        out_tensor_list.extend(outs)
    return torch.stack(outs)


all_to_all = alltoall


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view (no copy)."""
    return t.reshape(-1).view(torch.uint8)


def _all_to_all_bytes(out: torch.Tensor, inp: torch.Tensor, g: Group,
                      out_splits=None, in_splits=None) -> None:
    """``dist.all_to_all_single`` over the bytes of ``out`` and ``inp``
    (both contiguous): any dtype moves, and gloo takes it on CUDA tensors
    where it refuses point-to-point transfers of them
    (``tools/torch_hybrid_phases.py --gloo-probe``). Splits count bytes;
    None cuts both evenly over the group."""
    dist.all_to_all_single(_as_bytes(out), _as_bytes(inp), out_splits,
                           in_splits, group=g.process_group)


def exchange(x: torch.Tensor, group: Optional[Group] = None
             ) -> torch.Tensor:
    """Row i of ``x`` (``[n, ...]``, n the group's size) to group rank i;
    row j of the result is what rank j sent this rank (one all-to-all
    over the bytes). Without a process group (one rank) it returns
    ``x``."""
    g = _active(group)
    if g is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    _all_to_all_bytes(out, x, g)
    return out


def shift(send: Optional[torch.Tensor], recv: torch.Tensor,
          offset: int = 1, group: Optional[Group] = None) -> torch.Tensor:
    """One step of a permutation by ``offset`` over the group (the JAX
    ``lax.ppermute`` of ``i -> i + offset``): group rank r's ``send``
    goes to rank ``(r + offset) % n`` and ``recv`` (filled and returned)
    receives from rank ``(r - offset) % n``. A rank passes None where it
    sends nothing this time; every rank of the group calls
    it (with an empty ``recv`` where it receives nothing). It is one
    all-to-all over the tensors' bytes whose splits move nothing else
    (:func:`_all_to_all_bytes`). Without a process group (one rank)
    ``recv`` takes ``send``."""
    g = _active(group)
    if g is None:
        if send is not None:
            recv.copy_(send)
        return recv
    n, r = g.nranks, g.rank
    out_splits, in_splits = [0] * n, [0] * n
    src = recv.new_empty(0, dtype=torch.uint8)
    if send is not None:
        src = send.contiguous()
        in_splits[(r + offset) % n] = src.numel() * src.element_size()
    buf = recv if recv.is_contiguous() else recv.contiguous()
    out_splits[(r - offset) % n] = buf.numel() * buf.element_size()
    _all_to_all_bytes(buf, src, g, out_splits, in_splits)
    if buf is not recv:
        recv.copy_(buf)
    return recv


def broadcast_bytes(tensor: torch.Tensor, src: int = 0,
                    group: Optional[Group] = None) -> torch.Tensor:
    """:func:`broadcast` over the tensor's bytes (any dtype, every
    backend); ``tensor`` must be contiguous. Returns it."""
    if not tensor.is_contiguous():
        raise InvalidArgumentError("broadcast_bytes needs a contiguous "
                                   "tensor")
    broadcast(_as_bytes(tensor), src, group)
    return tensor


def _p2p_group(group, peer: int, what: str,
               tensor: torch.Tensor) -> Group:
    g = _active(group)
    if g is None:
        raise PreconditionNotMetError(
            f"{what} needs a peer: a process group of more than one rank "
            "(distributed.init_parallel_env)")
    if not 0 <= peer < g.nranks or peer == g.rank:
        raise InvalidArgumentError(f"{what}: peer {peer} is not another "
                                   f"rank of {g}")
    if tensor.device.type != "cpu" and g.process_group.name() == "gloo":
        raise UnavailableError(
            f"{what}: gloo moves only CPU tensors point to point (its TCP "
            f"transport would be handed the {tensor.device.type} tensor's "
            "device pointer); use NCCL, a CPU tensor, or a collective "
            "such as distributed.collective.shift")
    return g


def send(tensor: torch.Tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True) -> None:
    """Send ``tensor`` to group rank ``dst`` (blocking)."""
    g = _p2p_group(group, dst, "send", tensor)
    dist.send(tensor.contiguous(), dst=g.ranks[dst], group=g.process_group)


def recv(tensor: torch.Tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True) -> torch.Tensor:
    """Receive into ``tensor`` (returned) from group rank ``src``."""
    g = _p2p_group(group, src, "recv", tensor)
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()
    dist.recv(buf, src=g.ranks[src], group=g.process_group)
    return tensor if buf is tensor else tensor.copy_(buf)


class _Work:
    """A started point-to-point transfer: ``wait()`` blocks until it is
    done (and, for a receive into a strided tensor, copies it there)."""

    def __init__(self, work, finish=None):
        self._work, self._finish = work, finish

    def wait(self):
        self._work.wait()
        if self._finish is not None:
            self._finish()
            self._finish = None
        return True

    def is_completed(self) -> bool:
        return self._work.is_completed()


def isend(tensor: torch.Tensor, dst: int = 0,
          group: Optional[Group] = None) -> _Work:
    """Start sending ``tensor`` to group rank ``dst``."""
    g = _p2p_group(group, dst, "isend", tensor)
    return _Work(dist.isend(tensor.contiguous(), dst=g.ranks[dst],
                            group=g.process_group))


def irecv(tensor: torch.Tensor, src: int = 0,
          group: Optional[Group] = None) -> _Work:
    """Start receiving into ``tensor`` from group rank ``src``; the data
    is there after ``wait()``."""
    g = _p2p_group(group, src, "irecv", tensor)
    if not tensor.is_contiguous():
        buf = tensor.contiguous()
        return _Work(dist.irecv(buf, src=g.ranks[src],
                                group=g.process_group),
                     lambda: tensor.copy_(buf))
    return _Work(dist.irecv(tensor, src=g.ranks[src],
                            group=g.process_group))


def wait(tensor: torch.Tensor, group: Optional[Group] = None,
         use_calc_stream: bool = True) -> None:
    """Stream ordering (the reference's ``c_wait_comm``): the port's
    collectives are ordered with the card's compute by torch itself, so
    there is nothing to wait for, as in the JAX package."""
    return None


# ---------------------------------------------------------------------------
# the Megatron pairs (reference collective.py:732-813)


def _mp_group(group) -> Optional[Group]:
    """The model-parallel group a Megatron pair runs over, or None (the
    identity): ``group``, else the ``mp`` binding of ``env.spmd_axes``,
    else the hybrid group's, when it has more than one rank."""
    if group is None:
        group = env.current_spmd_axis("mp")
    if group is None:
        from .topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        group = hcg.get_model_parallel_group() if hcg is not None else None
    if group is None or group.nranks == 1:
        return None
    return _active(group)


def _sum(x: torch.Tensor, g: Group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, dist.ReduceOp.SUM, group=g.process_group)
    return y


def _gather_last(x: torch.Tensor, g: Group) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(g.nranks)]
    dist.all_gather(parts, x.contiguous(), group=g.process_group)
    return torch.cat(parts, dim=-1)


def _slice_last(x: torch.Tensor, g: Group) -> torch.Tensor:
    n = x.shape[-1]
    if n % g.nranks:
        raise InvalidArgumentError(
            f"c_split: last dim {n} not divisible by the model-parallel "
            f"group's {g.nranks} ranks")
    k = n // g.nranks
    return x[..., g.rank * k:(g.rank + 1) * k].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.g), None


class _AllReduceFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _sum(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _gather_last(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _slice_last(dy, ctx.g), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _slice_last(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _gather_last(dy, ctx.g), None


def _c_identity(tensor: torch.Tensor, group: Optional[Group] = None,
                skip_c_identity_dynamic: bool = False) -> torch.Tensor:
    """Megatron's f: the identity forward, the SUM all-reduce of the
    gradient over the model-parallel group backward."""
    g = _mp_group(group)
    return tensor if g is None else _Identity.apply(tensor, g)


def _mp_allreduce(tensor: torch.Tensor,
                  group: Optional[Group] = None) -> torch.Tensor:
    """Megatron's g: the SUM all-reduce forward, the identity backward."""
    g = _mp_group(group)
    return tensor if g is None else _AllReduceFwd.apply(tensor, g)


def _c_concat(tensor: torch.Tensor,
              group: Optional[Group] = None) -> torch.Tensor:
    """Gather the last dimension over the model-parallel group (a
    column-parallel output); backward takes this rank's slice."""
    g = _mp_group(group)
    return tensor if g is None else _Concat.apply(tensor, g)


def _c_split(tensor: torch.Tensor,
             group: Optional[Group] = None) -> torch.Tensor:
    """This rank's slice of the last dimension (a row-parallel input);
    backward gathers the gradient."""
    g = _mp_group(group)
    return tensor if g is None else _Split.apply(tensor, g)


def split(x, num_or_sections, axis=0, group=None):
    """``paddle.distributed.split``: only the even split of the last
    dimension over the model-parallel group (``_c_split``), as in the JAX
    package; anything else raises rather than mis-slicing."""
    ndim = x.dim()
    if axis not in (-1, ndim - 1):
        raise InvalidArgumentError(
            "distributed.split only splits the last dim over mp "
            "(c_split); for other layouts use meta_parallel's "
            "ColumnParallelLinear/RowParallelLinear")
    n = group.nranks if group is not None else (
        (_mp_group(None) or Group(0, 1)).nranks)
    if isinstance(num_or_sections, int) and num_or_sections not in (n, -1):
        raise InvalidArgumentError(
            f"split num_or_sections={num_or_sections} must equal the "
            f"group size {n}")
    return _c_split(x, group)


def axis_group(axis_name: str, group: Optional[Group] = None
               ) -> Optional[Group]:
    """The group a named-axis function runs over: ``group`` where given,
    else the group bound to ``axis_name`` by ``env.spmd_axes``, else the
    hybrid group's along that axis (``sep`` names ``sp``), else None (a
    single rank: the identity)."""
    if group is not None:
        return group
    g = env.current_spmd_axis(axis_name)
    if g is not None:
        return g
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None
    return hcg.mesh.groups.get(hcg.axis_name(axis_name))


def _axis_group(g):
    """A group given as a ``Group`` or as an axis name of the hybrid
    group's mesh."""
    if isinstance(g, Group) or g is None:
        return g
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise PreconditionNotMetError(
            f"axis {g!r} names no group: build the hybrid group first "
            "(fleet.init or topology.HybridCommunicateGroup)")
    return hcg.mesh.groups[hcg.axis_name(g)]


def hierarchical_all_reduce(x: torch.Tensor, intra_axis, inter_axis
                            ) -> torch.Tensor:
    """Two-level SUM all-reduce (the reference's hierarchical_allreduce):
    reduce-scatter over ``intra_axis`` so each rank owns 1/n of ``x``,
    all-reduce the shards over ``inter_axis``, all-gather back over
    ``intra_axis``; where dim 0 does not divide over the intra group, the
    flat all-reduce over both. The axes are groups, or axis names of the
    hybrid group's mesh. Returns a new tensor."""
    intra, inter = _axis_group(intra_axis), _axis_group(inter_axis)
    gi = _active(intra) if intra is not None else None
    n = gi.nranks if gi is not None else 1
    if x.dim() >= 1 and x.shape[0] % n == 0 and n > 1:
        shard = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device)
        reduce_scatter(shard, x.contiguous(), ReduceOp.SUM, intra)
        all_reduce(shard, ReduceOp.SUM, inter)
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        return all_gather_into(out, shard, intra)
    y = x.detach().clone()
    all_reduce(y, ReduceOp.SUM, intra)
    return all_reduce(y, ReduceOp.SUM, inter)
