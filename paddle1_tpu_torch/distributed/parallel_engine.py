"""Training engine (port of ``ParallelEngine`` and ``make_train_step``
from ``paddle1_tpu/distributed/parallel_engine.py``): one device, or a
hybrid mesh of data, ZeRO-sharded and tensor-parallel ranks.

``ParallelEngine(model, optimizer, loss_fn, ...).step(batch)`` runs one
optimizer step: forward and backward of ``loss_fn(model, batch)``, then
``optimizer.apply``. It returns a :class:`LossFuture` (the loss stays on
the device until read) and counts ``dispatch_count``; ``trace_count``
counts the batch shape signatures seen (a new one is what makes the JAX
engine compile again), and ``cache_stats()`` reports both as hits and
misses.

* Tied parameters (BERT's MLM decoder is the word embedding) appear once
  in ``model.named_parameters()``; autograd sums both gradient paths into
  the one leaf, so the tied weight gets ONE update, as the JAX engine's
  dedupe gives (``parallel_engine.py:439-449``).
* ``amp_dtype="bfloat16"`` (or ``"float16"``) is the JAX package's
  pure-16-bit mode (``parallel_engine.py:221-235``), not
  ``torch.autocast``: each step casts the floating parameters and float
  feeds to that dtype, runs forward and backward in it through
  ``torch.func.functional_call``, casts the loss to f32, and the
  optimizer updates the f32 masters (the model's own parameters) from the
  gradients cast to f32. As in the JAX engine, float16 gets no loss
  scaler here.
* Gradients land in persistent buffers in the masters' dtype, allocated
  once (on a mesh: views of one flat buffer), so the fused optimizer's
  table of pointers is built once.
* Floating buffers (batch norm's ``_mean``/``_variance``) are leaves of
  the step like the parameters, as the JAX engine threads its whole
  state through the step (``parallel_engine.py:425-431``): under
  ``amp_dtype`` they are cast with the parameters, so a given-statistics
  forward normalizes with 16-bit-rounded running statistics; they are
  differentiated and handed to the optimizer with the parameters (so
  frozen statistics, ``use_global_stats=True``, move with their
  gradient, as the JAX engine's ``functional_update`` moves them). Batch
  norms in training mode record their f32 batch statistics
  (``nn.functional.norm.collect_stat_updates``), and after the optimizer
  update each recorded buffer becomes ``m * old + (1 - m) * batch`` from
  its value before the step (``parallel_engine.py:328-343``), once per
  micro-batch in order under ``grad_accum``.

The step's controls, in the JAX engine's order (``make_train_step``):

* ``grad_accum=n``: every batch leaf is ``[n, micro, ...]``; the n
  micro-batches run forward and backward in turn, their gradients summed
  in the f32 buffers and divided by n, the loss their mean.
* ``check_finite=True``: a non-finite loss or raw gradient (before the
  clip) makes the step a no-op on the device: parameters, optimizer
  slots, the device step counter and the running statistics keep their
  values, selected with ``torch.where`` against a copy taken before the
  update (:func:`snapshot_`, :func:`keep_where_`), with no host sync. The
  step returns a :class:`StepFuture` over ``[loss, notfinite]``.
* ``clip_global_norm=c``: every gradient is scaled by
  ``min(1, c / (||g|| + 1e-6))``, the norm over all of them in f32
  (``parallel_engine.py:317-323``).
* ``recompute=True`` sets ``enable_recompute`` on every
  ``TransformerEncoder`` of the model (per-block rematerialization), and
  warns when there is none.

``step_many(batches)`` runs k steps and returns one future over the
``[k]`` losses, the LR schedule advancing k times: the same steps as k
``step`` calls, bit for bit (the JAX engine scans them in one
executable; here they are k steps in a row). ``step_stream`` feeds an
iterable through ``step_many`` in chunks of ``train_steps_per_sync`` and
a short tail through ``step``. At most ``inflight_window`` steps run
ahead of the host: a step waits (without a readback) for the one
``inflight_window`` back. An ``LRScheduler`` given to the optimizer is
stepped once per optimizer step.

With ``mesh=build_mesh(...)`` (or ``degrees={...}``) each rank
(a process, after ``init_parallel_env``) runs the step on its part of the
global batch and holds its part of the model, and the step computes what
the JAX engine's computes on the same mesh, where GSPMD places every
collective (``parallel_engine.py:597-670, 768-809``). Here the engine
places them itself, explicitly, at every mesh:

* at construction global rank 0 broadcasts the parameters and floating
  buffers (a tensor-parallel layer's shards: the first data rank of each
  model-parallel rank);
* :meth:`shard_batch` cuts a global batch into this rank's part over the
  data ranks (``dp`` x ``sharding``, as the JAX ``shard_batch`` cuts over
  ``("dp", "sharding")``; the ``mp``, ``pp`` and ``sp`` ranks of a data
  rank see the same rows), or over the data axes ``batch_spec``'s first
  entry names (the JAX form). A batch that does not divide raises
  (``benches.py:106-108``); under ``grad_accum`` the cut is along the
  micro-batch axis;
* a ``batch_spec`` whose second entry is ``sp``
  (``data_partition_spec(("dp", "sharding"), seq_axis="sp")``) cuts the
  sequence over the ``sp`` ranks, as GSPMD partitions it for the JAX
  engine (``parallel_engine.py:610-665``), and the step computes world
  size 1's. The host does not cut the sequence: every ``sp`` rank gets
  the whole rows (the embeddings, the pooler, the masked-position gather
  and the heads need them), and a leaf of two or more axes whose second
  does not divide over ``sp`` raises, where ``jax.device_put`` raises.
  Inside the step (the ``sp`` binding of ``env.spmd_axes``) every
  ``TransformerEncoder`` runs its blocks on this rank's contiguous slice
  of the sequence, self-attention as Ulysses over the ``sp`` ranks on the
  flash kernels with the whole key-padding mask, and gathers the output
  before the final norm and the heads (``nn/layer_transformer.py``). The
  blocks' gradients are summed over ``sp`` (each rank saw its slice); the
  embeddings', pooler's and heads' are not, being equal on every ``sp``
  rank. At ``pp > 1`` such a spec raises (ROADMAP.md Queue 1 item
  5(iv-c)). A spec that cuts another later axis, or the batch over an
  axis that is not a data axis, raises;
* ``pp > 1``: every ``TransformerEncoder`` is tagged with the ``pp``
  group and ``pp_microbatches`` (default pp; ``parallel_engine.py:
  412-437``), and each rank keeps only its stage's ``num_layers // pp``
  blocks (their parameters, gradients and slots; the other blocks'
  places hold ``BlockElsewhere``), after rank 0's whole model was
  broadcast. Inside the step (the ``pp`` binding of ``env.spmd_axes``)
  the encoder runs its blocks as a pipeline over the ``pp`` ranks
  (``distributed/pipeline.py``: GPipe's ticks, the JAX scan's numbers);
  the embeddings and heads stay on every rank, and run there on the same
  inputs, so their gradients are the same on every rank and are not
  reduced over ``pp`` (the input's gradient is broadcast from stage 0).
  Dropout inside a block draws from its stage rank's generator;
* ``sp > 1`` with the batch replicated over ``sp`` (no sequence entry in
  ``batch_spec``; the JAX engine's cut, ``parallel_engine.py:636-638``):
  each ``sp`` rank computes world size 1's step, and
  ``sequence_parallel``'s attention functions cut the sequence when a
  model calls them;
* ``mp > 1``: every tensor ``text.models.apply_megatron_sharding``
  tagged is cut to this rank's model-parallel shard, and the layers that
  hold them run with Megatron's f/g pairs
  (``meta_parallel.shard_tagged_layers``: column-, row- and
  vocabulary-parallel ``Linear``/``Embedding``, BERT's tied decoder
  gathering its logits); attention runs on this rank's heads;
* the forward runs under the data group's ``dp`` binding
  (``env.spmd_axes``), so every training-mode batch norm normalizes with
  the global batch's statistics (one differentiable all-reduce per batch
  norm each way). This holds at world size 1 too;
* the trained tensors fall into **units**: each ``TransformerEncoderLayer``
  is one (at ``pp > 1`` a stage's blocks together are one, since the
  pipeline binds them all at once through ``functional_call``), and every
  tensor outside the blocks (embeddings with the tied decoder, pooler,
  heads, final norms) forms the root unit;
* at ``sharding == 1`` (every ZeRO stage is then the identity) or
  ``zero_stage=0`` (the ``sharding`` axis then only carries data) the
  gradients land in one flat f32 buffer laid out unit by unit (the
  persistent gradient buffers are views into it) and are averaged over
  the data ranks in ONE all-reduce that carries the loss too; every rank
  applies the same update;
* ``sharding = n > 1`` with ``zero_stage`` 1-3: each unit's masters are
  views of one flat f32 buffer padded to a multiple of n x 64 elements,
  and sharding rank r owns the r-th contiguous cut of EACH unit: its
  optimizer slots (1/n of them, the cut running through tensors: each
  piece of a tensor keeps its tensor's name, decay, rate and
  regularizer, so row 6's one launch a step holds partial tensors) and
  its update. The backward hands each unit's gradient over as soon as it
  is complete (a hook on every leaf after its gradient accumulated; the
  root unit, whose tied embedding takes the MLM decoder's gradient too,
  completes last). Stage 1 keeps the whole gradient and all-reduces it a
  unit at a time over the data ranks; stages 2-3 all-reduce the unit's
  gradient over ``dp``, reduce-scatter it over ``sharding`` into the
  rank's shard (each micro-batch adding into it under ``grad_accum``)
  and free it, so no whole-model gradient exists. After the update
  (row 6 over the rank's pieces) stages 1-2 all-gather each unit's
  parameters. Stage 3 keeps only the shards at rest: the root unit is
  gathered for the step, a block's unit before its forward (freed after
  it) and again before its backward (a hook on the block's output; freed
  when its gradient is complete), into the same storage, so what autograd
  saved sees the gathered values; under ``amp_dtype`` the 16-bit leaves
  are gathered, a unit at a time, after the cast. :meth:`sync_model`,
  :meth:`full_state_dict` and :meth:`full_grad_dict` gather the whole
  model for use outside the step;
* ``clip_global_norm`` and ``check_finite`` read the whole gradient: the
  sums over shards are all-reduced over ``sharding``, ``mp`` and ``pp``,
  a tensor replicated over ``mp`` or the stages counted once;
* the running statistics blend the global statistics, the same on every
  rank.

A ZeRO shard's optimizer is a shallow copy of ``optimizer`` over the
pieces (``shard_optimizer``); ``optimizer`` keeps the learning rate and
its schedule. An optimizer ``grad_clip`` under ZeRO or ``mp`` raises: use
``clip_global_norm``. ``donate`` is accepted and changes nothing: the
port updates parameters and slots in place. :meth:`full_state_dict`,
:meth:`full_grad_dict` and :meth:`sync_model` gather the shards and the
stages. :meth:`save_checkpoint` writes each rank's shards of the masters and of
the slots (``distributed/checkpoint.py``: one file a rank and an index
of every piece by tensor name and element range), and
:meth:`load_checkpoint` restores into the engine's current mesh, ZeRO
degree and stage included, then :meth:`sync_model`.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.async_loss import LossFuture, StepFuture
from ..core.errors import InvalidArgumentError, UnimplementedError
from ..nn.functional.norm import collect_stat_updates
from . import collective, env
from .topology import Mesh, build_mesh

__all__ = ["ParallelEngine", "ShardedBatch", "snapshot_", "keep_where_",
           "make_train_step"]

_AMP = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_ALIGN = 64          # elements: each gradient view starts 256 B aligned


class ShardedBatch:
    """A batch already cut to this rank's shard and placed on its device
    (:meth:`ParallelEngine.shard_batch`); ``step`` feeds it as it is."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data


class _LossModule(nn.Module):
    """``loss_fn(model, batch)`` as a module, so
    ``torch.func.functional_call`` can swap the model's parameters."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.m = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.m, batch)


def _axes(t) -> tuple:
    """A tensor's ``sharding_axes`` as a tuple (empty where it has none)."""
    return tuple(getattr(t, "sharding_axes", None) or ())


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def _micro_batches(feed, n: int) -> list:
    """The ``n`` micro-batches of a feed whose leaves are ``[n, ...]``
    (the feed itself at ``n == 1``)."""
    return [feed] if n == 1 else \
        [_map(lambda a, i=i: a[i], feed) for i in range(n)]


def _blend(old: torch.Tensor, stats, m: float) -> torch.Tensor:
    """A running statistic after the step: ``m * cur + (1 - m) * stat``
    from its value before the step, once per micro-batch in order."""
    cur = old
    for stat in stats:
        cur = m * cur + (1 - m) * stat
    return cur


_DATA_AXES = ("dp", "sharding")


def _spec_names(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    if isinstance(entry, (tuple, list)) and \
            all(isinstance(a, str) for a in entry):
        return tuple(entry)
    raise InvalidArgumentError(
        f"batch_spec entry {entry!r} must be None, a mesh axis name or a "
        "tuple of names")


def _batch_cut_axes(spec, mesh) -> tuple:
    """``(lead, seq)``: the mesh axes a batch leaf's leading axis is cut
    over, outermost first, and whether the second axis (the sequence) is
    cut over ``sp``. ``batch_spec`` is the JAX form (one entry a
    dimension, each None, an axis name or a tuple of names); by default
    the batch is cut over ``("dp", "sharding")``, the JAX engine's
    (``parallel_engine.py:636-638``; replicated over ``mp``, ``pp`` and
    ``sp``). A spec that cuts a later axis other than the sequence over
    ``sp``, or cuts the batch over an axis that is not a data axis, raises
    ``UnimplementedError``; one that cuts the sequence at ``pp > 1``
    (ROADMAP.md Queue 1 item 5(iv-c)) too."""
    if spec is None:
        return _DATA_AXES, False
    entries = list(spec) if isinstance(spec, (tuple, list)) else [spec]
    parsed = [_spec_names(e) for e in entries]
    for a in (a for names in parsed for a in names):
        if a not in Mesh.axis_names:
            raise InvalidArgumentError(
                f"batch_spec {spec!r}: {a!r} is not a mesh axis "
                f"{Mesh.axis_names}")
    seq = parsed[1] if len(parsed) > 1 else ()
    if seq not in ((), ("sp",)) or any(parsed[2:]):
        raise UnimplementedError(
            f"ParallelEngine: batch_spec {spec!r} cuts a later axis than "
            "the sequence's, or the sequence over another axis than sp; "
            "the port cuts the batch over the data axes and the sequence "
            "over sp")
    lead = parsed[0] if parsed else ()
    other = [a for a in lead if a not in _DATA_AXES]
    if other or len(set(lead)) != len(lead):
        raise UnimplementedError(
            f"ParallelEngine: batch_spec {spec!r} cuts the batch over "
            f"{list(lead)}; the port cuts it over the data axes dp and "
            "sharding, each once, and the sequence over sp")
    if seq and mesh is not None and mesh.shape["pp"] > 1 and \
            mesh.shape["sp"] > 1:
        raise UnimplementedError(
            f"ParallelEngine: batch_spec {spec!r} cuts the sequence over "
            "sp at pp > 1; the pipelined encoder does not cut the "
            "sequence yet (ROADMAP.md Queue 1 item 5(iv-c))")
    return lead, bool(seq)


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every gradient, in f32."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(grads), 2)).float())


def _clip_scale(norm: torch.Tensor, c: float) -> torch.Tensor:
    """``clip_global_norm``'s factor ``min(1, c / (||g|| + 1e-6))``."""
    return torch.clamp(c / (norm + 1e-6), max=1.0)


def _all_finite(loss: torch.Tensor,
                grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Device bool: the loss and every gradient are finite (a sum of |g|
    is finite exactly when each term is, short of overflowing f32's
    3.4e38)."""
    return torch.isfinite(loss) & torch.isfinite(
        torch.stack(torch._foreach_norm(list(grads), 1))).all()


def _signature(batch) -> tuple:
    """The structure, shapes and dtypes of a fed batch."""
    if isinstance(batch, dict):
        return ("dict",) + tuple((k, _signature(v))
                                 for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return (type(batch).__name__,) + tuple(_signature(v) for v in batch)
    return (tuple(getattr(batch, "shape", ())),
            str(getattr(batch, "dtype", type(batch).__name__)))


@torch.no_grad()
def snapshot_(backup: Sequence[torch.Tensor],
              state: Sequence[torch.Tensor]) -> None:
    """Copy ``state`` into ``backup`` (``check_finite``'s copy of the
    parameters, slots and running statistics before the update)."""
    torch._foreach_copy_(list(backup), list(state))


@torch.no_grad()
def keep_where_(state: Sequence[torch.Tensor],
                backup: Sequence[torch.Tensor],
                finite: torch.Tensor) -> None:
    """``state = finite ? state : backup``, in place, on the device: a
    non-finite step leaves every tensor bit for bit as it was."""
    for t, b in zip(state, backup):
        torch.where(finite, t, b, out=t)


class _Unit:
    """One ZeRO unit of a rank (:meth:`ParallelEngine._init_zero`): the
    block module (None for the root unit and a pp stage's blocks), the
    masters' indices, whether it holds encoder blocks, their offsets in
    the unit's flat buffer of ``n`` elements, this rank's cut ``[lo,
    hi)`` of ``size`` elements, the
    buffers (parameters ``pflat`` and its write alias ``raw``, the shard
    ``pshard``, under stage-3 ``amp_dtype`` the 16-bit ``cflat``/``craw``
    and the leaves' views ``cviews``; the gradient ``gflat`` at stage 1 and
    the shard ``gshard``), and the backward's bookkeeping (the gradient
    being assembled, the leaves still to come, which have come)."""

    def __init__(self, module, idx, block, offs, n, shards, rank):
        self.module, self.idx, self.block = module, idx, block
        self.offs, self.n = offs, n
        self.size = n // shards
        self.lo, self.hi = rank * self.size, (rank + 1) * self.size
        self.pflat = self.raw = self.pshard = None
        self.cflat = self.craw = self.cviews = None
        self.gflat = self.gshard = self.gbuf = None
        self.pending, self.seen = 0, []
        self.gathered = False


class ParallelEngine:
    """One-device or hybrid-parallel trainer. ``optimizer`` is one of this
    package's optimizers over the model's parameters (or built with
    ``parameters=None``, then it adopts them); ``loss_fn(model, batch)``
    returns a scalar tensor. ``batch``: a dict, list or tuple of numpy
    arrays or tensors, moved to the parameters' device each step. The
    parameters are the JAX engine's, in its order (see the module
    docstring for each)."""

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable,
                 mesh: Optional[Mesh] = None,
                 degrees: Optional[Dict[str, int]] = None,
                 zero_stage: int = 0, grad_accum: int = 1,
                 clip_global_norm: Optional[float] = None,
                 batch_spec: Optional[Any] = None,
                 donate: Optional[bool] = None,
                 amp_dtype: Optional[str] = None,
                 recompute: bool = False,
                 pp_microbatches: Optional[int] = None,
                 train_steps_per_sync: int = 1,
                 inflight_window: int = 2,
                 check_finite: bool = False):
        if amp_dtype is not None and amp_dtype not in _AMP:
            raise InvalidArgumentError(
                f"amp_dtype must be None or one of {sorted(_AMP)}, got "
                f"{amp_dtype!r}")
        if zero_stage not in (0, 1, 2, 3):
            raise InvalidArgumentError(
                f"zero_stage must be 0, 1, 2 or 3, got {zero_stage!r}")
        if int(grad_accum) != grad_accum or grad_accum < 1:
            raise InvalidArgumentError(
                f"grad_accum must be an int >= 1, got {grad_accum!r}")
        if mesh is None and degrees is not None:
            mesh = build_mesh(**degrees)
        self.batch_spec = batch_spec
        self._cut_axes, seq_cut = _batch_cut_axes(batch_spec, mesh)
        # the sequence group (a batch_spec that cuts the sequence over sp)
        self._sp = mesh.groups["sp"] if seq_cut and mesh is not None and \
            mesh.shape["sp"] > 1 else None
        self.model = model
        self.mesh = mesh
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.amp_dtype = _AMP.get(amp_dtype)
        self.zero_stage = zero_stage
        self.grad_accum = int(grad_accum)
        self.clip_global_norm = None if clip_global_norm is None else \
            float(clip_global_norm)
        self.check_finite = bool(check_finite)
        self.train_steps_per_sync = max(int(train_steps_per_sync), 1)
        self.inflight_window = max(int(inflight_window), 1)
        self._inflight: collections.deque = collections.deque()
        if recompute:
            self._flip_recompute(model)
        self._pp = None          # the pipeline group (pp > 1)
        self._tag_pipeline(pp_microbatches)
        if mesh is not None:
            self._broadcast_model()
            if self._pp is not None:
                self._cut_stages()
        named = list(model.named_parameters())   # a tied weight once
        if not named:
            raise InvalidArgumentError("ParallelEngine: model has no "
                                       "parameters")
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        ids = {id(p) for p in self.params}
        if not optimizer._params:
            optimizer._params = list(self.params)
            optimizer._names = list(self.names)
        elif not {id(p) for p in optimizer._params} <= ids:
            raise InvalidArgumentError(
                "ParallelEngine: the optimizer holds parameters that are "
                "not the model's")
        optimizer.rename({id(p): n for n, p in named})
        self.device = self.params[0].device
        self._train = [p for p in self.params if p.requires_grad and
                       p.is_floating_point()]
        bufs = [(n, b) for n, b in model.named_buffers()
                if b.is_floating_point()]
        self.buffer_names: List[str] = [n for n, _ in bufs]
        self.buffers: List[torch.Tensor] = [b for _, b in bufs]
        self._param_ids = {id(p) for p in self.params}
        train = {id(p) for p in self._train}
        self._diff_keys = ["m." + n for n, p in zip(self.names, self.params)
                           if id(p) in train] + \
            ["m." + n for n in self.buffer_names]
        self._wrapper = _LossModule(model, loss_fn)
        self.dispatch_count = 0
        self.trace_count = 0
        self._seen_sigs: Dict[str, set] = {}
        self._backup: Optional[List[torch.Tensor]] = None
        self._flat = None
        self._zero = None        # the ZeRO shard's state (sharding > 1)
        self._mp = None          # the model-parallel group (mp > 1)
        self._opt = optimizer    # the optimizer that runs the update
        if mesh is not None:
            self._init_mesh()
        else:
            self._grads = [torch.zeros_like(t)
                           for t in self._train + self.buffers]
            self._opt_params = self._train + self.buffers
            self._opt_grads = self._grads

    @staticmethod
    def _flip_recompute(model: nn.Module) -> None:
        from ..nn.layer_transformer import TransformerEncoder
        flipped = 0
        for sub in model.modules():
            if isinstance(sub, TransformerEncoder):
                sub.enable_recompute = True
                flipped += 1
        if not flipped:
            warnings.warn(
                "recompute=True: no recompute-capable blocks found "
                "(TransformerEncoder); wrap your own blocks with "
                "fleet.utils.recompute for per-segment remat")

    @torch.no_grad()
    def _broadcast_model(self) -> None:
        """Global rank 0's parameters and floating buffers on every rank
        (a tensor-parallel layer's shards follow in :meth:`_init_mesh`),
        before any rank drops another stage's blocks."""
        world = collective.get_group(0)
        for t in list(self.model.parameters()) + [
                b for b in self.model.buffers() if b.is_floating_point()]:
            if not getattr(t, "_mp_local", False):
                collective.broadcast(t.data, 0, world)

    def _tag_pipeline(self, pp_microbatches: Optional[int]) -> None:
        """Tag every ``TransformerEncoder`` with the ``pp`` group and the
        micro-batch count (default: pp) at ``pp > 1``, else clear the tags
        a previous engine left (``parallel_engine.py:412-437``)."""
        from ..nn.layer_transformer import TransformerEncoder
        pp = self.mesh.shape["pp"] if self.mesh is not None else 1
        encs = [m for m in self.model.modules()
                if isinstance(m, TransformerEncoder)]
        if pp > 1 and not encs:
            raise InvalidArgumentError(
                "pp degree > 1 needs a pipelined body (TransformerEncoder) "
                "in the model; for arbitrary heterogeneous stage graphs use "
                "distributed.meta_parallel.PipelineParallel (eager 1F1B "
                "schedule)")
        self._pp = self.mesh.groups["pp"] if pp > 1 else None
        for e in encs:
            e.pipeline_group = self._pp
            e.pipeline_microbatches = (pp_microbatches or pp) if pp > 1 \
                else None

    def _cut_stages(self) -> None:
        """``pp > 1``: this rank keeps its stage's blocks of every tagged
        encoder (``num_layers // pp`` of them) and puts a
        :class:`BlockElsewhere` in each other block's place, so only its
        own blocks take parameters, gradients and optimizer slots; the
        embeddings and heads stay on every rank. Records where each
        block's tensors live, for :meth:`full_state_dict`."""
        from ..nn.layer_transformer import TransformerEncoder
        g = self._pp
        self._state_keys = list(self.model.state_dict(keep_vars=True))
        self._grad_keys = [
            n for n, p in self.model.named_parameters()
            if p.requires_grad and p.is_floating_point()] + [
            n for n, b in self.model.named_buffers() if b.is_floating_point()]
        self._whole_keys = list(dict.fromkeys(self._state_keys +
                                              self._grad_keys))
        self._block_of: Dict[str, tuple] = {}
        self._stage_ids = set()
        self._encoders = []
        for name, e in self.model.named_modules():
            if not isinstance(e, TransformerEncoder):
                continue
            if e.num_layers % g.nranks:
                raise InvalidArgumentError(
                    f"pipelined encoder: {e.num_layers} blocks not "
                    f"divisible into {g.nranks} stages")
            bps = e.num_layers // g.nranks
            prefix = f"{name}.layers." if name else "layers."
            for k in self._whole_keys:
                if not k.startswith(prefix):
                    continue
                i, sub = k[len(prefix):].split(".", 1)
                i = int(i)
                own = g.rank * bps + i % bps
                self._block_of[k] = (i // bps, f"{prefix}{own}.{sub}")
            blocks = list(e.layers)
            mine = blocks[g.rank * bps:(g.rank + 1) * bps]
            self._stage_ids.update(id(t) for b in mine
                                   for t in (*b.parameters(), *b.buffers()))
            self._encoders.append((e, bps, mine))
        self._drop_stages()
        kept = {id(p) for p in self.model.parameters()}
        opt = self.optimizer
        if opt._params:
            pairs = [(p, n) for p, n in zip(opt._params, opt._names)
                     if id(p) in kept]
            opt._params = [p for p, _ in pairs]
            opt._names = [n for _, n in pairs]

    def _drop_stages(self) -> None:
        """Put a :class:`BlockElsewhere` in the place of every block
        another stage holds (again after :meth:`sync_model` gathered
        them)."""
        from ..nn.layer_transformer import BlockElsewhere
        g = self._pp
        for e, bps, _ in self._encoders:
            for i in range(e.num_layers):
                if i // bps != g.rank:
                    e.layers[i] = BlockElsewhere(i // bps)
        self._stages_whole = False

    def _stage_gather(self, local: Dict[str, torch.Tensor],
                      keys: Sequence[str]) -> Dict[str, torch.Tensor]:
        """``keys``' tensors on every rank: this rank's (``local``), and
        each block another stage holds broadcast from that stage over
        ``pp`` (a collective call, on every rank, in ``keys``' order)."""
        out = {}
        for k in keys:
            where = self._block_of.get(k)
            if where is None:
                out[k] = local[k]
                continue
            stage, own = where
            t = local[k].contiguous() if stage == self._pp.rank else \
                torch.empty_like(local[own],
                                 memory_format=torch.contiguous_format)
            out[k] = collective.broadcast_bytes(t, stage, self._pp)
        return out

    def _init_mesh(self):
        """The tensor-parallel cut (``mp > 1``) and the units; at
        ``sharding == 1`` or ``zero_stage=0`` the flat f32 gradient buffer
        laid out unit by unit (the persistent gradient buffers are views
        into it; its last element carries the loss), at ``sharding > 1``
        the ZeRO shards (:meth:`_init_zero`)."""
        m = self.mesh
        with torch.no_grad():
            if m.shape["mp"] > 1:
                from .meta_parallel.mp_layers import shard_tagged_layers
                self._mp = m.groups["mp"]
                shard_tagged_layers(self.model, self._mp)
            for t in self.params:
                if getattr(t, "_mp_local", False):
                    collective.broadcast(t.data, 0, m.data_group)
        masters = self._masters = self._train + self.buffers
        bad = [t.dtype for t in masters if t.dtype != torch.float32]
        if bad:
            raise InvalidArgumentError(
                "ParallelEngine: the mesh path reduces gradients in one f32 "
                f"buffer; the masters must be f32, got {sorted(set(bad))}")
        if (self._mp is not None or (m.shape["sharding"] > 1 and
                                     self.zero_stage >= 1)) and \
                self.optimizer._grad_clip is not None:
            raise InvalidArgumentError(
                "ParallelEngine: an optimizer grad_clip sees one shard "
                "under ZeRO or model parallelism; pass clip_global_norm= "
                "to the engine, which reads the whole gradient")
        # weight 1 on the one rank that counts a tensor in the global
        # norm, else 0: a tensor replicated over mp, or over the pp stages
        # (all but a stage's blocks' parameters and buffers), counts once
        self._norm_weight = [
            1.0 if (self._mp is None or self._mp.rank == 0 or
                    "mp" in _axes(t)) and
            (self._pp is None or self._pp.rank == 0 or
             id(t) in self._stage_ids) else 0.0 for t in masters]
        units = self._unit_lists(masters)
        shards = m.shape["sharding"] if self.zero_stage >= 1 else 1
        if shards > 1:
            self._init_zero(masters, units)
            return
        offs, n = [0] * len(masters), 0
        self._block_lo = None
        for _, idx, block in units:
            if block and self._block_lo is None:
                self._block_lo = n
            for i in idx:
                offs[i] = n
                n += -(-masters[i].nelement() // _ALIGN) * _ALIGN
        # the blocks' part of the flat buffer (the units lay the blocks out
        # last): what a sequence cut sums over sp
        self._block_hi = n
        if self._block_lo is None:
            self._block_lo = n
        self._flat = torch.zeros(n + 1, dtype=torch.float32,
                                 device=self.device)
        self._offs = offs
        self._grads = [self._flat[o:o + t.nelement()].view(t.shape)
                       for o, t in zip(offs, masters)]
        self._opt_params, self._opt_grads = masters, self._grads
        self._opt_weight = self._norm_weight

    def _unit_lists(self, masters) -> List[tuple]:
        """``(block module or None, [master index, ...], whether it holds
        encoder blocks)`` for each unit:
        the root unit (every master outside the encoder blocks) first,
        then each ``TransformerEncoderLayer`` in module order, or at ``pp
        > 1`` this stage's blocks as one unit (the pipeline binds them
        together through ``functional_call``). Empty units are left
        out."""
        from ..nn.layer_transformer import TransformerEncoderLayer
        pos = {id(t): i for i, t in enumerate(masters)}
        taken, blocks = set(), []
        for mod in self.model.modules():
            if not isinstance(mod, TransformerEncoderLayer):
                continue
            idx = sorted({pos[id(t)] for t in (*mod.parameters(),
                                               *mod.buffers())
                          if id(t) in pos} - taken)
            if idx:
                taken.update(idx)
                blocks.append((mod, idx, True))
        if self._pp is not None and blocks:
            blocks = [(None, sorted(taken), True)]
        root = [i for i in range(len(masters)) if i not in taken]
        return [u for u in [(None, root, False)] + blocks if u[1]]

    def _init_zero(self, masters, units):
        """ZeRO over the ``sharding`` group: each unit's masters become
        views of the unit's flat f32 parameter buffer (its tensors each
        aligned to 64 elements, its length padded to a multiple of n x
        64); sharding rank r owns elements ``[r * S, (r + 1) * S)`` of each
        unit, and the update runs over the pieces of the masters there
        (1-D views that keep their tensor's rate, decay and regularizer,
        named after it) with a shallow copy of the optimizer holding their
        slots. Stage 1 keeps the whole gradient (one buffer, unit by unit);
        stages 2-3 keep the gradient shards only. Stage 3 releases every
        unit's parameters at rest."""
        g = self.mesh.groups["sharding"]
        stage3 = self.zero_stage >= 3
        amp = self.amp_dtype if stage3 else None
        zunits = []
        with torch.no_grad():
            for mod, idx, block in units:
                offs, n = [], 0
                for i in idx:
                    offs.append(n)
                    n += -(-masters[i].nelement() // _ALIGN) * _ALIGN
                n = -(-n // (g.nranks * _ALIGN)) * g.nranks * _ALIGN
                u = _Unit(mod, idx, block, offs, n, g.nranks, g.rank)
                u.pflat = torch.zeros(n, dtype=torch.float32,
                                      device=self.device)
                for i, o in zip(idx, offs):
                    t = masters[i]
                    view = u.pflat[o:o + t.nelement()].view(t.shape)
                    view.copy_(t.data)
                    t.data = view
                # writes go through .data, whose version counter is its
                # own: a stage-3 re-gather under a tensor autograd saved
                # must not count as an in-place change of it
                u.raw = u.pflat.data
                u.pshard = u.pflat[u.lo:u.hi].clone() if stage3 else \
                    u.pflat[u.lo:u.hi]
                if amp is not None:
                    u.cflat = torch.empty(n, dtype=amp, device=self.device)
                    u.craw = u.cflat.data
                    u.cviews = [u.cflat[o:o + masters[i].nelement()]
                                .view(masters[i].shape)
                                for i, o in zip(idx, offs)]
                zunits.append(u)
        unit_of = {}
        for k, u in enumerate(zunits):
            for j, i in enumerate(u.idx):
                unit_of[i] = (k, j)
        if self.zero_stage == 1:
            whole = torch.zeros(sum(u.n for u in zunits), dtype=torch.float32,
                                device=self.device)
            gshard, o = None, 0
            for u in zunits:
                u.gflat = whole[o:o + u.n]
                u.gshard = u.gflat[u.lo:u.hi]
                o += u.n
        else:
            gshard = torch.zeros(sum(u.size for u in zunits),
                                 dtype=torch.float32, device=self.device)
            o = 0
            for u in zunits:
                u.gshard = gshard[o:o + u.size]
                o += u.size
        names = dict(zip(map(id, self.optimizer._params),
                         self.optimizer.param_names()))
        own = dict(zip(map(id, self.params), self.names))
        own.update(zip(map(id, self.buffers), self.buffer_names))
        pieces, gpieces, pnames, weights, where = [], [], [], [], []
        for u in zunits:
            for i, o in zip(u.idx, u.offs):
                t = masters[i]
                a, b = max(o, u.lo), min(o + t.nelement(), u.hi)
                if a >= b:
                    continue
                piece = u.pshard[a - u.lo:b - u.lo]
                for attr in ("optimize_attr", "regularizer", "need_clip"):
                    if hasattr(t, attr):
                        setattr(piece, attr, getattr(t, attr))
                pieces.append(piece)
                gpieces.append(u.gshard[a - u.lo:b - u.lo])
                pnames.append(names.get(id(t)) or own[id(t)])
                weights.append(self._norm_weight[i])
                where.append((i, a - o))
        opt = copy.copy(self.optimizer)
        opt._params, opt._names = pieces, pnames
        opt._slots, opt._step_t = {}, None
        self._opt = opt
        self._opt_params, self._opt_grads = pieces, gpieces
        self._opt_weight = weights
        self._zero = {"group": g, "units": zunits, "unit_of": unit_of,
                      "gshard": gshard, "pieces_at": where, "micro": 0,
                      "phase": None, "whole": not stage3,
                      "gathered_now": 0, "max_gathered": 0,
                      "max_unit_gathered": 0, "max_grad_buffer": 0}
        if stage3:
            for u in zunits:
                u.raw.untyped_storage().resize_(0)

    @property
    def shard_optimizer(self):
        """The optimizer that updates this rank's ZeRO shard (``optimizer``
        itself at ``sharding == 1``); it holds the slots."""
        return self._opt

    def _gather_params(self) -> None:
        """ZeRO: every unit's f32 parameters whole from the shards, for use
        outside the step (stages 1-2 after the update; stage 3 for
        :meth:`sync_model` and the state dicts, until the next step)."""
        z = self._zero
        if z["whole"]:
            return
        for u in z["units"]:
            store = u.raw.untyped_storage()
            if store.nbytes() == 0:
                store.resize_(u.n * u.raw.element_size())
            # stages 1-2 own their shard inside the buffer: gather a copy
            shard = u.pshard if self.zero_stage >= 3 else u.pshard.clone()
            collective.all_gather_into(u.raw, shard, z["group"])
        z["whole"] = True

    def _release_params(self) -> None:
        """ZeRO stage 3: keep only the shards (every unit's gathered
        parameters released)."""
        z = self._zero
        for u in z["units"]:
            self._release_unit(u)
            u.raw.untyped_storage().resize_(0)
        z["whole"] = False

    def _gather_unit(self, u) -> None:
        """ZeRO stage 3: one unit's step leaves whole (the 16-bit copy
        under ``amp_dtype``, cast before the gather), into the storage its
        leaves view."""
        if u.gathered:
            return
        z = self._zero
        raw, shard = (u.raw, u.pshard) if u.cflat is None else \
            (u.craw, u.pshard.to(self.amp_dtype))
        store = raw.untyped_storage()
        if store.nbytes() == 0:
            store.resize_(u.n * raw.element_size())
        collective.all_gather_into(raw, shard, z["group"])
        u.gathered = True
        z["gathered_now"] += u.n * raw.element_size()
        z["max_gathered"] = max(z["max_gathered"], z["gathered_now"])
        z["max_unit_gathered"] = max(z["max_unit_gathered"],
                                     u.n * raw.element_size())

    def _release_unit(self, u) -> None:
        """ZeRO stage 3: free one unit's step leaves."""
        if not u.gathered:
            return
        raw = u.raw if u.cflat is None else u.craw
        raw.untyped_storage().resize_(0)
        u.gathered = False
        self._zero["gathered_now"] -= u.n * raw.element_size()

    # -- data placement -----------------------------------------------------

    def shard_batch(self, batch: Any) -> ShardedBatch:
        """This rank's shard of a global ``batch`` (every leaf with a
        leading dim is cut into equal parts along it, along the second
        under ``grad_accum``; 0-d leaves are kept), placed on the device
        and cast as :meth:`step` feeds it. Without a mesh the shard is the
        whole batch. Raises when a leaf does not divide over the ranks,
        and under ``grad_accum=n`` when a leaf is not ``[n, ...]``."""
        if self.grad_accum > 1:
            def check(a):
                shape = tuple(np.shape(a))
                if not shape or shape[0] != self.grad_accum:
                    raise InvalidArgumentError(
                        f"grad_accum={self.grad_accum} needs every batch "
                        "leaf shaped [grad_accum, ...] (scalars too — "
                        "broadcast them to the accumulation dim or close "
                        "over them in loss_fn); got leaf with shape "
                        f"{shape}")
                return a
            _map(check, batch)
        if self.mesh is None:
            return ShardedBatch(self._feed(batch))
        n, r = 1, 0
        for a in self._cut_axes:
            n = n * self.mesh.shape[a]
            r = r * self.mesh.shape[a] + self.mesh.coords[a]
        axis = 1 if self.grad_accum > 1 else 0
        n_sp = self.mesh.shape["sp"] if self._sp is not None else 1

        def cut(a):
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
            if a.ndim > axis + 1 and a.shape[axis + 1] % n_sp:
                raise InvalidArgumentError(
                    f"ParallelEngine: a batch leaf of shape {tuple(a.shape)}"
                    f": its sequence axis of {a.shape[axis + 1]} does not "
                    f"divide over sp={n_sp}")
            if a.ndim <= axis:
                return a
            if a.shape[axis] % n:
                raise InvalidArgumentError(
                    f"ParallelEngine: a batch leaf of {a.shape[axis]} rows "
                    f"does not divide over {n} ranks")
            k = a.shape[axis] // n
            return a[r * k:(r + 1) * k] if axis == 0 else \
                a[:, r * k:(r + 1) * k]
        return ShardedBatch(self._feed(_map(cut, batch)))

    def _feed(self, batch):
        def place(a):
            # a Paddle Tensor (what io.DataLoader yields) enters the step
            # as the plain tensor it views, as numpy leaves do: a facade
            # leaf would make every op of the step re-wrap its result
            t = a.as_subclass(torch.Tensor) if isinstance(a, torch.Tensor) \
                else torch.from_numpy(np.asarray(a))
            t = t.to(self.device, non_blocking=True)
            if self.amp_dtype is not None and t.is_floating_point():
                t = t.to(self.amp_dtype)
            return t
        return _map(place, batch)

    def _leaves(self) -> Dict[str, torch.Tensor]:
        """The step's leaves: the masters' storage (f32) or a cast copy
        (amp) of every parameter and floating buffer, requiring grad
        where the master is trained and on every buffer."""
        train = {id(p) for p in self._train}
        cast = {}     # ZeRO stage 3 under amp: the units' 16-bit views
        if self._zero is not None:
            for u in self._zero["units"]:
                for i, v in zip(u.idx, u.cviews or ()):
                    cast[id(self._masters[i])] = v
        out = {}
        for n, p in zip(self.names + self.buffer_names,
                        self.params + self.buffers):
            leaf = p.detach() if id(p) not in cast else cast[id(p)].detach()
            if self.amp_dtype is not None and leaf.is_floating_point() and \
                    id(p) not in cast:
                leaf = leaf.to(self.amp_dtype)
            if id(p) in train or id(p) not in self._param_ids:
                leaf.requires_grad_(True)
            out["m." + n] = leaf
        return out

    # -- training -----------------------------------------------------------

    def _note_signature(self, kind: str, feed) -> None:
        """Count a batch shape signature not seen before for ``kind`` (the
        JAX engine traces and compiles once for each)."""
        seen = self._seen_sigs.setdefault(kind, set())
        sig = _signature(feed)
        if sig not in seen:
            seen.add(sig)
            self.trace_count += 1

    def _push_inflight(self, fut: LossFuture) -> LossFuture:
        self._inflight.append(fut)
        while len(self._inflight) > self.inflight_window:
            self._inflight.popleft().block()
        return fut

    def _step_scheduler(self) -> None:
        sched = getattr(self.optimizer, "_learning_rate", None)
        if hasattr(sched, "step"):
            sched.step()

    def step(self, batch: Any, lr: Optional[float] = None) -> LossFuture:
        """One optimizer step on ``batch`` (on a mesh: the global batch,
        or this rank's :class:`ShardedBatch`); ``lr`` overrides the
        optimizer's learning rate for this step. Returns a
        :class:`StepFuture` under ``check_finite``."""
        lr_val = lr if lr is not None else self.optimizer.get_lr()
        if not isinstance(batch, ShardedBatch):
            batch = self.shard_batch(batch)
        self._note_signature("step", batch.data)
        self.dispatch_count += 1
        out = self._run(batch.data, lr_val)
        self._step_scheduler()
        wrap = StepFuture if self.check_finite else LossFuture
        return self._push_inflight(wrap(out))

    def step_many(self, batches: Sequence[Any],
                  lr: Optional[float] = None) -> LossFuture:
        """``len(batches)`` optimizer steps in one call: one future over
        the ``[k]`` losses (``[k, 2]`` packed under ``check_finite``), the
        LR schedule advancing k times, the same steps as k :meth:`step`
        calls bit for bit."""
        k = len(batches)
        if k == 0:
            raise InvalidArgumentError("step_many needs >= 1 batch")
        if k == 1:
            return self.step(batches[0], lr)
        sharded = [b if isinstance(b, ShardedBatch) else self.shard_batch(b)
                   for b in batches]
        self._note_signature(f"step_many[k={k}]", sharded[0].data)
        lrs = []
        for _ in range(k):
            lrs.append(lr if lr is not None else self.optimizer.get_lr())
            self._step_scheduler()
        self.dispatch_count += 1
        outs = [self._run(b.data, lr_i) for b, lr_i in zip(sharded, lrs)]
        wrap = StepFuture if self.check_finite else LossFuture
        return self._push_inflight(wrap(torch.stack(outs)))

    def step_stream(self, batches, lr: Optional[float] = None):
        """Train from any batch iterable in chunks of
        ``train_steps_per_sync``: full chunks through :meth:`step_many`
        (taken with the iterator's ``peek_many`` when it has one), a short
        last chunk through :meth:`step`. Yields one future per call."""
        k = self.train_steps_per_sync
        it = iter(batches)
        while True:
            if hasattr(it, "peek_many"):
                try:
                    chunk = it.peek_many(k)
                except StopIteration:
                    return
            else:
                chunk = []
                for _ in range(k):
                    try:
                        chunk.append(next(it))
                    except StopIteration:
                        break
            if not chunk:
                return
            if len(chunk) == k and k > 1:
                yield self.step_many(chunk, lr)
            else:
                for b in chunk:
                    yield self.step(b, lr)
                if len(chunk) < k:
                    return

    def _run(self, feed, lr: float) -> torch.Tensor:
        """One step on a fed batch: the loss (f32, 0-d), or ``[loss,
        notfinite]`` under ``check_finite``."""
        if self._zero is not None and self.zero_stage >= 3:
            self._zero_begin()
        if self._pp is not None and self._stages_whole:
            self._drop_stages()
        leaves = self._leaves()
        diff = [leaves[k] for k in self._diff_keys]
        losses, stat_runs = [], []
        axes = {} if self.mesh is None else {"dp": self.mesh.data_group}
        if self._mp is not None:
            axes["mp"] = self._mp
        if self._pp is not None:
            axes["pp"] = self._pp
        if self._sp is not None:
            axes["sp"] = self._sp
        zero = self._zero
        if zero is not None:
            for i, leaf in enumerate(diff):
                leaf.register_post_accumulate_grad_hook(
                    functools.partial(self._leaf_grad, i))
        for i, mb in enumerate(_micro_batches(feed, self.grad_accum)):
            with torch.enable_grad(), self._unit_hooks():
                bind = env.spmd_axes(**axes) if axes else \
                    contextlib.nullcontext()
                if zero is not None:
                    zero["phase"] = "forward"
                with collect_stat_updates() as stats, bind:
                    loss = torch.func.functional_call(self._wrapper, leaves,
                                                      (mb,))
                loss = loss.float()
                if zero is not None:
                    self._zero_backward(loss, diff, i)
                else:
                    grads = torch.autograd.grad(loss, diff,
                                                allow_unused=True)
            if zero is None:
                with torch.no_grad():
                    for buf, g in zip(self._grads, grads):
                        if g is None:
                            if i == 0:
                                buf.zero_()
                        elif i == 0:
                            buf.copy_(g)
                        else:
                            buf.add_(g)
                del grads
            losses.append(loss.detach())
            stat_runs.append(stats)
        with torch.no_grad():
            if self.grad_accum > 1:
                if zero is None:
                    torch._foreach_div_(self._grads, float(self.grad_accum))
                loss = torch.stack(losses).mean()
            else:
                loss = losses[0]
            if zero is not None:
                loss = self._reduce_zero(loss)
            elif self._flat is not None:
                if self._block_lo < self._block_hi:
                    self._sum_seq(self._flat[self._block_lo:self._block_hi])
                self._flat[-1:].copy_(loss.reshape(1))
                collective.all_reduce(self._flat, collective.ReduceOp.AVG,
                                      self.mesh.data_group)
                loss = self._flat[-1].clone()
            finite = self._finite(loss) if self.check_finite else None
            if self.clip_global_norm is not None:
                self._clip(self.clip_global_norm)
            blends = self._stat_blends(leaves, stat_runs)
            del leaves, diff
            if finite is not None:
                state = self._keep_state()
                if self._backup is None:
                    self._backup = [torch.empty_like(t) for t in state]
                snapshot_(self._backup, state)
        self._opt.apply(self._opt_params, self._opt_grads, lr)
        with torch.no_grad():
            if self._zero is not None:
                self._zero_finish(blends, finite, state if finite is not None
                                  else None)
            else:
                for buf, old, seq, m in blends:
                    buf.copy_(_blend(old, seq, m).to(buf.dtype))
                if finite is not None:
                    keep_where_(state, self._backup, finite)
            if finite is None:
                return loss
            step_t = getattr(self._opt, "_step_t", None)
            if step_t is not None:     # the device step count stays too
                step_t.sub_((~finite).float())
            return torch.stack([loss, (~finite).float()])

    def _sum_seq(self, grad: torch.Tensor) -> None:
        """Sum the blocks' gradient over the ``sp`` ranks of a sequence
        cut, each of which saw its slice of the sequence (a no-op
        without one)."""
        if self._sp is not None:
            collective.all_reduce(grad, collective.ReduceOp.SUM, self._sp)

    # -- ZeRO: units through the step ---------------------------------------

    def _zero_begin(self) -> None:
        """ZeRO stage 3 before the forward: what :meth:`sync_model`
        gathered is released, and the units that stay whole through the
        step (the root unit, a pp stage's blocks) are gathered."""
        z = self._zero
        if z["whole"]:
            self._release_params()
        for u in z["units"]:
            if u.module is None:
                self._gather_unit(u)

    @contextlib.contextmanager
    def _unit_hooks(self):
        """ZeRO stage 3, around one micro-batch's forward and backward:
        each block unit gathered before its forward and released after it
        (not in a recomputation inside the backward), and gathered again
        when its output's gradient arrives, before its backward."""
        z = self._zero
        if z is None or self.zero_stage < 3:
            yield
            return
        handles = []

        def pre(u, mod, args):
            self._gather_unit(u)

        def post(u, mod, args, out):
            if z["phase"] != "forward":
                return
            self._release_unit(u)
            y = out[0] if isinstance(out, tuple) else out
            if isinstance(y, torch.Tensor) and y.requires_grad:
                y.register_hook(lambda g, u=u: self._gather_unit(u))
        for u in z["units"]:
            if u.module is not None:
                handles.append(u.module.register_forward_pre_hook(
                    functools.partial(pre, u)))
                handles.append(u.module.register_forward_hook(
                    functools.partial(post, u)))
        try:
            yield
        finally:
            for h in handles:
                h.remove()

    def _zero_backward(self, loss: torch.Tensor, diff, micro: int) -> None:
        """One micro-batch's backward under ZeRO: each leaf's gradient goes
        into its unit's as it accumulates (:meth:`_leaf_grad`), and a unit
        is reduced as soon as all of its leaves have come
        (:meth:`_unit_done`); afterwards, in unit order, each unit some of
        whose leaves took no gradient (zero) is completed."""
        z = self._zero
        z["micro"] = micro
        for u in z["units"]:
            u.pending, u.seen, u.gbuf = len(u.idx), [False] * len(u.idx), None
        z["phase"] = "backward"
        try:
            torch.autograd.backward(loss, inputs=diff)
        finally:
            z["phase"] = None
        with torch.no_grad():
            for u in z["units"]:
                if not u.pending:
                    continue
                buf = self._unit_grad(u)
                if self.zero_stage == 1 and micro == 0:
                    for j, seen in enumerate(u.seen):
                        if not seen:
                            t = self._masters[u.idx[j]]
                            buf[u.offs[j]:u.offs[j] + t.nelement()].zero_()
                u.pending = 0
                self._unit_done(u)

    def _unit_grad(self, u) -> torch.Tensor:
        """The unit's gradient being assembled: the whole gradient's part
        at stage 1, else a buffer of the unit's size (zeros) made on the
        unit's first leaf of the micro-batch."""
        if u.gflat is not None:
            return u.gflat
        if u.gbuf is None:
            u.gbuf = torch.zeros(u.n, dtype=torch.float32,
                                 device=self.device)
            z = self._zero
            z["max_grad_buffer"] = max(z["max_grad_buffer"], u.n)
        return u.gbuf

    @torch.no_grad()
    def _leaf_grad(self, i: int, leaf: torch.Tensor) -> None:
        """A leaf's gradient has accumulated (autograd's hook, once per
        backward): it goes into its unit's gradient (added at stage 1 after
        the first micro-batch), the leaf's copy is freed, and the unit is
        reduced when it was the last of the unit's leaves."""
        z = self._zero
        k, j = z["unit_of"][i]
        u = z["units"][k]
        g = leaf.grad
        view = self._unit_grad(u)[u.offs[j]:u.offs[j] + g.nelement()]
        if u.gflat is not None and z["micro"] > 0:
            view.add_(g.reshape(-1))
        else:
            view.copy_(g.reshape(-1))
        leaf.grad = None
        u.seen[j] = True
        u.pending -= 1
        if u.pending == 0:
            self._unit_done(u)

    def _unit_done(self, u) -> None:
        """A unit's gradient of one micro-batch is complete. Stage 1: on the
        last micro-batch, one all-reduce over the data ranks (after the
        sum over ``sp`` for a block's). Stages 2-3: the sum over ``sp``
        (a block's), an all-reduce over ``dp``, a reduce-scatter over
        ``sharding`` into this rank's shard (:meth:`_scatter_unit`), and
        the unit's gradient freed; stage 3 then releases a block's
        parameters."""
        z, m = self._zero, self.mesh
        if u.gflat is not None:
            if z["micro"] == self.grad_accum - 1:
                if u.block:
                    self._sum_seq(u.gflat)
                collective.all_reduce(u.gflat, collective.ReduceOp.SUM,
                                      m.data_group)
            return
        g, u.gbuf = u.gbuf, None
        if g is None:
            g = torch.zeros(u.n, dtype=torch.float32, device=self.device)
        if u.block:
            self._sum_seq(g)
        if m.shape["dp"] > 1:
            collective.all_reduce(g, collective.ReduceOp.SUM, m.groups["dp"])
        self._scatter_unit(u, g)
        del g
        if u.module is not None and self.zero_stage >= 3:
            self._release_unit(u)

    def _scatter_unit(self, u, g: torch.Tensor) -> None:
        """Reduce-scatter a unit's gradient over ``sharding`` into this
        rank's shard of it, written there on the first micro-batch and
        added after."""
        z = self._zero
        if z["micro"] == 0:
            collective.reduce_scatter(u.gshard, g, collective.ReduceOp.SUM,
                                      z["group"])
        else:
            part = torch.empty_like(u.gshard)
            collective.reduce_scatter(part, g, collective.ReduceOp.SUM,
                                      z["group"])
            u.gshard.add_(part)

    def _zero_finish(self, blends, finite, state) -> None:
        """ZeRO after the update of this rank's shard: the keep-select of
        a non-finite step on the shard, the parameters gathered unit by unit
        (stages 1-2; stage 3 only where running statistics must blend), the
        blends (kept back too on a non-finite step), and at stage 3 every
        unit released."""
        z = self._zero
        if finite is not None:
            keep_where_(state, self._backup, finite)
        if self.zero_stage >= 3:
            for u in z["units"]:
                self._release_unit(u)
        if self.zero_stage < 3 or blends:
            z["whole"] = False
            self._gather_params()
        for buf, old, seq, m in blends:
            cur = _blend(old, seq, m)
            if finite is not None:
                cur = torch.where(finite, cur, old)
            buf.copy_(cur.to(buf.dtype))
        if self.zero_stage >= 3 and blends:
            for u in z["units"]:
                u.pshard.copy_(u.pflat[u.lo:u.hi])
            self._release_params()

    def _reduce_zero(self, loss: torch.Tensor) -> torch.Tensor:
        """ZeRO after the backward of every micro-batch: the gradient
        (each unit already reduced as it completed) divided into the mean
        over the data ranks and the micro-batches, and the mean loss over
        the data ranks (its own all-reduce)."""
        m = self.mesh
        lbuf = loss.reshape(1).clone()
        collective.all_reduce(lbuf, collective.ReduceOp.AVG, m.data_group)
        scale = float(m.data_group.nranks * self.grad_accum)
        if self._zero["gshard"] is not None:
            self._zero["gshard"].div_(scale)
        else:
            for u in self._zero["units"]:
                u.gflat.div_(scale)
        return lbuf[0]

    def _dist_groups(self) -> List[collective.Group]:
        """The groups a sum over the whole gradient reduces over: the
        ZeRO shards, the model-parallel ranks and the pipeline stages."""
        out = []
        if self._zero is not None:
            out.append(self._zero["group"])
        if self._mp is not None:
            out.append(self._mp)
        if self._pp is not None:
            out.append(self._pp)
        return out

    def _finite(self, loss: torch.Tensor) -> torch.Tensor:
        """Device bool: the loss and every gradient are finite
        (:func:`_all_finite`), over every shard under ZeRO or mp and every
        stage under pp."""
        groups = self._dist_groups()
        if not groups:
            return _all_finite(loss, self._opt_grads)
        norms = torch._foreach_norm(self._opt_grads, 1)
        bad = (~torch.isfinite(torch.stack(norms))).any().float().reshape(1)
        for g in groups:
            collective.all_reduce(bad, collective.ReduceOp.MAX, g)
        return torch.isfinite(loss) & (bad[0] == 0)

    def _clip(self, c: float) -> None:
        """Scale every gradient by ``min(1, c / (||g|| + 1e-6))``, the norm
        over the whole model (each ZeRO and mp shard and each stage's
        blocks once, a tensor replicated over mp or the stages once)."""
        groups = self._dist_groups()
        if not groups:
            gn = _global_norm(self._opt_grads)
        else:
            norms = torch._foreach_norm(self._opt_grads, 2)
            w = torch.tensor(self._opt_weight, dtype=torch.float32,
                             device=self.device)
            sq = (torch.stack(norms).float() ** 2 * w).sum().reshape(1)
            for g in groups:
                collective.all_reduce(sq, collective.ReduceOp.SUM, g)
            gn = torch.sqrt(sq[0])
        torch._foreach_mul_(self._opt_grads, _clip_scale(gn, c))

    def _keep_state(self) -> List[torch.Tensor]:
        """What a skipped step must leave as it was: the parameters and
        floating buffers the optimizer updates (this rank's pieces under
        ZeRO) and their slots."""
        opt = self._opt
        return list(self._opt_params) + [
            opt._slots_for(t)[n] for t in self._opt_params
            for n in opt._slot_names]

    def _stat_blends(self, leaves, stat_runs):
        """``(buffer, its value before the step, [batch statistic of each
        micro-batch], momentum)`` for each running statistic a batch norm
        recorded, the values in f32 (or the buffer's dtype, where that is
        wider)."""
        by_leaf = {id(leaves["m." + n]): b
                   for n, b in zip(self.buffer_names, self.buffers)}
        out: Dict[int, list] = {}
        for stats in stat_runs:
            for u in stats:
                for leaf, stat in ((u.old_mean, u.mean), (u.old_var, u.var)):
                    buf = by_leaf.get(id(leaf))
                    if buf is None:
                        raise InvalidArgumentError(
                            "ParallelEngine: a batch norm updated running "
                            "statistics that are not the model's buffers")
                    wide = torch.promote_types(buf.dtype, torch.float32)
                    if id(buf) not in out:
                        out[id(buf)] = [buf, buf.to(wide, copy=True), [],
                                        u.momentum]
                    out[id(buf)][2].append(stat.to(wide))
        return list(out.values())

    # -- host side ----------------------------------------------------------

    def drain(self) -> None:
        """Block until every dispatched step has finished on the device
        (no readback: a sync, not a fetch)."""
        while self._inflight:
            self._inflight.popleft().block()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def cache_stats(self) -> Dict[str, int]:
        """The JAX engine's executable-cache accounting: each new batch
        shape signature is a miss, every other dispatch a hit."""
        return {"hits": self.dispatch_count - self.trace_count,
                "misses": self.trace_count}

    def _sync_local(self) -> None:
        """Drain the dispatched steps; under ZeRO stage 3 gather the
        parameters, which stay whole until the next step."""
        self.drain()
        if self._zero is not None:
            self._gather_params()

    def sync_model(self) -> None:
        """The model's parameters are the engine's (updated in place), so
        this drains the dispatched steps; under ZeRO stage 3 it also
        gathers the parameters, and at ``pp > 1`` every block another
        stage holds into the model (a collective call, on every rank):
        both stay until the next step."""
        self._sync_local()
        if self._pp is None:
            return
        with torch.no_grad():
            whole = self._stage_gather(
                self.model.state_dict(keep_vars=True), self._state_keys)
            for e, bps, mine in self._encoders:
                for i in range(e.num_layers):
                    if i // bps != self._pp.rank:
                        e.layers[i] = copy.deepcopy(mine[i % bps])
            for k, t in self.model.state_dict(keep_vars=True).items():
                where = self._block_of.get(k)
                if where is not None and where[0] != self._pp.rank:
                    t.data.copy_(whole[k])
        self._stages_whole = True

    def slot_bytes(self) -> int:
        """Bytes of optimizer slots this rank holds (1/n of the whole, and
        the padding, at ZeRO sharding n)."""
        return sum(t.nelement() * t.element_size()
                   for s in self._opt._slots.values() for t in s.values())

    @torch.no_grad()
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state with every model-parallel shard gathered to
        its whole tensor (collective calls over the ``mp`` group, on
        every rank), and at ``pp > 1`` every stage's blocks: what
        ``state_dict()`` gives on one rank."""
        self._sync_local()
        out = {}
        for k, t in self.model.state_dict(keep_vars=True).items():
            axes = _axes(t)
            if self._mp is not None and "mp" in axes:
                parts = []
                collective.all_gather(parts, t.detach().contiguous(),
                                      self._mp)
                out[k] = torch.cat(parts, dim=axes.index("mp"))
            else:
                out[k] = t.detach().clone()
        if self._pp is not None:
            out = self._stage_gather(out, self._state_keys)
        return out

    @torch.no_grad()
    def full_grad_dict(self) -> Dict[str, torch.Tensor]:
        """The gradient the last step applied (the mean over the data
        ranks, after the clip), keyed by parameter and floating-buffer
        name, every ZeRO and model-parallel shard gathered to its whole
        tensor and at ``pp > 1`` every stage's blocks (collective calls,
        on every rank): what it is on one rank."""
        self.drain()
        masters = self._train + self.buffers
        z = self._zero
        if z is None:
            grads = self._grads
        else:
            grads = [None] * len(masters)
            for u in z["units"]:
                whole = torch.empty(u.n, dtype=torch.float32,
                                    device=self.device)
                collective.all_gather_into(whole, u.gshard, z["group"])
                for i, o in zip(u.idx, u.offs):
                    t = masters[i]
                    grads[i] = whole[o:o + t.nelement()].view(t.shape)
        names = dict(zip(map(id, self.params), self.names))
        names.update(zip(map(id, self.buffers), self.buffer_names))
        out = {}
        for t, g in zip(masters, grads):
            axes = _axes(t)
            if self._mp is not None and "mp" in axes:
                parts = []
                collective.all_gather(parts, g.contiguous(), self._mp)
                g = torch.cat(parts, dim=axes.index("mp"))
            out[names[id(t)]] = g.clone()
        if self._pp is not None:
            out = self._stage_gather(out, self._grad_keys)
        return out

    def _checkpoint_tree(self, saving: bool) -> Dict[str, Any]:
        """The engine's state as a tree of ``checkpoint.Piece`` leaves:
        ``{"params": {name: piece}, "opt_state":
        ({name: {slot: piece}}, step)}``, each master's piece this rank
        owns (its ZeRO shard's part, else the whole tensor; a
        model-parallel shard's name carries ``#mp<rank>``) and the
        parameters the optimizer does not train, whole. ``saving``: only
        what this rank writes (one rank of each replica: data rank 0
        without ZeRO, ``sp`` rank 0, and for a tensor replicated over
        ``mp`` or the ``pp`` stages, rank 0 of that axis)."""
        from .checkpoint import Piece
        from .topology import mesh_descriptor
        m = self.mesh
        md = mesh_descriptor(m) if m is not None else None
        coords = m.coords if m is not None else {}
        data_replica = coords.get("dp", 0) > 0 or coords.get("sp", 0) > 0 \
            or (self._zero is None and coords.get("sharding", 0) > 0)
        masters = self._train + self.buffers
        names = dict(zip(map(id, self.params), self.names))
        names.update(zip(map(id, self.buffers), self.buffer_names))

        def key(t):
            n = names[id(t)]
            return f"{n}#mp{self._mp.rank}" if self._mp is not None and \
                getattr(t, "_mp_local", False) else n

        def writes(t):
            if not saving:
                return True
            if data_replica:
                return False
            if self._mp is not None and self._mp.rank > 0 and \
                    not getattr(t, "_mp_local", False):
                return False
            return self._pp is None or self._pp.rank == 0 or \
                id(t) in self._stage_ids

        params, slots = {}, {}
        opt = self._opt
        if self._zero is not None:
            for piece, (i, start) in zip(self._opt_params,
                                         self._zero["pieces_at"]):
                t = masters[i]
                if not writes(t):
                    continue
                k = key(t)
                params[k] = Piece(piece, start, t.shape, md)
                slots[k] = {n: Piece(v, start, t.shape, md)
                            for n, v in opt._slots_for(piece).items()}
        else:
            for t in masters:
                if writes(t):
                    params[key(t)] = Piece(t.data, 0, t.shape, md)
                    slots[key(t)] = {n: Piece(v, 0, t.shape, md) for n, v
                                     in opt._slots_for(t).items()}
        trained = {id(t) for t in masters}
        for t in self.params:
            if id(t) not in trained and writes(t):
                params[key(t)] = Piece(t.data, 0, t.shape, md)
        step = opt._step_count if opt._step_t is None else \
            int(opt._step_t.item())
        return {"params": params,
                "opt_state": (slots, torch.tensor(step, dtype=torch.int64))}

    def save_checkpoint(self, path: str) -> str:
        """Drain, then save the masters' shards, the shard optimizer's
        slots and its step, each rank what it owns
        (``checkpoint.save_sharded``; a collective call, every rank).
        Returns the path."""
        self.drain()
        from . import checkpoint as dckpt
        return dckpt.save_sharded(path, self._checkpoint_tree(True))

    def load_checkpoint(self, path: str) -> None:
        """Restore into the engine's current mesh, ZeRO degree and stage
        (each rank reads the runs its pieces cover; a checkpoint of
        another ``dp`` x ``sharding`` restores, one of another ``mp``,
        ``pp`` or ``sp`` degree raises ``ReshardError``), then
        :meth:`sync_model`."""
        self.drain()
        from . import checkpoint as dckpt
        tree = self._checkpoint_tree(False)
        got = dckpt.load_sharded(path, tree)
        opt = self._opt
        opt._step_count, opt._step_t = int(got["opt_state"][1]), None
        z = self._zero
        if z is not None:
            if self.zero_stage >= 3:
                self._release_params()
            else:
                z["whole"] = False
        self.sync_model()


def make_train_step(layer: nn.Module, optimizer, loss_fn: Callable,
                    grad_accum: int = 1,
                    clip_global_norm: Optional[float] = None,
                    amp_dtype: Optional[str] = None,
                    recompute: bool = False,
                    grad_shardings=None,
                    check_finite: bool = False):
    """The pure train step of the JAX package's ``make_train_step``:
    ``train_step(params, opt_state, batch, key, lr) -> (loss, new params,
    new opt_state)`` over ``{name: tensor}`` dicts of the layer's
    parameters and floating buffers (``opt_state`` from
    ``optimizer.functional_init``); the inputs are not written. ``key``
    seeds the step's random ops (an int or None: the default generators
    as they stand). Under ``grad_accum`` the batch leaves are ``[n,
    ...]``; ``check_finite`` returns ``[loss, notfinite]`` and keeps the
    inputs on a non-finite step; running statistics blend as in
    :class:`ParallelEngine`. ``grad_shardings`` (GSPMD layout pins) has
    no meaning here: the engine cuts its shards itself, and it raises."""
    if grad_shardings is not None:
        raise UnimplementedError(
            "make_train_step: grad_shardings pins GSPMD layouts; the port's "
            "ParallelEngine cuts its ZeRO shards itself")
    if amp_dtype is not None and amp_dtype not in _AMP:
        raise InvalidArgumentError(
            f"amp_dtype must be None or one of {sorted(_AMP)}, got "
            f"{amp_dtype!r}")
    cdt = _AMP.get(amp_dtype)
    wrapper = _LossModule(layer, loss_fn)
    if recompute:
        ParallelEngine._flip_recompute(layer)

    def leaf(v):
        t = v.detach()
        if cdt is not None and t.is_floating_point():
            t = t.to(cdt)
        return t.requires_grad_(t.is_floating_point())

    def train_step(params, opt_state, batch, key, lr):
        names = [k for k, v in params.items() if v.is_floating_point()]
        fork = contextlib.nullcontext() if key is None else \
            torch.random.fork_rng(devices=[
                v.device for v in params.values() if v.is_cuda][:1])
        grads = {k: torch.zeros_like(params[k], dtype=torch.float32)
                 for k in names}
        losses, stats_by_name, momenta = [], {}, {}
        with fork:
            if key is not None:
                torch.manual_seed(int(key))
            for mb in _micro_batches(batch, grad_accum):
                if cdt is not None:
                    mb = _map(lambda a: a.to(cdt) if isinstance(
                        a, torch.Tensor) and a.is_floating_point() else a,
                        mb)
                leaves = {"m." + k: leaf(v) for k, v in params.items()}
                with torch.enable_grad():
                    with collect_stat_updates() as stats:
                        loss = torch.func.functional_call(wrapper, leaves,
                                                          (mb,))
                    loss = loss.float()
                    diff = [leaves["m." + k] for k in names]
                    gs = torch.autograd.grad(loss, diff, allow_unused=True)
                for k, g in zip(names, gs):
                    if g is not None:
                        grads[k].add_(g.float())
                losses.append(loss.detach())
                by_leaf = {id(leaves["m." + k]): k for k in params}
                for u in stats:
                    for old, stat in ((u.old_mean, u.mean),
                                      (u.old_var, u.var)):
                        k = by_leaf.get(id(old))
                        if k is not None:
                            momenta[k] = float(u.momentum)
                            stats_by_name.setdefault(k, []).append(
                                stat.detach().float())
        with torch.no_grad():
            if grad_accum > 1:
                grads = {k: g / grad_accum for k, g in grads.items()}
                loss = torch.stack(losses).mean()
            else:
                loss = losses[0]
            finite = _all_finite(loss, grads.values()) if check_finite \
                else None
            if clip_global_norm is not None:
                scale = _clip_scale(_global_norm(grads.values()),
                                    clip_global_norm)
                grads = {k: g * scale for k, g in grads.items()}
            fparams = {k: params[k] for k in names}
            new_params, new_state = optimizer.functional_update(
                fparams, grads, opt_state, lr)
            for k, v in params.items():
                if k not in new_params:
                    new_params[k] = v
            for k, seq in stats_by_name.items():
                new_params[k] = _blend(params[k].float(), seq,
                                       momenta[k]).to(params[k].dtype)
            if finite is not None:
                new_params = {k: torch.where(finite, v, params[k])
                              for k, v in new_params.items()}
                slots, step = new_state
                old_slots, old_step = opt_state
                new_state = ({k: {n: torch.where(finite, t, old_slots[k][n])
                                  for n, t in d.items()}
                              for k, d in slots.items()},
                             torch.where(finite.cpu(), step, old_step))
                return torch.stack([loss, (~finite).float()]), new_params, \
                    new_state
            return loss, new_params, new_state

    return train_step
