"""Training engine (port of ``ParallelEngine`` from
``paddle1_tpu/distributed/parallel_engine.py``): one device, or
data-parallel over a ``dp`` mesh.

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
* ``amp_dtype="bfloat16"`` is the JAX package's pure-bf16 mode
  (``parallel_engine.py:221-235``), not ``torch.autocast``: each step
  casts the floating parameters and float feeds to bf16, runs forward and
  backward in bf16 through ``torch.func.functional_call``, casts the loss
  to f32, and the optimizer updates the f32 masters (the model's own
  parameters) from the gradients cast to f32.
* Gradients land in persistent buffers in the masters' dtype, allocated
  once (on a mesh: views of one flat buffer), so the fused optimizer's
  table of pointers is built once.
* Floating buffers (batch norm's ``_mean``/``_variance``) are leaves of
  the step like the parameters, as the JAX engine threads its whole
  state through the step (``parallel_engine.py:425-431``): under
  ``amp_dtype`` they are cast with the parameters, so a given-statistics
  forward normalizes with bf16-rounded running statistics; they are
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

With ``mesh=build_mesh(dp=n)`` (or ``degrees={"dp": n}``) each of the n
ranks (processes, after ``init_parallel_env``) runs the step on its equal
shard of the global batch, and the step computes what the JAX engine's
computes on the batch sharded over its mesh
(``parallel_engine.py:597-670, 768-809``):

* at construction rank 0 broadcasts the parameters and floating buffers;
* :meth:`shard_batch` cuts a global batch into this rank's shard (a batch
  that does not divide over the ranks raises, as ``benches.py:106-108``;
  under ``grad_accum`` the cut is along the micro-batch axis);
* the forward runs under the ``dp`` binding (``env.spmd_axes``), so every
  training-mode batch norm normalizes with the global batch's statistics
  (``nn/functional/norm.py``): one differentiable all-reduce per batch
  norm each way. This holds at world size 1 too;
* after the backward the gradients and the loss are averaged over the
  ranks in ONE all-reduce of a flat f32 buffer (the persistent gradient
  buffers are views into it), before the optimizer: every rank applies
  the same update, and the step returns the global-batch mean loss;
* the running statistics blend the global statistics, the same on every
  rank.

``zero_stage`` (0-3) is accepted: the sharding degree is 1 (``build_mesh``
raises above it), and at degree 1 every stage is the identity, as in the
JAX engine on one device. ``donate`` is accepted and changes nothing: the
port updates parameters and slots in place. ``batch_spec`` other than
None, ``pp_microbatches`` (pipelining) and ``save_checkpoint``/
``load_checkpoint`` are later slices (ROADMAP.md Queue 1 items 5 and 6)
and raise.
"""

from __future__ import annotations

import collections
import contextlib
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

__all__ = ["ParallelEngine", "ShardedBatch", "snapshot_", "keep_where_"]

_AMP = {"bfloat16": torch.bfloat16}
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


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


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


class ParallelEngine:
    """One-device (or data-parallel) trainer. ``optimizer`` is one of this
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
        if batch_spec is not None:
            raise UnimplementedError(
                "ParallelEngine: batch_spec is not ported; the port cuts "
                "the batch's leading axis over dp (ROADMAP.md Queue 1 "
                "item 5)")
        if pp_microbatches is not None:
            raise UnimplementedError(
                "ParallelEngine: pipeline parallelism (pp_microbatches) is "
                "ROADMAP.md Queue 1 item 5")
        self.model = model
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
        if mesh is None and degrees is not None:
            mesh = build_mesh(**degrees)
        self.mesh = mesh
        self._flat = None
        if mesh is not None:
            self._init_dp()
        else:
            self._grads = [torch.zeros_like(t)
                           for t in self._train + self.buffers]

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

    def _init_dp(self):
        """Rank 0's parameters and floating buffers everywhere; the
        gradient buffers are views into one flat f32 buffer whose last
        element carries the loss (the only gradient storage: no second
        copy)."""
        group = self.mesh.group
        with torch.no_grad():
            for t in self.params + self.buffers:
                collective.broadcast(t.data, 0, group)
        masters = self._train + self.buffers
        bad = [t.dtype for t in masters if t.dtype != torch.float32]
        if bad:
            raise InvalidArgumentError(
                "ParallelEngine: the dp path averages gradients in one f32 "
                f"buffer; the masters must be f32, got {sorted(set(bad))}")
        offs, n = [], 0
        for t in masters:
            offs.append(n)
            n += -(-t.nelement() // _ALIGN) * _ALIGN
        self._flat = torch.zeros(n + 1, dtype=torch.float32,
                                 device=self.device)
        self._grads = [self._flat[o:o + t.nelement()].view(t.shape)
                       for o, t in zip(offs, masters)]

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
        n, r = self.mesh.group.nranks, self.mesh.group.rank
        axis = 1 if self.grad_accum > 1 else 0

        def cut(a):
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
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
        out = {}
        for n, p in zip(self.names + self.buffer_names,
                        self.params + self.buffers):
            leaf = p.detach()
            if self.amp_dtype is not None and leaf.is_floating_point():
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
        leaves = self._leaves()
        diff = [leaves[k] for k in self._diff_keys]
        micro = [feed] if self.grad_accum == 1 else \
            [_map(lambda a, i=i: a[i], feed) for i in range(self.grad_accum)]
        losses, stat_runs = [], []
        for i, mb in enumerate(micro):
            with torch.enable_grad():
                bind = contextlib.nullcontext() if self.mesh is None else \
                    env.spmd_axes(dp=self.mesh.group)
                with collect_stat_updates() as stats, bind:
                    loss = torch.func.functional_call(self._wrapper, leaves,
                                                      (mb,))
                loss = loss.float()
                grads = torch.autograd.grad(loss, diff, allow_unused=True)
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
                torch._foreach_div_(self._grads, float(self.grad_accum))
                loss = torch.stack(losses).mean()
            else:
                loss = losses[0]
            if self._flat is not None:
                self._flat[-1:].copy_(loss.reshape(1))
                collective.all_reduce(self._flat, collective.ReduceOp.AVG,
                                      self.mesh.group)
                loss = self._flat[-1].clone()
            finite = self._finite(loss) if self.check_finite else None
            if self.clip_global_norm is not None:
                self._clip(self.clip_global_norm)
            blends = self._stat_blends(leaves, stat_runs)
            if finite is not None:
                state = self._keep_state()
                if self._backup is None:
                    self._backup = [torch.empty_like(t) for t in state]
                snapshot_(self._backup, state)
        self.optimizer.apply(self._train + self.buffers, self._grads, lr)
        with torch.no_grad():
            for buf, old, seq, m in blends:
                cur = old
                for stat in seq:
                    cur = m * cur + (1 - m) * stat
                buf.copy_(cur.to(buf.dtype))
            if finite is None:
                return loss
            keep_where_(state, self._backup, finite)
            step_t = getattr(self.optimizer, "_step_t", None)
            if step_t is not None:     # the device step count stays too
                step_t.sub_((~finite).float())
            return torch.stack([loss, (~finite).float()])

    def _finite(self, loss: torch.Tensor) -> torch.Tensor:
        """Device bool: the loss and every gradient are finite (a sum of
        |g| is finite exactly when each term is, short of overflowing
        f32's 3.4e38)."""
        norms = torch._foreach_norm(self._grads, 1)
        return torch.isfinite(loss) & torch.isfinite(torch.stack(norms)).all()

    def _clip(self, c: float) -> None:
        """Scale every gradient by ``min(1, c / (||g|| + 1e-6))``."""
        norms = torch._foreach_norm(self._grads, 2)
        gn = torch.linalg.vector_norm(torch.stack(norms).float())
        scale = torch.clamp(c / (gn + 1e-6), max=1.0)
        torch._foreach_mul_(self._grads, scale)

    def _keep_state(self) -> List[torch.Tensor]:
        """What a skipped step must leave as it was: the parameters and
        floating buffers the optimizer updates and their slots."""
        opt = self.optimizer
        masters = self._train + self.buffers
        return masters + [opt._slots_for(t)[n] for t in masters
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

    def sync_model(self) -> None:
        """The model's parameters are the engine's (updated in place), so
        this only drains the dispatched steps."""
        self.drain()

    def save_checkpoint(self, path: str) -> str:
        raise UnimplementedError(
            "ParallelEngine.save_checkpoint: sharded checkpoints "
            "(distributed/checkpoint.py) are ROADMAP.md Queue 1 item 6")

    def load_checkpoint(self, path: str) -> None:
        raise UnimplementedError(
            "ParallelEngine.load_checkpoint: sharded checkpoints "
            "(distributed/checkpoint.py) are ROADMAP.md Queue 1 item 6")
