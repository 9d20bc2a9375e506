"""Training engine (port of ``ParallelEngine`` from
``paddle1_tpu/distributed/parallel_engine.py``): one device, or
data-parallel over a ``dp`` mesh.

``ParallelEngine(model, optimizer, loss_fn, amp_dtype=None).step(batch)``
runs one optimizer step: forward and backward of ``loss_fn(model,
batch)``, then ``optimizer.apply``. It returns a :class:`LossFuture`
(the loss stays on the device until read) and counts ``dispatch_count``.

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
* Gradients land in persistent buffers in the masters' dtype, so the
  fused optimizer's table of pointers is built once.
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
  its value before the step (``parallel_engine.py:328-343``).

With ``mesh=build_mesh(dp=n)`` (or ``degrees={"dp": n}``) each of the n
ranks (processes, after ``init_parallel_env``) runs the step on its equal
shard of the global batch, and the step computes what the JAX engine's
computes on the batch sharded over its mesh
(``parallel_engine.py:597-670, 768-809``):

* at construction rank 0 broadcasts the parameters and floating buffers;
* :meth:`shard_batch` cuts a global batch into this rank's shard (a batch
  that does not divide over the ranks raises, as ``benches.py:106-108``);
* the forward runs under the ``dp`` binding (``env.spmd_axes``), so every
  training-mode batch norm normalizes with the global batch's statistics
  (``nn/functional/norm.py``): one differentiable all-reduce per batch
  norm each way. This holds at world size 1 too;
* after ``autograd.grad`` the gradients and the loss are averaged over
  the ranks in ONE all-reduce of a flat f32 buffer (the persistent
  gradient buffers are views into it), before the optimizer: every rank
  applies the same update, and the step returns the global-batch mean
  loss;
* the running statistics blend the global statistics, the same on every
  rank.

ZeRO, model/pipeline parallelism, ``grad_accum``,
``step_many``/``step_stream`` and ``check_finite`` are later slices
(ROADMAP.md).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..core.async_loss import LossFuture
from ..core.errors import InvalidArgumentError
from ..nn.functional.norm import collect_stat_updates
from . import collective, env
from .topology import Mesh, build_mesh

__all__ = ["ParallelEngine", "ShardedBatch"]

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


class ParallelEngine:
    """One-device trainer. ``optimizer`` is one of this package's
    optimizers over the model's parameters (or built with
    ``parameters=None``, then it adopts them); ``loss_fn(model, batch)``
    returns a scalar tensor. ``batch``: a dict, list or tuple of numpy
    arrays or tensors, moved to the parameters' device each step."""

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable,
                 mesh: Optional[Mesh] = None,
                 degrees: Optional[Dict[str, int]] = None,
                 amp_dtype: Optional[str] = None):
        if amp_dtype is not None and amp_dtype not in _AMP:
            raise InvalidArgumentError(
                f"amp_dtype must be None or one of {sorted(_AMP)}, got "
                f"{amp_dtype!r}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.amp_dtype = _AMP.get(amp_dtype)
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
        self._grads = [torch.zeros_like(p) for p in self._train]
        bufs = [(n, b) for n, b in model.named_buffers()
                if b.is_floating_point()]
        self.buffer_names: List[str] = [n for n, _ in bufs]
        self.buffers: List[torch.Tensor] = [b for _, b in bufs]
        self._buf_grads = [torch.zeros_like(b) for b in self.buffers]
        self._param_ids = {id(p) for p in self.params}
        self._wrapper = _LossModule(model, loss_fn)
        self.dispatch_count = 0
        if mesh is None and degrees is not None:
            mesh = build_mesh(**degrees)
        self.mesh = mesh
        self._flat = None
        if mesh is not None:
            self._init_dp()

    def _init_dp(self):
        """Rank 0's parameters and floating buffers everywhere; the
        gradient buffers become views into one flat f32 buffer whose last
        element carries the loss."""
        group = self.mesh.group
        with torch.no_grad():
            for t in self.params + self.buffers:
                collective.broadcast(t.data, 0, group)
        views = self._grads + self._buf_grads
        bad = [t.dtype for t in views if t.dtype != torch.float32]
        if bad:
            raise InvalidArgumentError(
                "ParallelEngine: the dp path averages gradients in one f32 "
                f"buffer; the masters must be f32, got {sorted(set(bad))}")
        offs, n = [], 0
        for t in views:
            offs.append(n)
            n += -(-t.numel() // _ALIGN) * _ALIGN
        self._flat = torch.zeros(n + 1, dtype=torch.float32,
                                 device=self.device)
        grads = [self._flat[o:o + t.numel()].view(t.shape)
                 for o, t in zip(offs, views)]
        self._grads = grads[:len(self._grads)]
        self._buf_grads = grads[len(self._grads):]

    def shard_batch(self, batch: Any) -> ShardedBatch:
        """This rank's shard of a global ``batch`` (every leaf with a
        leading dim is cut into equal parts along it; 0-d leaves are
        kept), placed on the device and cast as :meth:`step` feeds it.
        Without a mesh the shard is the whole batch. Raises when a leading
        dim does not divide over the ranks."""
        if self.mesh is None:
            return ShardedBatch(self._feed(batch))
        n, r = self.mesh.group.nranks, self.mesh.group.rank

        def cut(a):
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
            if a.ndim == 0:
                return a
            if a.shape[0] % n:
                raise InvalidArgumentError(
                    f"ParallelEngine: a batch leaf of {a.shape[0]} rows "
                    f"does not divide over {n} ranks")
            k = a.shape[0] // n
            return a[r * k:(r + 1) * k]
        if isinstance(batch, dict):
            local = {k: cut(v) for k, v in batch.items()}
        elif isinstance(batch, (list, tuple)):
            local = type(batch)(cut(v) for v in batch)
        else:
            local = cut(batch)
        return ShardedBatch(self._feed(local))

    def _feed(self, batch):
        def place(a):
            t = a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.asarray(a))
            t = t.to(self.device, non_blocking=True)
            if self.amp_dtype is not None and t.is_floating_point():
                t = t.to(self.amp_dtype)
            return t
        if isinstance(batch, dict):
            return {k: place(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(place(v) for v in batch)
        return place(batch)

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

    def step(self, batch: Any, lr: Optional[float] = None) -> LossFuture:
        """One optimizer step on ``batch`` (on a mesh: the global batch,
        or this rank's :class:`ShardedBatch`); ``lr`` overrides the
        optimizer's learning rate for this step."""
        if not isinstance(batch, ShardedBatch):
            batch = self.shard_batch(batch)
        feed = batch.data
        leaves = self._leaves()
        bind = contextlib.nullcontext() if self.mesh is None else \
            env.spmd_axes(dp=self.mesh.group)
        with torch.enable_grad(), collect_stat_updates() as stats:
            with bind:
                loss = torch.func.functional_call(self._wrapper, leaves,
                                                  (feed,))
            loss = loss.float()
            train = {id(p) for p in self._train}
            diff = [leaves["m." + n] for n, p in zip(self.names, self.params)
                    if id(p) in train]
            diff += [leaves["m." + n] for n in self.buffer_names]
            grads = torch.autograd.grad(loss, diff, allow_unused=True)
        with torch.no_grad():
            for buf, g in zip(self._grads + self._buf_grads, grads):
                if g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
            if self._flat is not None:
                self._flat[-1:].copy_(loss.detach().reshape(1))
                collective.all_reduce(self._flat, collective.ReduceOp.AVG,
                                      self.mesh.group)
                loss = self._flat[-1].clone()
            blends = self._stat_blends(leaves, stats)
        self.optimizer.apply(self._train + self.buffers,
                             self._grads + self._buf_grads, lr)
        with torch.no_grad():
            for buf, old, stat, m in blends:
                buf.copy_((m * old + (1 - m) * stat).to(buf.dtype))
        self.dispatch_count += 1
        return LossFuture(loss)

    def _stat_blends(self, leaves, stats):
        """``(buffer, its value before the step, batch statistic,
        momentum)`` for each running statistic a batch norm recorded, the
        two values in f32 (or the buffer's dtype, where that is wider)."""
        by_leaf = {id(leaves["m." + n]): b
                   for n, b in zip(self.buffer_names, self.buffers)}
        out = []
        for u in stats:
            for leaf, stat in ((u.old_mean, u.mean), (u.old_var, u.var)):
                buf = by_leaf.get(id(leaf))
                if buf is None:
                    raise InvalidArgumentError(
                        "ParallelEngine: a batch norm updated running "
                        "statistics that are not the model's buffers")
                wide = torch.promote_types(buf.dtype, torch.float32)
                out.append((buf, buf.to(wide, copy=True), stat.to(wide),
                            u.momentum))
        return out
