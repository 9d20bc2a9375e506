"""Single-device training engine (port of ``ParallelEngine`` from
``paddle1_tpu/distributed/parallel_engine.py``, without the mesh).

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

Meshes, ZeRO, ``grad_accum``, ``step_many``/``step_stream`` and
``check_finite`` are later slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..core.async_loss import LossFuture
from ..core.errors import InvalidArgumentError
from ..nn.functional.norm import collect_stat_updates

__all__ = ["ParallelEngine"]

_AMP = {"bfloat16": torch.bfloat16}


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
        """One optimizer step on ``batch``; ``lr`` overrides the
        optimizer's learning rate for this step."""
        feed = self._feed(batch)
        leaves = self._leaves()
        with torch.enable_grad(), collect_stat_updates() as stats:
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
