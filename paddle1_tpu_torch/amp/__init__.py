"""Automatic mixed precision (port of ``paddle1_tpu/amp/__init__.py``).

``auto_cast`` / ``amp_guard``, the ``WHITE_LIST`` and ``BLACK_LIST`` of
op names, ``amp_state``, ``decorate`` and ``GradScaler``.

The design
----------

**Where the cast happens.** At the boundary of a named Paddle op, under
the JAX package's op names: exactly the ops whose JAX twin passes that
name to ``autograd.engine.apply(...)``, the choke point where the JAX
package casts (``paddle1_tpu/autograd/engine.py:178-196``). Each such op
of the port is wrapped by :func:`cast_point` with its name:

- ``ops/math_ops.py``: ``exp``, ``log``, ``log2``, ``log10``,
  ``square``, ``pow``, ``mv``, ``sum``, ``mean``, ``matmul``, ``bmm``,
  ``addmm``, ``einsum``; ``ops/linalg_ops.py``: ``norm``;
- ``nn/functional``: ``softmax``, ``log_softmax``, ``cross_entropy``,
  ``layer_norm``, ``linear``, ``conv2d``, and the batch norms under
  ``batch_norm_train`` / ``batch_norm_infer`` and ``fused_bn_act_train``
  / ``fused_bn_act_infer`` (``paddle1_tpu/nn/functional/norm.py:259,
  297``).

Ops that reach these through another op cast there, as the JAX
package's do: ``softmax_`` under ``softmax``, ``softmax_with_cross_entropy``
under ``cross_entropy`` and ``softmax`` (the JAX package's op calls
``apply`` under those names and under no name of the lists), ``mm``
under ``matmul``, ``nn.Linear`` under ``linear``, ``nn.LayerNorm`` under
``layer_norm``, and a facade tensor's ``@`` and ``**`` under ``matmul``
and ``pow`` (``ops/patch.py``, as ``paddle1_tpu/ops/patch.py:42-48``
sends them). Under an active ``auto_cast``:

- white-listed: every floating tensor argument goes to the AMP dtype
  (float64 included);
- black-listed: every floating tensor argument goes to float32 (float64
  is left alone);
- every other op is untouched and follows its inputs by torch's type
  promotion, which for bf16 / f16 / f32 is jax's.

The arguments cast are the op's tensor arguments, positional or keyword;
a batch norm's running statistics are not among them (they are not
among the JAX op's inputs to ``apply`` in training, and are written in
place).

**One cast per Paddle op, none inside it.** The torch calls inside one
ported op run with the AMP state suspended, so an op that a named op
calls does not cast again: the JAX package's ``pure_fn`` is opaque to the
cast (``cross_entropy``'s inner log-softmax is not cast a second time).
The cast is a ``Tensor.to``, which autograd records: the gradient flows
back through it in the input's dtype. So an f32 parameter's ``.grad`` is
f32, and the backward through a black-listed op runs. Both depart from
the JAX package by design, whose cast sits outside its recorded VJP: its
backward through a black-listed op after a white-listed one raises, and
where it runs an f32 parameter's gradient comes back in the AMP dtype
(ROADMAP, "by design"). Paddle's reference inserts differentiable cast
ops (``imperative/amp_auto_cast.cc``), as the port does.

**State.** Thread-local, as in the JAX package: ``auto_cast`` nests and
restores the enclosing state on exit, ``level="O0"`` (or
``enable=False``) turns the casts off inside, and a level other than
``O0``/``O1``/``O2`` raises ``InvalidArgumentError``.
``custom_white_list`` / ``custom_black_list`` add names to a list and
take them off the other (``paddle1_tpu/amp/__init__.py:46-53``). ``O2``
casts the same ops as ``O1`` under ``auto_cast``, as in the JAX package;
``decorate(level="O2")`` casts the models' parameters.

**Cost with AMP off.** One thread-local read per named op and no other
work: no dispatched call is added (``tools/torch_method_cost.py`` still
counts one a fine-tuning step).

``GradScaler`` is the JAX package's state machine (a consume flag, one
scale update per step outcome, a second ``unscale_`` before ``update``
raising, ``record_step``, ``minimize``, ``last_step_skipped``,
``state_dict`` / ``load_state_dict``). Its ``unscale_`` reads the
gradients as plain tensors, as ``Optimizer.step`` does, and makes one
pass per (device, dtype) group, ``_foreach`` ops, with one host sync for
all of them.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch

from ..core import dtype as dtypes
from ..core.errors import InvalidArgumentError

__all__ = ["auto_cast", "amp_guard", "GradScaler", "decorate",
           "WHITE_LIST", "BLACK_LIST", "amp_state"]

# the JAX package's lists (paddle1_tpu/amp/__init__.py:28-37; reference
# fluid/dygraph/amp/auto_cast.py:27,36): white = low precision, black =
# kept in float32
WHITE_LIST = {"matmul", "bmm", "conv1d", "conv2d", "conv3d", "linear",
              "einsum", "addmm", "mv"}
BLACK_LIST = {"exp", "log", "log2", "log10", "mean", "sum", "softmax",
              "log_softmax", "cross_entropy", "layer_norm", "norm",
              "batch_norm_train", "batch_norm_infer", "fused_bn_act_train",
              "fused_bn_act_infer", "cosine_similarity",
              "reduce_sum", "pow", "square", "softmax_with_cross_entropy"}

_tls = threading.local()


class _AmpState:
    def __init__(self, enabled, dtype, level, custom_white, custom_black):
        self.enabled = enabled
        self.dtype = dtype
        self.level = level
        self.white = (WHITE_LIST | set(custom_white or ())) - \
            set(custom_black or ())
        self.black = (BLACK_LIST | set(custom_black or ())) - \
            set(custom_white or ())


def amp_state() -> Optional[_AmpState]:
    """The calling thread's AMP state (None outside ``auto_cast``)."""
    return getattr(_tls, "amp", None)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """AMP context (reference ``amp/auto_cast.py:20``): inside, the named
    ops on the white list run in ``dtype``, those on the black list in
    float32, and the others follow their inputs (see the module)."""
    if level not in ("O0", "O1", "O2"):
        raise InvalidArgumentError("level must be O0/O1/O2")
    prev = amp_state()
    _tls.amp = _AmpState(enable and level != "O0",
                         dtypes.convert_dtype(dtype), level,
                         custom_white_list, custom_black_list)
    try:
        yield
    finally:
        _tls.amp = prev


amp_guard = auto_cast


def _cast_to(x, dtype, keep_f64: bool):
    if isinstance(x, torch.Tensor) and x.is_floating_point() and \
            x.dtype != dtype and not (keep_f64 and x.dtype == torch.float64):
        return torch.Tensor.to(x, dtype)
    return x


def _run(name: str, fn, args, kwargs, state: _AmpState):
    """Run the named op ``fn`` under the active ``state``: its floating
    tensor arguments cast by the lists, the op itself with the state
    suspended (one cast per Paddle op)."""
    if name in state.white:
        dt, keep = state.dtype, False
    elif name in state.black:
        dt, keep = torch.float32, True
    else:
        dt = None
    if dt is not None:
        args = [_cast_to(a, dt, keep) for a in args]
        kwargs = {k: _cast_to(v, dt, keep) for k, v in kwargs.items()}
    _tls.amp = None
    try:
        return fn(*args, **kwargs)
    finally:
        _tls.amp = state


def cast_point(name: str):
    """Decorate a ported op as the named Paddle op ``name``: with AMP off
    the op runs as it is after one thread-local read; under an active
    ``auto_cast`` it runs through :func:`_run`."""
    def deco(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            state = getattr(_tls, "amp", None)
            if state is None or not state.enabled:
                return fn(*args, **kwargs)
            return _run(name, fn, args, kwargs, state)
        return op
    return deco


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Pure low precision (reference ``mixed_precision/decorator.py``):
    ``level="O2"`` casts every model's floating parameters and buffers to
    ``dtype`` (``m.to(dtype=...)``); the models (and optimizers) come
    back in the shapes given, a single model or a list. The optimizers'
    moments stay float32 (``Adam``/``AdamW``/``Momentum`` keep f32 slots
    whatever the parameter's dtype)."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=dtype)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Loss scaler (reference ``amp/grad_scaler.py:20`` → ``AmpScaler``):
    dynamic scaling doubles the scale every ``incr_every_n_steps`` good
    steps, halves it (not below 1) after ``decr_every_n_nan_or_inf`` bad
    ones, and a step whose gradients are not finite is skipped."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._last_step_skipped = False
        # one scale update per detected step outcome: set by unscale_ /
        # record_step, consumed by update(), so the reference's
        # `scaler.step(opt); scaler.update()` (step already updates)
        # counts no phantom good step
        self._pending_update = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, var):
        """``var`` times the scale (a tensor of ``var``'s dtype)."""
        if not self._enable:
            return var
        from ..core.tensor import to_tensor
        from ..ops import math_ops
        return math_ops.multiply(var, to_tensor(self._scale, dtype=var.dtype,
                                                place=var.device))

    def unscale_(self, optimizer):
        """Divide every gradient by the scale (in float32, stored in the
        gradient's dtype) and note whether any came out non-finite
        (reference ``amp/check_finite_and_unscale_op.cu``). A second call
        before ``step``/``update`` would divide twice and raises."""
        if not self._enable:
            return
        if self._unscaled:
            raise InvalidArgumentError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        inv = 1.0 / self._scale
        groups = {}
        with torch._C.DisableTorchFunctionSubclass(), torch.no_grad():
            for p in optimizer._params:
                g = p.grad
                if g is not None:
                    groups.setdefault((g.device, g.dtype), []).append(g)
            bad = []   # one flag a group, on the group's device
            for gs in groups.values():
                torch._foreach_mul_(gs, inv)
                norms = torch._foreach_norm(gs, float("inf"))
                bad.append(~torch.isfinite(torch.stack(norms)).all())
            found = bool(torch.stack([b.to(bad[0].device) for b in bad])
                         .any()) if bad else False
        self._found_inf = found
        self._unscaled = True
        self._pending_update = True

    def step(self, optimizer):
        """Unscale (unless done), skip the optimizer's update when a
        gradient is not finite, then the scale update;
        :meth:`last_step_skipped` says which happened."""
        if not self._enable:
            optimizer.step()
            self._last_step_skipped = False
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        self._last_step_skipped = self._found_inf
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False
        self.update()

    def minimize(self, optimizer, scaled_loss):
        """The reference's ``AmpScaler.minimize``: ``backward`` was called
        on the scaled loss; unscale, step unless non-finite, update."""
        self.step(optimizer)

    def last_step_skipped(self) -> bool:
        return self._last_step_skipped

    def record_step(self, found_inf: bool) -> float:
        """Feed one step outcome detected elsewhere (a compiled step's
        ``check_finite``) into the scale's state machine, without touching
        any gradient; returns the scale."""
        self._found_inf = bool(found_inf)
        self._pending_update = True
        self.update()
        return self._scale

    def update(self):
        """The scale update (reference ``amp/update_loss_scaling_op.cu``),
        once per detected step outcome: with nothing pending it does
        nothing."""
        if not self._pending_update:
            return
        self._pending_update = False
        self._unscaled = False
        if not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps, "enable": self._enable,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
