"""Eager autograd (port of ``paddle1_tpu/autograd/engine.py``).

The JAX package records a tape of ``jax.vjp`` closures and walks it with
dependency counts; here ``torch.autograd`` records and walks the graph,
and this module gives it Paddle's API and errors:
- ``no_grad``/``enable_grad`` (context managers and decorators),
  ``set_grad_enabled``/``is_grad_enabled``;
- :func:`run_backward` (``Tensor.backward``): accumulation into the
  leaves' ``.grad``, ``retain_graph``, and the backward-end callbacks;
- :func:`grad` (``paddle.grad``), which accumulates nothing and fires no
  callback.

A second backward through a freed graph raises PreconditionNotMetError;
a root with ``stop_gradient=True`` raises PreconditionNotMetError; a
non-scalar root without a gradient raises InvalidArgumentError.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..core.errors import InvalidArgumentError, PreconditionNotMetError
from ..core.tensor import _wrap, leaf_hooks_per_edge

__all__ = ["run_backward", "grad", "no_grad", "enable_grad",
           "is_grad_enabled", "set_grad_enabled",
           "register_backward_end_callback"]

_backward_end_callbacks: List[Callable[[], None]] = []


def no_grad(fn=None):
    """Context manager or decorator (``@no_grad`` and ``@no_grad()``)
    that records no graph."""
    ctx = torch.no_grad()
    return ctx(fn) if fn is not None else ctx


def enable_grad(fn=None):
    ctx = torch.enable_grad()
    return ctx(fn) if fn is not None else ctx


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    """Switch recording on or off for this thread now; the returned
    object also restores the previous mode when used as a context
    manager."""
    return torch.set_grad_enabled(bool(mode))


def register_backward_end_callback(fn: Callable[[], None]) -> None:
    """Call ``fn`` once after every completed ``backward()``."""
    if fn not in _backward_end_callbacks:
        _backward_end_callbacks.append(fn)


def _check_roots(tensors, grad_tensors):
    grads = []
    for t, g in zip(tensors, grad_tensors):
        if not t.requires_grad:
            raise PreconditionNotMetError(
                "backward() on a tensor with stop_gradient=True")
        if g is None:
            if t.nelement() != 1:
                raise InvalidArgumentError(
                    "grad must be provided for non-scalar backward root "
                    f"(shape {list(t.shape)})")
        else:
            g = torch.as_tensor(g, device=t.device).to(t.dtype)
        grads.append(g)
    return grads


def _freed(e: RuntimeError) -> bool:
    return "second time" in str(e) or "already been freed" in str(e)


def run_backward(tensors: Sequence[torch.Tensor],
                 grad_tensors: Sequence[Optional[torch.Tensor]],
                 retain_graph: bool = False) -> None:
    """Reverse pass from ``tensors``, accumulating into every leaf's
    ``.grad``; then the backward-end callbacks."""
    tensors = list(tensors)
    grads = _check_roots(tensors, grad_tensors)
    try:
        with leaf_hooks_per_edge(tensors):
            torch.autograd.backward(tensors, grads,
                                    retain_graph=bool(retain_graph))
    except RuntimeError as e:
        if _freed(e):
            raise PreconditionNotMetError(
                "backward() through a graph that an earlier backward() "
                "freed: pass retain_graph=True to the first one") from e
        raise
    for cb in list(_backward_end_callbacks):
        cb()


backward = run_backward


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph: bool = False, only_inputs: bool = True,
         allow_unused: bool = False) -> List[Optional[torch.Tensor]]:
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` (one per input; None for an unused input only with
    ``allow_unused``, else InvalidArgumentError). ``.grad`` is left
    alone. ``retain_graph`` defaults to ``create_graph``."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    grads = _check_roots(outputs, grad_outputs)
    retain = create_graph if retain_graph is None else bool(retain_graph)
    try:
        with leaf_hooks_per_edge(outputs):
            res = torch.autograd.grad(outputs, inputs, grads,
                                      retain_graph=retain,
                                      create_graph=create_graph,
                                      allow_unused=True)
    except RuntimeError as e:
        if _freed(e):
            raise PreconditionNotMetError(
                "grad() through a graph that an earlier backward freed") \
                from e
        raise
    if not allow_unused and any(r is None for r in res):
        raise InvalidArgumentError(
            "One of the differentiated tensors appears unused in the graph; "
            "pass allow_unused=True to return None for it")
    return [None if r is None else _wrap(r) for r in res]
