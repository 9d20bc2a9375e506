"""Activation recomputation (port of
``paddle1_tpu/distributed/fleet/utils/recompute.py``).

``recompute(layer, *args)`` runs a segment without keeping its inner
activations; the backward runs it again. It is
``torch.utils.checkpoint.checkpoint`` with ``use_reentrant=False``: the
non-reentrant form works under ``torch.autograd.grad``, which
``ParallelEngine`` calls, and restores the RNG state for the second run
(``preserve_rng_state``), so dropout draws the same masks, as the JAX
package's explicit keys give.

The segment's parameters and buffers, as the layer holds them when the
segment runs, are inputs of the checkpoint and are bound back into the
layer for the second run (``torch.func.functional_call``). Inside
``ParallelEngine`` the layer holds the step's leaves (bf16 copies under
``amp_dtype``), swapped in for the forward only; the backward runs after
the swap is undone, so without this binding the second run would read
the f32 masters. As in the JAX package, an opaque callable (neither a
layer nor a bound method of one) runs on the normal graph with a
warning: its parameters cannot be bound, so nothing is dropped.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute", "recompute_sequential"]


class _Bound(nn.Module):
    """A bound method of a layer as a module, so ``functional_call`` can
    bind the layer's tensors around it."""

    def __init__(self, layer: nn.Module, method: Callable):
        super().__init__()
        self.layer = layer
        self._method = method

    def forward(self, *args):
        return self._method(*args)


def recompute(function: Callable, *args, **kwargs):
    """Run ``function(*args)`` without keeping its inner activations; the
    backward runs it again (``preserve_rng_state=True`` by default).
    ``use_reentrant`` is accepted; the port always takes the
    non-reentrant form."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if kwargs:
        raise TypeError(f"recompute got unexpected kwargs {list(kwargs)}")
    bound_self = getattr(function, "__self__", None)
    if isinstance(function, nn.Module):
        mod = function
    elif isinstance(bound_self, nn.Module):
        mod = _Bound(bound_self, function)
    else:
        warnings.warn(
            "recompute() got an opaque callable; its parameters cannot be "
            "bound, so activations are NOT discarded (gradients stay "
            "correct). Pass the layer itself (or its bound .forward) to get "
            "actual recomputation.", stacklevel=2)
        return function(*args)
    state = dict(mod.named_parameters(remove_duplicate=False))
    state.update(mod.named_buffers(remove_duplicate=False))
    names = list(state)

    def segment(*flat):
        bound = dict(zip(names, flat[:len(names)]))
        return torch.func.functional_call(mod, bound,
                                          tuple(flat[len(names):]))
    return checkpoint(segment, *state.values(), *args, use_reentrant=False,
                      preserve_rng_state=preserve)


class _Segment(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.ls = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.ls:
            x = layer(x)
        return x


def recompute_sequential(ctx: dict, functions, *args):
    """Recompute over a sequence of layers in ``ctx["segments"]`` chunks
    (default 1)."""
    segments = ctx.get("segments", 1)
    layers = list(functions)
    per = max(1, len(layers) // segments)
    x = args[0] if len(args) == 1 else args
    for i in range(0, len(layers), per):
        x = recompute(_Segment(layers[i:i + per]), x)
    return x
