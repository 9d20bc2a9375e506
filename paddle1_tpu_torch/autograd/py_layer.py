"""User-defined differentiable functions (port of
``paddle1_tpu/autograd/py_layer.py``) over ``torch.autograd.Function``.

Subclass :class:`PyLayer` with ``forward(ctx, *args, **kwargs)`` and
``backward(ctx, *grads)`` staticmethods and call ``MyLayer.apply(...)``.
The forward runs without recording; ``backward`` gets one gradient per
tensor output and returns one gradient per differentiable tensor input
(None where there is none), the JAX package's rule. Tensors given to
``ctx.save_for_backward`` ride torch's saved-tensor machinery (no
reference cycle through the graph).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.errors import PreconditionNotMetError
from ..core.tensor import _wrap

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    """The ``ctx`` handed to ``forward``/``backward``."""

    def __init__(self):
        self._saved: Tuple = ()

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    @property
    def saved_tensor(self):
        return list(self._saved)

    def saved_tensors(self):
        return list(self._saved)


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        pctx = PyLayerContext()
        outs = layer.forward(pctx, *args, **kwargs)
        saved = pctx._saved
        idx = [i for i, s in enumerate(saved) if isinstance(s, torch.Tensor)]
        ctx.save_for_backward(*(saved[i] for i in idx))
        pctx._saved = tuple(None if i in idx else s
                            for i, s in enumerate(saved))
        ctx.pctx, ctx.layer, ctx.saved_idx = pctx, layer, idx
        ctx.n_in = len(args)
        ctx.tensor_in = [i for i, a in enumerate(args)
                         if isinstance(a, torch.Tensor)]
        return outs

    @staticmethod
    def backward(ctx, *grads):
        pctx = ctx.pctx
        saved = list(pctx._saved)
        for i, t in zip(ctx.saved_idx, ctx.saved_tensors):
            saved[i] = _wrap(t)
        pctx._saved = tuple(saved)
        gins = ctx.layer.backward(pctx, *(_wrap(g) for g in grads))
        if not isinstance(gins, (tuple, list)):
            gins = (gins,)
        diff = [i for i in ctx.tensor_in if ctx.needs_input_grad[i + 2]]
        if len(gins) != len(diff):
            raise PreconditionNotMetError(
                f"{ctx.layer.__name__}.backward returned {len(gins)} grads "
                f"for {len(diff)} differentiable inputs")
        out = [None] * ctx.n_in
        for i, g in zip(diff, gins):
            out[i] = g
        return (None, None, *out)


class PyLayer:
    """Subclass with ``forward(ctx, *args)`` and ``backward(ctx,
    *grads)`` staticmethods; call via ``MyLayer.apply(*args)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _wrap(_Function.apply(cls, kwargs, *args))
