"""The eager Paddle ``Tensor`` (port of ``paddle1_tpu/core/tensor.py``).

:class:`Tensor` is a ``torch.Tensor`` subclass, so every torch op and
every module of this package takes it as it is, and every op on it
returns a :class:`Tensor` again (its ``__torch_function__`` re-wraps the
results; that costs host time on each op, measured by ``chip_smoke.py``
phase 15 and written in PERF.md). ``torch.Tensor`` itself is never
patched: modules fed plain tensors see plain tensors.

Paddle's semantics on top of torch's:
- ``stop_gradient`` is ``not requires_grad``: True for a plain tensor
  (``to_tensor``'s default), False for a :class:`Parameter`. It is set on
  leaves; on an op's output (a view of torch's result, made by the
  re-wrapping) setting it True raises, and ``detach()`` is the way. A
  tensor that is not floating point has no gradient, so its
  ``stop_gradient`` stays True.
- ``.grad`` of a leaf is a :class:`Tensor`; ``clear_grad`` /
  ``clear_gradient`` set it to None; gradients accumulate over
  ``backward()`` calls.
- ``.numpy()`` works on a CUDA tensor and on one that requires grad, and
  is always a copy (later in-place updates do not show in it, as with the
  JAX package's immutable arrays); a bf16 tensor comes back as float32
  (numpy has no bf16), value for value.
- ``register_hook`` raises on a tensor with ``stop_gradient=True``.
- ``.place`` is a :class:`~.place.Place`; ``.shape`` is torch's
  ``torch.Size`` (a tuple: it indexes, iterates and converts with
  ``list()`` like Paddle's list), and ``.size()`` stays torch's method
  (``numel()`` is Paddle's ``size``).

:class:`Parameter` is a :class:`Tensor` and a ``torch.nn.Parameter``, so
modules register it like any parameter; :func:`as_paddle_parameters`
turns a module's ``torch.nn.Parameter``s into it in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.overrides import get_default_nowrap_functions

from . import dtype as dtypes
from .errors import InvalidArgumentError, PreconditionNotMetError
from .place import Place, _parse, get_device, place_of

__all__ = ["Tensor", "Parameter", "to_tensor", "as_paddle_parameters"]

_NOWRAP = get_default_nowrap_functions()
_plain = torch._C.DisableTorchFunctionSubclass


def _wrap(ret):
    """Torch results as :class:`Tensor` (a :class:`Parameter` stays one)."""
    if isinstance(ret, torch.Tensor):
        return ret if isinstance(ret, Tensor) else ret.as_subclass(Tensor)
    if isinstance(ret, (tuple, list)):
        return type(ret)(_wrap(r) for r in ret)
    return ret


class Tensor(torch.Tensor):
    """Eager tensor with Paddle's autograd semantics (see the module)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with _plain():
            ret = func(*args, **(kwargs or {}))
        return ret if func in _NOWRAP else _wrap(ret)

    # -- autograd flags -------------------------------------------------------

    @property
    def stop_gradient(self) -> bool:
        with _plain():
            return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value) -> None:
        value = bool(value)
        with _plain():
            if self.grad_fn is None:
                if value or self.is_floating_point() or self.is_complex():
                    self.requires_grad_(not value)
            elif value:
                raise PreconditionNotMetError(
                    "stop_gradient=True on an op's output: use "
                    "out = out.detach() (an op's output is a view of "
                    "torch's result and cannot be detached in place)")

    @property
    def grad(self) -> Optional["Tensor"]:
        with _plain():
            g = torch.Tensor.grad.__get__(self)
        return None if g is None else _wrap(g)

    @grad.setter
    def grad(self, value) -> None:
        with _plain():
            torch.Tensor.grad.__set__(self, value)

    def clear_grad(self) -> None:
        self.grad = None

    clear_gradient = clear_grad   # legacy alias

    # -- conversion -----------------------------------------------------------

    @property
    def place(self) -> Place:
        return place_of(self)

    def numpy(self) -> np.ndarray:
        """A host copy as a numpy array (bf16 as float32)."""
        with _plain():
            t = self.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return torch.Tensor.numpy(t).copy()

    def __float__(self) -> float:
        """``float(loss)`` as in Paddle: the value, with no warning when
        the tensor requires grad."""
        return float(self.item())

    # -- autograd -------------------------------------------------------------

    def backward(self, grad_tensor=None, retain_graph: bool = False) -> None:
        """Reverse mode from this tensor (``autograd.engine.run_backward``):
        gradients accumulate into the leaves' ``.grad``."""
        from ..autograd import engine
        engine.run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def register_hook(self, hook):
        """Call ``hook(grad)`` on this tensor's gradient during backward
        (its return value, if not None, replaces the gradient). Returns a
        handle with ``remove()``."""
        if self.stop_gradient:
            raise PreconditionNotMetError(
                "Cannot register hook on a tensor with stop_gradient=True")

        def call(g):
            return hook(_wrap(g))
        return super().register_hook(call)


class Parameter(Tensor, torch.nn.Parameter):
    """Trainable tensor: ``stop_gradient=False`` (``trainable=True``),
    persistable. A ``torch.nn.Parameter`` too, so modules register it."""

    def __new__(cls, data, dtype=None, name=None, trainable: bool = True):
        t = data.detach() if isinstance(data, torch.Tensor) else \
            _as_torch(data, dtype)
        if dtype is not None:
            t = t.to(dtypes.convert_dtype(dtype))
        return torch.Tensor._make_subclass(cls, t, bool(trainable))

    def __init__(self, data, dtype=None, name=None, trainable: bool = True):
        self._param_name = name
        self.persistable = True

    @property
    def name(self) -> Optional[str]:
        """Paddle's parameter name (torch's read-only ``Tensor.name`` is
        shadowed here only)."""
        return self._param_name

    @property
    def trainable(self) -> bool:
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, value) -> None:
        self.stop_gradient = not value

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            with torch.no_grad():
                data = self.detach().clone(memory_format=torch.preserve_format)
            memo[id(self)] = type(self)(data, name=self.name,
                                        trainable=self.trainable)
        return memo[id(self)]


def _as_torch(data, dtype=None) -> torch.Tensor:
    """Data → a new CPU or same-device torch tensor, with the JAX
    package's dtype inference: Python bool/int/float/complex → bool,
    int64, the default float dtype, complex64; float64 numpy data (and
    lists of Python floats) → the default float dtype; other numpy
    dtypes kept."""
    if isinstance(data, torch.Tensor):
        with _plain():
            t = data.detach().clone()
        return t if dtype is None else t.to(dtypes.convert_dtype(dtype))
    if isinstance(data, (bool, int, float, complex)):
        if dtype is None:
            dtype = {bool: dtypes.bool_, int: dtypes.int64,
                     complex: dtypes.complex64}.get(
                type(data), dtypes.get_default_dtype())
        return torch.tensor(data, dtype=dtypes.convert_dtype(dtype))
    if isinstance(data, (np.ndarray, np.generic, list, tuple)):
        arr = np.asarray(data)
        if arr.dtype.kind not in "biufc":
            raise InvalidArgumentError(
                f"Cannot convert numpy dtype {arr.dtype} to a Tensor")
        if dtype is None and arr.dtype == np.float64:
            dtype = dtypes.get_default_dtype()
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        return t if dtype is None else t.to(dtypes.convert_dtype(dtype))
    raise InvalidArgumentError(
        f"Cannot convert {type(data).__name__} to Tensor")


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> Tensor:
    """Paddle's ``to_tensor``: a new leaf :class:`Tensor` holding a copy
    of ``data`` (numpy, Python scalars or lists, or a tensor) on
    ``place`` (a Place, 'cpu'/'gpu:0', or a torch.device; None → the
    current place, ``set_device``), with ``stop_gradient`` as given."""
    dev = (get_device() if place is None else _parse(place)).torch_device()
    t = _as_torch(data, dtype).to(dev)
    t = _wrap(t)
    if not stop_gradient:
        t.stop_gradient = False
    return t


def as_paddle_parameters(module: torch.nn.Module) -> torch.nn.Module:
    """Replace every ``torch.nn.Parameter`` of ``module`` (and its
    submodules) by a :class:`Parameter` over the same storage, in place;
    returns ``module``. Build optimizers after this call."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and not isinstance(p, Parameter):
                mod._parameters[name] = Parameter(
                    p.detach(), trainable=p.requires_grad)
    return module

