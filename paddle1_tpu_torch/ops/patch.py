"""Paddle's tensor methods on the port's ``Tensor`` (port of
``paddle1_tpu/ops/patch.py``).

Every name of ``math_ops`` and ``manip_ops`` (but the creation and random
ops) becomes a method of ``core.tensor.Tensor``, the Paddle facade, and
of ``core.tensor.ParamBase``, the parameter every port layer creates, as
the reference's ``Parameter`` is a ``Tensor`` with all its methods
(``paddle1_tpu/core/tensor.py:242-263``); ``torch.Tensor`` is never
patched. The operators stay torch's, whose meaning on a facade tensor is
already Paddle's, but for ``@`` and ``**``, which run the named ops
``matmul`` and ``pow`` (where ``auto_cast`` casts); ``__setitem__`` also
writes into a leaf that requires grad, as the reference does. On a
``ParamBase``, which keeps ``torch.nn.Parameter``'s disabled
``__torch_function__`` (its ops stay torch's own and pay no
re-wrapping), a method that runs Paddle's op returns its new tensors as
facade tensors, as the reference's return ``Tensor``s; the facade's own
``shape``, ``size``, ``place``, ``numpy`` and ``clear_grad`` are its
too.

Where a name is also a ``torch.Tensor`` method, the facade's method
follows the collision rule that ``core/tensor.py``'s docstring states:
Paddle's op in user code, torch's method when torch's own code calls it
(:func:`_torch_caller`) or when the call only makes sense as torch's.
The rule costs only where such a method is called; the facade's
``__torch_function__`` is unchanged. The in-place methods run torch's
own in-place op where torch allows the write and the result keeps the
tensor's shape and dtype (:func:`_fits`), else rebind the tensor to the
op's output (``core.tensor.update_in_place``).
"""

from __future__ import annotations

import functools
import inspect
import sys

import numpy as np
import torch

from ..core.tensor import ParamBase, Tensor, _in_place_blocked, _plain, \
    _wrap, to_tensor, update_in_place
from . import manip_ops as P
from . import math_ops as M

_ENABLED = torch._C._TorchFunctionState.ENABLED
_state = torch._C._get_torch_function_state

# creation and random ops take no tensor to hang on
_SKIP = {"zeros", "ones", "full", "empty", "arange", "linspace", "eye",
         "rand", "randn", "randint", "randperm", "meshgrid", "to_tensor",
         "uniform", "normal", "logspace", "shape"}


def in_torch_code() -> bool:
    """True while torch's own Python code runs on the facade: inside a
    torch function dispatched through ``Tensor.__torch_function__``
    (``DisableTorchFunctionSubclass``) or under ``DisableTorchFunction``."""
    return _state() != _ENABLED


def _torch_caller() -> bool:
    """Case 1 of the collision rule, for the facade method that calls
    this: whether torch's own code called that method, under torch's
    function dispatch (:func:`in_torch_code`) or from a module of the
    ``torch`` package (the method's caller's frame, two up from here)."""
    if _state() != _ENABLED:
        return True
    mod = sys._getframe(2).f_globals.get("__name__", "")
    return mod == "torch" or mod.startswith("torch.")


def _paddle(ret, self):
    """A Paddle op's result on ``self``: on a ``ParamBase`` (whose ops
    return plain tensors) its new tensors as facade tensors, ``self``
    itself as it is; on a facade tensor ``ret`` as it is."""
    if isinstance(self, Tensor) or ret is self:
        return ret
    if isinstance(ret, (tuple, list)):
        return type(ret)(_paddle(r, self) for r in ret)
    return _wrap(ret)


def _fits(x, *operands) -> bool:
    """Whether torch's in-place op on ``x`` gives the Paddle op's result:
    each operand None, a Python number or a tensor that broadcasts to
    ``x``'s shape, with ``x``'s dtype the result's."""
    with _plain():
        for o in operands:
            if o is None:
                continue
            if isinstance(o, torch.Tensor):
                if torch.broadcast_shapes(x.shape, o.shape) != x.shape:
                    return False
            elif not isinstance(o, (bool, int, float, np.number)):
                return False
            if torch.result_type(x, o) != x.dtype:
                return False
    return True


def _int_first(args, kwargs) -> bool:
    return bool(args) and isinstance(args[0], (int, np.integer)) and \
        not isinstance(args[0], bool)


def _tensor_first(args, kwargs) -> bool:
    return bool(args) and isinstance(args[0], torch.Tensor)


# case 2 beyond the generic keyword and argument-count tests
_TORCH_FORM = {name: _int_first for name in (
    "gather", "index_select", "scatter", "scatter_", "index_add",
    "transpose", "transpose_")}
_TORCH_FORM.update(max=_tensor_first, min=_tensor_first)


def _positional(fn) -> tuple:
    """The names of ``fn``'s positional parameters after the first, up to
    ``name``, and the names of all its parameters."""
    params = list(inspect.signature(fn).parameters.values())[1:]
    pos = []
    for p in params:
        if p.name == "name" or p.kind not in (p.POSITIONAL_ONLY,
                                              p.POSITIONAL_OR_KEYWORD):
            break
        pos.append(p.name)
    return len(pos), frozenset(p.name for p in params)


def _dispatch(name, paddle_fn, torch_fn):
    """The facade method ``name``: Paddle's ``paddle_fn`` but under the
    collision rule's two cases, where it is ``torch_fn``."""
    n_pos, names = _positional(paddle_fn)
    torch_form = _TORCH_FORM.get(name)

    @functools.wraps(paddle_fn)
    def method(self, *args, **kwargs):
        if _torch_caller() or len(args) > n_pos or \
                (kwargs and not names.issuperset(kwargs)) or \
                (torch_form is not None and torch_form(args, kwargs)):
            return torch_fn(self, *args, **kwargs)
        return _paddle(paddle_fn(self, *args, **kwargs), self)
    method.__qualname__ = f"Tensor.{name}"
    return method


def _property(name, paddle_fn, torch_prop):
    """``real``/``imag``: torch's property under torch's own code, else
    Paddle's method (``x.imag()``)."""
    def get(self):
        if _torch_caller():
            return torch_prop.__get__(self)
        return lambda *a, **k: _paddle(paddle_fn(self, *a, **k), self)
    return property(get, doc=f"Paddle's ``{name}()`` (a method); torch's "
                    f"property under torch's own code.")


def _param_method(fn):
    """A Paddle op that torch's Tensor lacks, as a ``ParamBase`` method."""
    @functools.wraps(fn)
    def method(self, *args, **kwargs):
        return _paddle(fn(self, *args, **kwargs), self)
    return method


# the facade's own members that a ParamBase shares
_FACADE_OWN = ("shape", "size", "place", "numpy", "clear_grad",
               "clear_gradient", "retain_grads")


def _install_table() -> None:
    table = {}
    for mod in (M, P):
        for name in mod.__all__:
            table.setdefault(name, getattr(mod, name))
    own = set(vars(Tensor))
    for name, fn in table.items():
        if name in _SKIP or name in own:
            continue
        torch_attr = getattr(torch.Tensor, name, None)
        if torch_attr is None:
            setattr(Tensor, name, fn)
            setattr(ParamBase, name, _param_method(fn))
            continue
        if inspect.isdatadescriptor(torch_attr):
            method = _property(name, fn, torch_attr)
        else:
            method = _dispatch(name, fn, torch_attr)
        setattr(Tensor, name, method)
        setattr(ParamBase, name, method)
    for name in _FACADE_OWN:
        setattr(ParamBase, name, vars(Tensor)[name])


def _in_place(name, paddle_fn, torch_fn):
    """Paddle's in-place method ``name``: the tensor takes
    ``paddle_fn(self, o)``, through ``torch_fn`` where that fits
    (:func:`update_in_place`); torch's method under the collision rule."""
    def method(self, o, **torch_kw):
        if torch_kw or _torch_caller():
            return torch_fn(self, o, **torch_kw)
        return update_in_place(self, paddle_fn, o,
                               native=torch_fn if _fits(self, o) else None)
    method.__name__ = name
    method.__qualname__ = f"Tensor.{name}"
    method.__doc__ = f"Paddle's in-place ``{name}``: ``self`` takes " \
        f"``{paddle_fn.__name__}(self, o)``."
    return method


def _scale_native(x, scale, bias, bias_after_scale):
    """``M.scale``'s result written into ``x`` by torch's in-place ops."""
    if bias_after_scale:
        torch.Tensor.add_(torch.Tensor.mul_(x, scale), bias)
    else:
        torch.Tensor.mul_(torch.Tensor.add_(x, bias), scale)


def _clip_native(x, lo, hi):
    if lo is not None or hi is not None:
        torch.Tensor.clamp_(x, lo, hi)


def _negative_step(idx) -> bool:
    """Whether ``idx`` holds a slice with a negative step, which torch's
    indexing refuses."""
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, slice) and i.step is not None and i.step < 0
               for i in items)


def _dims_taken(i) -> int:
    """How many of the tensor's dims the index entry ``i`` consumes."""
    if i is None or i is Ellipsis or isinstance(i, bool):
        return 0
    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
        return i.dim()
    if isinstance(i, np.ndarray) and i.dtype == np.bool_:
        return i.ndim
    return 1


def flip_index(x, idx):
    """``x[idx]`` with negative-step slices as ``flip(x, dims)[pos]``:
    the dims those slices index, and ``idx`` with each of them turned into
    the positive slice that picks the same elements, in the same order, of
    the flipped dim (numpy's rules, as the reference indexes)."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    used = sum(_dims_taken(i) for i in items)
    dims, pos, d = [], [], 0
    for i in items:
        if i is Ellipsis:
            d += x.dim() - used
        elif isinstance(i, slice) and i.step is not None and i.step < 0:
            n = int(x.shape[d])
            r = range(*i.indices(n))
            pos.append(slice(n - 1 - r[0], n - r[-1], -i.step) if r
                       else slice(0, 0))
            dims.append(d)
            d += 1
            continue
        pos.append(i)
        d += _dims_taken(i)
    return dims, tuple(pos)


def _install_explicit(T) -> None:
    """Paddle's methods written out here, on the class ``T``."""

    def astype(self, dtype):
        """The tensor cast to ``dtype`` (a name, numpy or torch dtype)."""
        return _paddle(P.cast(self, dtype), self)
    T.astype = astype
    T.cast = astype

    def reshape(self, *shape, **torch_kw):
        """Paddle's ``reshape(shape)`` (a list, a tuple or a 1-D tensor),
        or the shape's ints given one by one."""
        if torch_kw or _torch_caller():
            return torch.Tensor.reshape(self, *shape, **torch_kw)
        if len(shape) == 1 and not isinstance(shape[0], (int, np.integer)):
            shape = shape[0]
        return _paddle(P.reshape(self, shape), self)
    T.reshape = reshape

    def numel(self, name=None):
        """Paddle's ``numel()``: the element count as a 0-d int64 tensor
        on this tensor's device; torch's int under torch's own code (the
        collision rule, case 1). The port's own modules call
        ``nelement()`` for the int."""
        if _torch_caller():
            return torch.Tensor.numel(self)
        return _paddle(P.numel(self), self)
    T.numel = numel

    def numel_(self):
        """The element count, an int."""
        return self.size
    T.numel_ = numel_

    T.add_ = _in_place("add_", M.add, torch.Tensor.add_)
    T.subtract_ = _in_place("subtract_", M.subtract, torch.Tensor.sub_)
    T.multiply_ = _in_place("multiply_", M.multiply, torch.Tensor.mul_)

    def scale_(self, scale_v=1.0, bias=0.0, bias_after_scale=True):
        return update_in_place(
            self, M.scale, scale_v, bias, bias_after_scale,
            native=_scale_native if _fits(self, scale_v, bias) else None)
    T.scale_ = scale_

    def clip_(self, min=None, max=None, **torch_kw):
        if torch_kw or _torch_caller():
            return torch.Tensor.clip_(self, min, max, **torch_kw)
        lo = min.item() if isinstance(min, torch.Tensor) else min
        hi = max.item() if isinstance(max, torch.Tensor) else max
        return update_in_place(self, M.clip, lo, hi,
                               native=_clip_native if _fits(self, lo, hi)
                               else None)
    T.clip_ = clip_

    def zero_(self):
        if _torch_caller():
            return torch.Tensor.zero_(self)
        return update_in_place(self, P.zeros_like,
                               native=torch.Tensor.zero_)
    T.zero_ = zero_

    def fill_(self, value):
        if _torch_caller():
            return torch.Tensor.fill_(self, value)
        return update_in_place(self, P.full_like, value,
                               native=torch.Tensor.fill_)
    T.fill_ = fill_

    def set_value(self, value):
        """Overwrite the data with ``value`` (a tensor or array data), cast
        to this tensor's dtype, outside the graph."""
        v = value if isinstance(value, torch.Tensor) else to_tensor(
            np.asarray(value), place=self.device)
        with torch.no_grad():
            v = v.detach().to(device=self.device, dtype=self.dtype)
            if tuple(v.shape) == tuple(self.shape):
                torch.Tensor.copy_(self, v)
            else:
                self.data = v
        return self
    T.set_value = set_value

    def get_tensor(self):
        return self
    T.get_tensor = get_tensor

    def __getitem__(self, idx):
        """torch's indexing, and numpy's negative-step slices (``x[::-1]``,
        ``x[..., ::-1]``) as a flip and a positive slice (F20), gradients
        included."""
        if not _negative_step(idx):
            return torch.Tensor.__getitem__(self, idx)
        dims, pos = flip_index(self, idx)
        return torch.Tensor.__getitem__(torch.flip(self, dims), pos)
    T.__getitem__ = __getitem__

    def __setitem__(self, idx, value):
        """torch's item assignment; into a leaf that requires grad (which
        torch refuses) the updated copy replaces the tensor, gradients
        flowing through the assignment, as the reference rebinds (a
        ``ParamBase`` takes the copy's data, as ``update_in_place``
        rebinds a tensor that is not a facade). A negative-step slice
        writes through a flipped copy that then replaces the values."""
        if _negative_step(idx):
            dims, pos = flip_index(self, idx)
            out = torch.flip(self, dims)
            torch.Tensor.__setitem__(out, pos, value)
            out = torch.flip(out, dims)
            if not _in_place_blocked(self):
                torch.Tensor.copy_(self, out)
                return
        elif _torch_caller() or not _in_place_blocked(self):
            return torch.Tensor.__setitem__(self, idx, value)
        else:
            out = torch.clone(self)
            torch.Tensor.__setitem__(out, idx, value)
        if isinstance(self, Tensor):
            self._replace_impl(out)
        else:
            self.data = out.detach()
    T.__setitem__ = __setitem__


def _install_operators() -> None:
    """The facade's ``@`` and ``**`` through the named ops ``matmul`` and
    ``pow``, as ``paddle1_tpu/ops/patch.py:42-48`` sends them, so that
    ``auto_cast`` casts them there; the other operators stay torch's. A
    ``ParamBase`` keeps torch's operators (its ops are torch's own)."""
    Tensor.__matmul__ = lambda s, o: M.matmul(s, o)
    Tensor.__rmatmul__ = lambda s, o: M.matmul(o, s)
    Tensor.__pow__ = lambda s, o: M.pow(s, o)
    Tensor.__rpow__ = lambda s, o: M.pow(o, s)


def _install() -> None:
    _install_explicit(Tensor)
    _install_explicit(ParamBase)
    _install_table()
    _install_operators()


_install()
