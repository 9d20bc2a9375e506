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
- ``register_hook`` raises on a tensor with ``stop_gradient=True``. A
  leaf's hooks fire on each incoming edge's gradient before it is
  accumulated, as the JAX package's engine fires them
  (:func:`leaf_hooks_per_edge`); an op output's hooks fire on its summed
  gradient (torch's tensor hooks), as there.
- An in-place functional that changes the value or dtype
  (``F.softmax_``) replaces the tensor by the op's output
  (:meth:`Tensor._replace_impl`), gradients included.
- ``.place`` is a :class:`~.place.Place`.
- ``.shape`` is a :class:`Shape`, a tuple that also compares equal to
  the list the reference returns (``x.shape == [2, 3]``), adds to a list
  as that list does (``x.shape[:-1] + [h, d]`` is a list) and has
  ``numel()``; ``torch.Size`` cannot be subclassed, and a tuple keeps
  torch's own Python code, which indexes, unpacks and passes shapes on,
  working. ``.size`` is the element count, an int as in the reference,
  whose call ``x.size()`` / ``x.size(dim)`` is torch's method.
  ``.dtype`` is torch's dtype (``torch.dtype`` cannot be subclassed, and
  torch's and the port's code pass it on): it equals no string or numpy
  dtype, where the reference's numpy dtype does (ROADMAP, a departure by
  design); ``core.dtype.convert_dtype`` and ``x.astype('float32')`` take
  the names.
- ``max``, ``min`` (``axis=None, keepdim=False``) and ``sort`` (``axis=-1,
  descending=False``) are Paddle's: they return one Tensor (the reduced
  values, the sorted values), where torch's return ``(values, indices)``.
  Called with torch's ``dim=`` keyword (or ``stable=`` for ``sort``),
  or ``max``/``min`` with another tensor, they keep torch's meaning.
  Only the facade changes: a plain ``torch.Tensor`` keeps torch's.
- These and the rest of the Paddle methods come from the op namespace
  (``ops/patch.py``, installed when the package is imported): the
  operators stay torch's (their meaning is Paddle's), and every name of
  ``ops.math_ops``/``ops.manip_ops`` becomes a method. Where the name is
  also a ``torch.Tensor`` method, the call means Paddle's op in user code
  and torch's method in two cases (the collision rule):
  1. torch's own Python code calls it: the method's caller is a module of
     the ``torch`` package (``parameters_to_vector``'s ``param.view(-1)``,
     a ``torch.nn`` module's ``forward``, ``Tensor.__repr__``), read from
     the caller's frame, or the call runs under torch's function dispatch.
     Every torch function on the facade runs under ``_plain()``
     (``DisableTorchFunctionSubclass``), and so does torch Python code
     that dispatches through ``handle_torch_function`` (``torch.split``,
     ``F.multi_head_attention_forward``, ...); there
     ``torch._C._get_torch_function_state()`` is not ``ENABLED``
     (``ops.patch.in_torch_code``). ``torch.split(x, 3, 1)`` calls
     ``x.split(3, 1)`` positionally and keeps torch's meaning. Code outside
     the ``torch`` package is user code, whatever its idiom: a user's
     ``sum(p.numel() for p in model.parameters())`` on Paddle parameters
     adds 0-d tensors, as in Paddle, and a user function that torch calls
     back (a hook, a ``forward`` of the user's own) gets Paddle's meaning.
  2. The call only makes sense as torch's: a keyword Paddle's op does
     not take (``dim=``, ``sorted=``, ``out=``, ``alpha=``), more
     positional arguments than Paddle's op takes before ``name``
     (``x.view(2, 3)``, ``x.expand(4, -1)``), an int first argument to
     ``gather``/``index_select``/``scatter``/``index_add``, or an int
     first argument to ``transpose``.
  ``x.split(3, 1)`` is read as Paddle's (3 parts along axis 1): the
  port's own modules call torch functions with keywords instead.
  ``numel()`` in user code is Paddle's 0-d int64 tensor on the tensor's
  device, and torch's int under case 1; the port's own modules call
  ``nelement()``. ``real``/``imag`` are Paddle's methods in user code
  and torch's properties under case 1, and ``cpu()``,
  ``cuda()``, ``contiguous()`` and ``pin_memory()`` torch's methods, which
  move or lay out the data.
- Paddle's in-place methods (``add_``, ``scale_``, ``clip_``, ``zero_``,
  ``reshape_``, ...) and ``__setitem__`` run torch's own in-place op
  where torch allows the write and the result keeps the tensor's shape
  and dtype, else replace the tensor by the op's output
  (:func:`update_in_place`), as the reference rebinds.

:class:`ParamBase` is the parameter every port layer creates
(``nn.Layer.create_parameter``): a ``torch.nn.Parameter`` with Paddle's
attributes (``name``, ``trainable``/``stop_gradient``, ``optimize_attr``,
``regularizer``, ``need_clip``, ``persistable``) and the facade's methods
under the same collision rule (``ops/patch.py``: ``w.split(3, 1)``,
``w.numel()``, ``set_value``, ``numpy()``, ``shape``, ``place``; their
new tensors are facades), but no facade ``__torch_function__``, so ops
and operators on it stay torch's own, return plain tensors and pay no
re-wrapping. :class:`Parameter` is a
:class:`Tensor` and a :class:`ParamBase`, so modules register it like any
parameter; :func:`as_paddle_parameters` turns a module's parameters into
it in place, their attributes kept.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Optional

import numpy as np
import torch
from torch.autograd.graph import get_gradient_edge, increment_version
from torch.overrides import get_default_nowrap_functions

from . import dtype as dtypes
from .errors import InvalidArgumentError, PreconditionNotMetError
from .place import Place, _parse, get_device, place_of

__all__ = ["Tensor", "Parameter", "ParamBase", "Shape", "to_tensor",
           "as_paddle_parameters", "leaf_hooks_per_edge",
           "update_in_place"]

_NOWRAP = get_default_nowrap_functions()
_plain = torch._C.DisableTorchFunctionSubclass
# leaves with Paddle hooks, and tensors replaced by an in-place op's output
# (``id -> tensor``); while both are empty, an op and a backward pay for
# neither but one truth test
_hooked: "weakref.WeakValueDictionary[int, Tensor]" = \
    weakref.WeakValueDictionary()
_replaced: "weakref.WeakValueDictionary[int, Tensor]" = \
    weakref.WeakValueDictionary()
# methods that write into their first argument, or read an attribute: the
# replaced tensor itself, not its stand-in, is what they mean
_IN_PLACE_DUNDERS = frozenset(
    f"__{op}__" for op in ("get", "set", "setitem", "iadd", "isub", "imul",
                           "itruediv", "ifloordiv", "imod", "ipow", "iand",
                           "ior", "ixor", "ilshift", "irshift", "imatmul"))


def _wrap(ret):
    """Torch results as :class:`Tensor` (a :class:`Parameter` stays one)."""
    if isinstance(ret, torch.Tensor):
        return ret if isinstance(ret, Tensor) else ret.as_subclass(Tensor)
    if isinstance(ret, (tuple, list)):
        return type(ret)(_wrap(r) for r in ret)
    return ret


def _stand_in(a):
    """What an op under grad mode is handed for ``a``: the output that
    replaced it (:meth:`Tensor._replace_impl`) while ``a`` is unchanged
    since, else ``a``."""
    if a is None or _replaced.get(id(a)) is not a:
        return a
    out, version = a._replacement
    with _plain():
        if a._version == version:
            return out
    del _replaced[id(a)]
    return a


def _stand_ins(func, args, kwargs):
    name = getattr(func, "__name__", "")
    if name in _IN_PLACE_DUNDERS or (name.endswith("_") and
                                     not name.endswith("__")):
        return args, kwargs
    sub = lambda a: (type(a)(_stand_in(x) for x in a)  # noqa: E731
                     if isinstance(a, (list, tuple)) else _stand_in(a))
    return (tuple(sub(a) for a in args),
            {k: v if k == "out" else sub(v) for k, v in kwargs.items()})


def _fire(hooks, g):
    """A leaf's Paddle hooks in order on one edge's gradient; a hook's
    result, if not None, replaces the gradient."""
    for entry in list(hooks):
        if entry[0] is not None:
            res = entry[0](_wrap(g))
            if res is not None:
                g = res
    return g


def leaf_hooks_per_edge(roots):
    """Context for one backward pass from ``roots``: fire the Paddle hooks
    of every leaf under them on each incoming edge's gradient, before
    accumulation, through a post-hook on each graph node that has an edge
    to a hooked leaf (``paddle1_tpu/autograd/engine.py:438-449`` fires them
    per edge; torch's own leaf hook would see their sum). While no leaf has
    a Paddle hook it does nothing."""
    return _per_edge(roots) if _hooked else contextlib.nullcontext()


@contextlib.contextmanager
def _per_edge(roots):
    accs = {}
    for t in list(_hooked.values()):
        with _plain():
            if t.requires_grad and t.grad_fn is None:
                accs[get_gradient_edge(t).node] = t._paddle_hooks
    handles = []
    try:
        if accs:
            seen = set()
            todo = [r.grad_fn for r in roots
                    if isinstance(r, torch.Tensor) and r.grad_fn is not None]
            while todo:
                node = todo.pop()
                if node in seen:
                    continue
                seen.add(node)
                edges = []
                for i, (nxt, _) in enumerate(node.next_functions):
                    if nxt is None:
                        continue
                    if nxt in accs:
                        edges.append((i, accs[nxt]))
                    else:
                        todo.append(nxt)
                if edges:
                    def post(grad_inputs, _, edges=edges):
                        gi = list(grad_inputs)
                        for i, hooks in edges:
                            if gi[i] is not None:
                                gi[i] = _fire(hooks, gi[i])
                        return tuple(gi)
                    handles.append(node.register_hook(post))
        yield
    finally:
        for h in handles:
            h.remove()


class _HookHandle:
    def __init__(self, tensor, entry):
        self._tensor, self._entry = weakref.ref(tensor), entry

    def remove(self) -> None:
        self._entry[0] = None
        t = self._tensor()
        if t is not None and all(e[0] is None for e in t._paddle_hooks):
            _hooked.pop(id(t), None)


class Shape(tuple):
    """A tensor's shape on the facade: a tuple of ints that compares
    equal to the list of the same ints too (the reference's ``shape`` is
    a list), with ``torch.Size``'s ``numel()``. A slice is a ``Shape``,
    and a sum with a list is the list the reference's sum gives
    (``x.shape[:-1] + [h, d]``, ``[b] + x.shape[1:]``); a sum with a tuple
    is a ``Shape``. Item assignment stays a tuple's: it raises (ROADMAP,
    a departure by design)."""

    __slots__ = ()

    def __getitem__(self, idx):
        got = tuple.__getitem__(self, idx)
        return Shape(got) if isinstance(idx, slice) else got

    def __add__(self, other):
        if isinstance(other, list):
            return list(self) + other
        if isinstance(other, tuple):
            return Shape(tuple.__add__(self, other))
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, list):
            return other + list(self)
        if isinstance(other, tuple):
            return Shape(tuple(other) + tuple(self))
        return NotImplemented

    def __eq__(self, other):
        if isinstance(other, list):
            other = tuple(other)
        return tuple.__eq__(self, other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__

    def numel(self) -> int:
        n = 1
        for s in self:
            n *= s
        return n


class _Numel(int):
    """``Tensor.size``: the element count (Paddle's ``size`` property),
    and, called, torch's ``Tensor.size(dim=None)``."""

    def __call__(self, dim=None):
        t = self._tensor
        return torch.Tensor.size(t) if dim is None else \
            torch.Tensor.size(t, dim)


class Tensor(torch.Tensor):
    """Eager tensor with Paddle's autograd semantics (see the module)."""

    def __new__(cls, data, dtype=None, place=None,
                stop_gradient: bool = True, name=None):
        """Paddle's constructor (``paddle1_tpu/core/tensor.py:76``): a new
        leaf holding a copy of ``data`` with :func:`to_tensor`'s dtypes
        (``Tensor(3)`` a 0-d int64, ``Tensor(2.5)`` a 0-d float, numpy
        dtypes kept) on ``place`` (None: the current place). torch's own
        ways to make a subclass (``_make_subclass``, ``as_subclass``,
        unpickling) do not come here."""
        dev = (get_device() if place is None else _parse(place)).\
            torch_device()
        t = torch.Tensor._make_subclass(cls, _as_torch(data, dtype).to(dev),
                                        False)
        if not stop_gradient:
            t.stop_gradient = False
        if name is not None:
            t.name = name
        return t

    @property
    def name(self) -> Optional[str]:
        """Paddle's tensor name (None unless given; torch's read-only
        ``Tensor.name`` is shadowed here only)."""
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value) -> None:
        self._param_name = value

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _replaced and torch.is_grad_enabled():
            args, kwargs = _stand_ins(func, args, kwargs)
        with _plain():
            ret = func(*args, **kwargs)
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

    def retain_grads(self) -> None:
        """Keep this tensor's gradient in ``.grad`` after backward, an
        op's output too (torch's ``retain_grad``)."""
        with _plain():
            if self.requires_grad and self.grad_fn is not None:
                self.retain_grad()

    persistable = False

    clear_gradient = clear_grad   # legacy alias

    # -- Paddle's metadata and methods where torch's differ ----------------------

    @property
    def shape(self) -> Shape:
        with _plain():
            return Shape(torch.Tensor.shape.__get__(self))

    @property
    def size(self) -> int:
        with _plain():
            n = _Numel(torch.Tensor.numel(self))
        n._tensor = self
        return n

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

    def __deepcopy__(self, memo):
        """A new leaf with a copy of the data (its memory format kept) and
        the same ``stop_gradient``, as the reference's deepcopy."""
        if id(self) not in memo:
            with _plain():
                data = self.detach().clone(
                    memory_format=torch.preserve_format)
            new = _wrap(data)
            new.stop_gradient = self.stop_gradient
            memo[id(self)] = new
        return memo[id(self)]

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
        (its return value, if not None, replaces the gradient): on a leaf,
        once per incoming edge before accumulation (fired by
        :func:`leaf_hooks_per_edge` around each backward); on an op's
        output, once on the summed gradient. Returns a handle with
        ``remove()``."""
        if self.stop_gradient:
            raise PreconditionNotMetError(
                "Cannot register hook on a tensor with stop_gradient=True")
        with _plain():
            leaf = self.grad_fn is None
        if not leaf:
            def call(g):
                return hook(_wrap(g))
            return super().register_hook(call)
        entry = [hook]
        if "_paddle_hooks" not in self.__dict__:
            self._paddle_hooks = []
        self._paddle_hooks.append(entry)
        _hooked[id(self)] = self
        return _HookHandle(self, entry)

    def _replace_impl(self, other: torch.Tensor) -> None:
        """Paddle's in-place contract (``paddle1_tpu/core/tensor.py``
        ``_replace_impl``): this tensor takes ``other``'s value and dtype,
        and, where ``other`` carries a graph, ops under grad mode are
        handed ``other`` in its place until this tensor changes, so
        gradients flow through the op that made it, into this tensor's
        ``.grad`` when it is a leaf; an op's output that takes a constant
        passes no gradient back. torch allows no in-place write into
        a leaf that requires grad; the data is rebound instead. A graph
        recorded before that saved this tensor (not ``other``'s) cannot
        keep its old value: its backward raises, as after torch's in-place
        ops."""
        with _plain():
            graph = other.requires_grad
            # a copy when ``other`` has a graph: in-place updates of this
            # tensor must not reach the values that graph saved
            self.data = other.detach().clone() if graph else other.detach()
            # a graph that saved this tensor would read the new data:
            # its backward raises instead
            increment_version(self)
            # an op's output rebound to a constant leaves its graph, as
            # the reference's takes the constant's (no) node
            if graph or self.grad_fn is not None:
                self._replacement = (other, self._version)
                _replaced[id(self)] = self
            else:
                _replaced.pop(id(self), None)


def _in_place_blocked(x: torch.Tensor) -> bool:
    """Whether torch refuses an in-place write into ``x`` here: under grad
    mode, a leaf that requires grad or a view of one."""
    if not torch.is_grad_enabled():
        return False
    return any(t is not None and t.requires_grad and t.grad_fn is None
               for t in (x, x._base))


def _needs_copy(x: torch.Tensor, args) -> bool:
    """Whether an op on ``x`` and ``args`` may record a graph that saves
    ``x`` (grad mode on, and ``x`` or a tensor argument requires grad)."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args))


def update_in_place(x: torch.Tensor, op, *args, native=None):
    """Paddle's in-place contract, ``x`` <- ``op(x, *args)``; returns
    ``x``. Where torch allows an in-place write into ``x`` and the caller
    gives ``native`` (torch's own in-place op, given only where its result
    keeps ``x``'s shape and dtype), ``native(x, *args)`` runs: views of
    ``x`` see the change, and autograd records it as torch does, keeping
    the values that the graph saved (a backward that needs ``x``'s old
    value, as ``tanh``'s needs its output, raises as in torch). Otherwise
    ``x`` is rebound to ``op``'s output, as the reference rebinds: a Paddle
    tensor by :meth:`Tensor._replace_impl` (the gradient flows through
    ``op``), a plain tensor's data only. Under grad mode ``op`` then reads
    a copy of ``x``, so that what its graph saves is not what the
    rebinding replaces. A leaf that requires grad cannot change its shape
    under grad mode (torch accumulates its gradient in the leaf's own
    shape): that raises, where the reference rebinds."""
    with _plain():
        blocked = _in_place_blocked(x)
        if native is not None and not blocked:
            native(x, *args)
            return x
        copy = _needs_copy(x, args)
    out = op(torch.clone(x) if copy else x, *args)
    with _plain():
        if blocked and out.shape != x.shape:
            raise PreconditionNotMetError(
                f"an in-place op would change the shape of a tensor that "
                f"requires grad from {list(x.shape)} to {list(out.shape)}; "
                "use the op's out-of-place form")
        if not isinstance(x, Tensor):
            x.data = out.detach()
            return x
    x._replace_impl(out)
    return x


_PARAM_ATTRS = ("_param_name", "regularizer", "need_clip", "persistable",
                "sharding_axes")


def _copy_param_attrs(src, dst) -> None:
    """``dst`` takes ``src``'s Paddle attributes (a fresh
    ``optimize_attr`` dict)."""
    for a in _PARAM_ATTRS:
        if a in src.__dict__:
            setattr(dst, a, src.__dict__[a])
    dst.optimize_attr = dict(getattr(src, "optimize_attr",
                                     {"learning_rate": 1.0}))


class ParamBase(torch.nn.Parameter):
    """A ``torch.nn.Parameter`` with the JAX package's Parameter
    attributes (``paddle1_tpu/core/tensor.py:246-263``): ``name`` (None
    until a layer registers it as ``f"{full_name}.{attr}"``),
    ``trainable`` / ``stop_gradient`` (``requires_grad``),
    ``optimize_attr`` (``{"learning_rate": scale}``), ``regularizer``,
    ``need_clip``, ``persistable`` and ``sharding_axes``; ``ops/patch.py`` gives it the
    facade's methods. Ops on it are torch's own: it keeps
    ``torch.nn.Parameter``'s disabled ``__torch_function__``. A deep copy
    keeps the name, as the JAX package's does."""

    def __new__(cls, data=None, requires_grad: bool = True, name=None):
        if data is None:
            data = torch.empty(0)
        with _plain():
            t = data.detach()
        return torch.Tensor._make_subclass(cls, t, bool(requires_grad))

    def __init__(self, data=None, requires_grad: bool = True, name=None):
        self._param_name = name
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.persistable = True
        # per-dimension mesh-axis names, e.g. (None, "mp") for a
        # column-parallel weight (``text.models.apply_megatron_sharding``);
        # ``distributed.ParallelEngine`` cuts the tensor to its shard
        self.sharding_axes = None

    @property
    def name(self) -> Optional[str]:
        """Paddle's parameter name (torch's read-only ``Tensor.name`` is
        shadowed here only)."""
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value) -> None:
        self._param_name = value

    @property
    def stop_gradient(self) -> bool:
        with _plain():
            return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value) -> None:
        with _plain():
            self.requires_grad_(not bool(value))

    @property
    def trainable(self) -> bool:
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, value) -> None:
        self.stop_gradient = not value

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            with torch.no_grad(), _plain():
                data = self.detach().clone(
                    memory_format=torch.preserve_format)
                new = ParamBase(data, self.requires_grad)
            _copy_param_attrs(self, new)
            memo[id(self)] = new
        return memo[id(self)]


class Parameter(Tensor, ParamBase):
    """Trainable tensor: ``stop_gradient=False`` (``trainable=True``),
    persistable, with :class:`ParamBase`'s attributes. A
    ``torch.nn.Parameter`` too, so modules register it."""

    def __new__(cls, data, dtype=None, name=None, trainable: bool = True):
        t = data.detach() if isinstance(data, torch.Tensor) else \
            _as_torch(data, dtype)
        if dtype is not None:
            t = t.to(dtypes.convert_dtype(dtype))
        return torch.Tensor._make_subclass(cls, t, bool(trainable))

    def __init__(self, data, dtype=None, name=None, trainable: bool = True):
        ParamBase.__init__(self, name=name)

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            with torch.no_grad():
                data = self.detach().clone(memory_format=torch.preserve_format)
            new = type(self)(data, trainable=self.trainable)
            _copy_param_attrs(self, new)
            memo[id(self)] = new
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
    submodules) by a :class:`Parameter` over the same storage, in place,
    keeping its name and Paddle attributes; returns ``module``. Build
    optimizers after this call."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and not isinstance(p, Parameter):
                new = Parameter(p.detach(), trainable=p.requires_grad)
                if isinstance(p, ParamBase):
                    _copy_param_attrs(p, new)
                mod._parameters[name] = new
    return module
