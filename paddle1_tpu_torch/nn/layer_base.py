"""``nn.Layer`` — the module system (port of ``paddle1_tpu/nn/layer_base.py``).

:class:`Layer` is a ``torch.nn.Module`` with the JAX ``Layer``'s surface:

* naming: each layer takes ``f"{name_scope}_{n}"`` from a per-class
  counter (``name_scope`` defaults to the class name in lower case), its
  :meth:`full_name`; a parameter registered on it without a name becomes
  ``f"{full_name}.{attr}"`` (``layer_base.py:40-44,79-90``), the name the
  optimizer reads for ``apply_decay_param_fun`` and its state keys;
* registration: :meth:`add_parameter`, :meth:`add_sublayer`,
  :meth:`register_buffer` (``persistable=``) and :meth:`create_parameter`
  (``ParamAttr``'s name, initializer, ``trainable``, ``learning_rate`` as
  ``optimize_attr``, ``regularizer`` and ``need_clip``);
* traversal: :meth:`named_parameters`/:meth:`parameters`,
  :meth:`named_sublayers`/:meth:`sublayers`, :meth:`named_buffers`/
  :meth:`buffers` (lists), ``children`` and ``apply``;
* hooks: :meth:`register_forward_pre_hook` /
  :meth:`register_forward_post_hook`, each returning a
  :class:`HookRemoveHelper`;
* state: :meth:`state_dict` and :meth:`set_state_dict` (``set_dict``,
  ``load_dict``), which returns ``(missing, unexpected)`` and raises on a
  shape mismatch;
* dtype and device: :meth:`to`, :meth:`astype`, ``float``, ``bfloat16``;
* :meth:`clear_gradients`, ``extra_repr``.

Where Paddle's and torch's signatures clash (``state_dict``,
``parameters``, ``named_parameters``, ``buffers``, ``to``) both forms are
taken, so torch's own callers (``functional_call``, ``checkpoint``,
``load_state_dict``, the recursive ``state_dict(prefix=..., keep_vars=...)``)
keep working, and ``state_dict`` keys are torch's structured names.

Parameters are :class:`~paddle1_tpu_torch.core.tensor.ParamBase`: plain
``torch.nn.Parameter``s to every op, so a layer costs no host time per op.
``Sequential``, ``LayerList``, ``LayerDict`` and ``ParameterList``
(``paddle1_tpu/nn/layer_norm_act.py:428-530``) are Layers too.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.errors import InvalidArgumentError
from ..core.tensor import ParamBase

__all__ = ["Layer", "HookRemoveHelper", "Sequential", "LayerList",
           "LayerDict", "ParameterList"]

_global_layer_name_counts: Dict[str, int] = {}


def _unique_name(prefix: str) -> str:
    n = _global_layer_name_counts.get(prefix, 0)
    _global_layer_name_counts[prefix] = n + 1
    return f"{prefix}_{n}"


class HookRemoveHelper:
    """Handle of a forward hook: :meth:`remove` takes it off."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self) -> None:
        self._handle.remove()


def _as_torch(value) -> torch.Tensor:
    """A state-dict value (a torch or Paddle tensor, numpy, or anything
    with ``numpy()``, such as the JAX package's Tensor) as a torch
    tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().as_subclass(torch.Tensor)
    if hasattr(value, "numpy") and not isinstance(value, np.ndarray):
        value = value.numpy()
    return torch.from_numpy(np.array(value, copy=True))


def _is_dtype(d) -> bool:
    if isinstance(d, torch.dtype):
        return True
    try:
        return isinstance(d, str) and dtypes.convert_dtype(d) is not None
    except InvalidArgumentError:
        return False


class Layer(torch.nn.Module):
    """Base class of every layer of the port (see the module)."""

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        self._full_name = _unique_name(
            name_scope or type(self).__name__.lower())
        self._dtype = dtypes.convert_dtype(dtype)

    # -- naming -------------------------------------------------------------

    def full_name(self) -> str:
        return self._full_name

    # -- registration -------------------------------------------------------

    def register_parameter(self, name: str, param) -> None:
        super().register_parameter(name, param)
        if isinstance(param, ParamBase) and param.name is None:
            param.name = f"{self.__dict__.get('_full_name', '')}.{name}"

    def add_parameter(self, name: str, parameter):
        if "." in name or name == "":
            raise InvalidArgumentError(f"Bad parameter name: {name!r}")
        if parameter is not None and \
                not isinstance(parameter, torch.nn.Parameter):
            raise InvalidArgumentError(
                f"add_parameter expects Parameter, got {type(parameter)}")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        if not isinstance(sublayer, torch.nn.Module):
            raise InvalidArgumentError(
                f"add_sublayer expects Layer, got {type(sublayer)}")
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[torch.Tensor],
                        persistable: bool = True, *,
                        persistent: Optional[bool] = None):
        """Paddle's ``persistable`` is torch's ``persistent``: a buffer
        that is not stays out of :meth:`state_dict`."""
        if "." in name or name == "":
            raise InvalidArgumentError(f"Bad buffer name: {name!r}")
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None, *,
                         device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> ParamBase:
        """A new parameter of ``shape`` (``layer_base.py:114-137``): its
        values from ``attr``'s initializer, else ``default_initializer``,
        else XavierUniform for a weight and Constant(0) for a bias, drawn
        from ``generator`` on the CPU and moved to ``device`` (None: the
        current place); its name, ``trainable``, ``optimize_attr``
        (``learning_rate``), ``regularizer`` and ``need_clip`` from
        ``attr`` (None, a ``ParamAttr``, a name or an initializer)."""
        from ..framework.param_attr import ParamAttr
        from .initializer import Constant, Initializer, XavierUniform
        dtype = dtypes.convert_dtype(dtype or self._dtype)
        attr = ParamAttr._to_attr(attr)
        init = (attr.initializer if attr and attr.initializer is not None
                else default_initializer)
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        if device is None:
            from ..core.place import get_device
            device = get_device().torch_device()
        if isinstance(init, Initializer):
            data = init(shape, dtype, generator=generator, device=device)
        else:
            data = _as_torch(init(shape, dtype)).to(device=device,
                                                    dtype=dtype)
        p = ParamBase(data, attr.trainable if attr else True,
                      name=attr.name if attr else None)
        if attr is not None:
            p.regularizer = attr.regularizer
            p.optimize_attr = {"learning_rate": attr.learning_rate}
            p.need_clip = attr.need_clip
        return p

    # -- traversal ----------------------------------------------------------

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True, *,
                         recurse: Optional[bool] = None
                         ) -> List[Tuple[str, torch.nn.Parameter]]:
        """``(structured name, parameter)`` pairs, this layer's first and
        then each sublayer's in registration order, a shared parameter
        once. Torch's ``recurse=`` is ``include_sublayers``."""
        if recurse is not None:
            include_sublayers = recurse
        return list(super().named_parameters(prefix, include_sublayers,
                                             remove_duplicate))

    def parameters(self, include_sublayers: bool = True, *,
                   recurse: Optional[bool] = None
                   ) -> List[torch.nn.Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_sublayers(self, prefix: str = "",
                        include_self: bool = False
                        ) -> List[Tuple[str, torch.nn.Module]]:
        """Every sublayer (pre-order, each once) with its structured
        name; this layer first, named ``prefix``, with ``include_self``."""
        out = list(self.named_modules(prefix=prefix))
        return out if include_self else out[1:]

    def sublayers(self, include_self: bool = False) -> List[torch.nn.Module]:
        return [l for _, l in self.named_sublayers(
            include_self=include_self)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      remove_duplicate: bool = True, *,
                      recurse: Optional[bool] = None
                      ) -> List[Tuple[str, torch.Tensor]]:
        if recurse is not None:
            include_sublayers = recurse
        return list(super().named_buffers(prefix, include_sublayers,
                                          remove_duplicate))

    def buffers(self, include_sublayers: bool = True, *,
                recurse: Optional[bool] = None) -> List[torch.Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    # -- hooks --------------------------------------------------------------

    def register_forward_pre_hook(self, hook, **torch_kw
                                  ) -> HookRemoveHelper:
        """``hook(layer, inputs)`` before each forward; a result that is
        not None replaces the inputs (a tuple, or one input)."""
        return HookRemoveHelper(
            super().register_forward_pre_hook(hook, **torch_kw))

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)`` after each forward; a result
        that is not None replaces the outputs."""
        return HookRemoveHelper(self.register_forward_hook(hook))

    # -- state --------------------------------------------------------------

    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   *, prefix: Optional[str] = None, keep_vars: bool = False):
        """Parameters and persistable buffers by structured name
        (detached, as torch's ``state_dict``; ``keep_vars=True`` gives the
        tensors themselves). Torch's ``prefix`` is
        ``structured_name_prefix``; without ``include_sublayers`` only this
        layer's own entries."""
        if prefix is None:
            prefix = structured_name_prefix
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        dest = OrderedDict() if destination is None else destination
        self._save_to_state_dict(dest, prefix, keep_vars)
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s values (torch or Paddle tensors, numpy)
        into the matching parameters and buffers in place, keyed by
        structured name (or, without ``use_structured_name``, by each
        tensor's ``name`` where it has one). Returns ``(missing,
        unexpected)``: this layer's keys that got no value, and the given
        keys that match nothing. A shape mismatch raises
        ``InvalidArgumentError`` (values before it are already copied, as
        in the JAX package)."""
        own = self.state_dict(keep_vars=True)
        if not use_structured_name:
            own = OrderedDict((getattr(t, "name", None) or k, t)
                              for k, t in own.items())
        unexpected, matched = [], set()
        for key, value in state_dict.items():
            if key not in own:
                unexpected.append(key)
                continue
            target, src = own[key], _as_torch(value)
            if tuple(target.shape) != tuple(src.shape):
                raise InvalidArgumentError(
                    f"Shape mismatch for {key!r}: expected "
                    f"{list(target.shape)}, got {list(src.shape)}")
            with torch._C.DisableTorchFunctionSubclass():
                target.copy_(src)
            matched.add(key)
        missing = [k for k in own if k not in matched]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype and device ---------------------------------------------------

    def to(self, device=None, dtype=None, blocking=None, **torch_kw):
        """Paddle's ``to(device, dtype, blocking)``: ``device`` a Place,
        ``'cpu'``/``'gpu:0'`` or a torch device, ``dtype`` a name or torch
        dtype (floating parameters and buffers are cast). Torch's forms
        (``to(tensor)``, ``to(dtype)``, ``non_blocking=``) are taken too."""
        if isinstance(device, torch.Tensor):
            return super().to(device, **torch_kw)
        if dtype is None and _is_dtype(device):
            device, dtype = None, device
        if device is not None:
            from ..core.place import _parse
            device = _parse(device).torch_device()
        if blocking is not None:
            torch_kw["non_blocking"] = not blocking
        if dtype is not None:
            dtype = dtypes.convert_dtype(dtype)
        return super().to(device=device, dtype=dtype, **torch_kw)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- gradients ----------------------------------------------------------

    def clear_gradients(self) -> None:
        """Every parameter's gradient to None."""
        for p in self.parameters():
            p.grad = None


# ---------------------------------------------------------------------------
# Containers


def _index(n: int, idx: int) -> int:
    i = idx + n if idx < 0 else idx
    if not 0 <= i < n:
        raise IndexError(f"index {idx} is out of range")
    return i


class Sequential(Layer):
    """Layers called in order, named ``"0"``, ``"1"``, ... or by the
    names of an ``OrderedDict`` or of ``(name, layer)`` pairs."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, l in layers[0].items():
                self.add_sublayer(name, l)
        else:
            for i, l in enumerate(layers):
                if isinstance(l, tuple):
                    self.add_sublayer(l[0], l[1])
                else:
                    self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """A list of sublayers, named ``"0"``, ``"1"``, ..."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return LayerList(layers[idx])
        return layers[idx]

    def __setitem__(self, idx, layer) -> None:
        self.add_sublayer(str(_index(len(self), idx)), layer)

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def insert(self, index: int, layer) -> None:
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self.add_sublayer(str(i), l)

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class ParameterList(Layer):
    """A list of parameters, named ``"0"``, ``"1"``, ..."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self) -> int:
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    """Sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer) -> None:
        self.add_sublayer(key, layer)

    def __delitem__(self, key) -> None:
        del self._modules[key]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key) -> bool:
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers) -> None:
        items = sublayers.items() if hasattr(sublayers, "items") \
            else sublayers
        for k, l in items:
            self.add_sublayer(k, l)
