"""Object checkpoints: ``save`` / ``load`` (port of
``paddle1_tpu/framework/io.py``).

A pickle of nested dicts, lists and tuples in which every tensor is a
:class:`_TensorPayload` (a numpy array, its dtype's name, whether it was
a Parameter, its name and ``stop_gradient``); everything else passes
through pickle unchanged, so a model's ``state_dict()``, an optimizer's
state and the step count round-trip together. bf16 has no numpy dtype:
its bits travel as uint16 and come back exactly.

The format is this package's own. A file the JAX package wrote names
``paddle1_tpu.framework.io._TensorPayload`` inside its pickle, and
reading it would import the JAX package, which this package never does;
so each package reads only its own files (move weights across with
``convert.state_from_jax``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.place import get_device
from ..core.tensor import Parameter, _wrap

__all__ = ["save", "load"]

_PROTOCOL = 4


class _TensorPayload:
    """Pickle surrogate for a tensor; keeps its dtype (bf16 included)
    exactly."""

    def __init__(self, t: torch.Tensor):
        self.is_parameter = isinstance(t, torch.nn.Parameter)
        self.name = getattr(t, "name", None)
        self.stop_gradient = not t.requires_grad
        t = t.detach().cpu()
        self.dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        self.array = torch.Tensor.numpy(t.as_subclass(torch.Tensor)).copy()

    def tensor(self) -> torch.Tensor:
        t = torch.from_numpy(self.array.copy())
        return t.view(torch.bfloat16) if self.dtype == "bfloat16" else t

    def numpy(self) -> np.ndarray:
        """The values as numpy (bf16 as float32)."""
        if self.dtype == "bfloat16":
            return self.tensor().float().numpy()
        return self.array


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_pack(v) for v in obj)
    return obj


def _unpack(obj: Any, device, return_numpy: bool) -> Any:
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.numpy()
        t = obj.tensor().to(device)
        if dtypes.convert_dtype(obj.dtype) != t.dtype:
            t = t.to(dtypes.convert_dtype(obj.dtype))
        if obj.is_parameter:
            return Parameter(t, name=obj.name,
                             trainable=not obj.stop_gradient)
        t = _wrap(t)
        if not obj.stop_gradient:
            t.stop_gradient = False
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v, device, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, device, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, device, return_numpy) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = _PROTOCOL, **configs) -> None:
    """Save a nested object (state dicts, tensors, Python values)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """Load what :func:`save` wrote: tensors come back as Paddle Tensors
    (Parameters as Parameters) on the current place (``set_device``), or
    as numpy arrays with ``return_numpy``."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    device = None if return_numpy else get_device().torch_device()
    return _unpack(obj, device, return_numpy)
