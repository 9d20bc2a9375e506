"""Dtype names (port of ``paddle1_tpu/core/dtype.py``).

Paddle's dtype names are the torch dtypes themselves
(``paddle1_tpu_torch.float32 is torch.float32``); :func:`convert_dtype`
normalizes a name, a numpy dtype, a torch dtype or a Python type. The
default floating dtype (f32) is this package's own: it decides what
Python floats and float64 numpy data become in ``to_tensor``, and leaves
torch's global default untouched.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import InvalidArgumentError

__all__ = [
    "convert_dtype", "float32", "float64", "float16", "bfloat16", "int8",
    "int16", "int32", "int64", "uint8", "bool_", "complex64", "complex128",
    "set_default_dtype", "get_default_dtype",
]

float32 = torch.float32
float64 = torch.float64
float16 = torch.float16
bfloat16 = torch.bfloat16
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "float": float32, "double": float64, "half": float16, "bf16": bfloat16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "float16": float16, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8, "bool": bool_, "complex64": complex64,
    "complex128": complex128,
}
_NUMPY = {np.dtype(k): v for k, v in _ALIASES.items()
          if k not in ("bf16", "bfloat16")}

_default_dtype = float32


def set_default_dtype(d) -> None:
    global _default_dtype
    d = convert_dtype(d)
    if not d.is_floating_point:
        raise InvalidArgumentError(
            f"default dtype must be floating point, got {d}")
    _default_dtype = d


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def convert_dtype(d) -> torch.dtype:
    """A dtype name, numpy dtype, torch dtype or Python type → the torch
    dtype; ``None`` and ``float`` → the default dtype."""
    if d is None or d is float:
        return _default_dtype
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        if d in _ALIASES:
            return _ALIASES[d]
        raise InvalidArgumentError(f"Unknown dtype: {d!r}")
    if d is int:
        return int64
    if d is bool:
        return bool_
    try:
        return _NUMPY[np.dtype(d)]
    except (TypeError, KeyError):
        raise InvalidArgumentError(f"Unknown dtype: {d!r}") from None

