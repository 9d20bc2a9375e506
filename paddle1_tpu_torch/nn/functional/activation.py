"""Activation functionals (port of the subset of
``paddle1_tpu/nn/functional/activation.py`` the serving, BERT, eager
LeNet and YOLOv3 slices run)."""

from __future__ import annotations

import torch

from ...amp import cast_point
from ...core import dtype as dtypes
from ...core.flags import flag_active
from ...core.tensor import Tensor
from ...ops import softmax as psm

__all__ = ["relu", "leaky_relu", "gelu", "tanh", "softmax", "softmax_",
           "log_softmax"]


def relu(x: torch.Tensor, name=None) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01,
               name=None) -> torch.Tensor:
    """``x`` where ``x >= 0``, ``negative_slope * x`` elsewhere (the
    reference's ``jax.nn.leaky_relu``). An elementwise op: it keeps x's
    memory format, channels-last included."""
    return torch.nn.functional.leaky_relu(x, negative_slope)


def gelu(x: torch.Tensor, approximate: bool = False,
         name=None) -> torch.Tensor:
    """GELU: exact (erf), as BERT's ``hidden_act="gelu"`` runs it, or
    with ``approximate`` the tanh form (``jax.nn.gelu(approximate=...)``
    in the JAX package, ``activation.py:88``)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x: torch.Tensor, name=None) -> torch.Tensor:
    return torch.tanh(x)


def _float_input(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` when it is given; else an integer ``x``
    promoted to float32, as ``jax.nn.softmax`` and ``jax.nn.log_softmax``
    promote it in the JAX package (bool is refused there, and here)."""
    if dtype is not None:
        return x.to(dtypes.convert_dtype(dtype))
    if not (x.dtype.is_floating_point or x.dtype.is_complex or
            x.dtype == torch.bool):
        return x.to(torch.float32)
    return x


@cast_point("softmax")
def softmax(x: torch.Tensor, axis: int = -1, dtype=None,
            name=None) -> torch.Tensor:
    """Softmax along ``axis``, routed as in the JAX package: cast to
    ``dtype`` first (an integer ``x`` without ``dtype`` to float32, as
    ``jax.nn.softmax`` promotes it); then the hand-written kernel
    (``ops/softmax.py``) when the ``fused_softmax`` flag is active for the
    tensor's device and ``supported(shape, axis)`` holds (the last axis);
    otherwise ``torch.softmax``, the counterpart of the reference's
    ``jax.nn.softmax``. The choice is made before any launch, on shape
    and axis alone as in the reference: a CUDA tensor of a dtype the
    kernel lacks (f32, bf16 and f16 are in) raises InvalidArgumentError
    instead of leaving the kernel."""
    x = _float_input(x, dtype)
    if flag_active("fused_softmax", x.device) and \
            psm.supported(x.shape, axis):
        return psm.fused_softmax(x)
    return torch.softmax(x, dim=axis)


def softmax_(x: torch.Tensor, axis: int = -1, dtype=None,
             name=None) -> torch.Tensor:
    """:func:`softmax` in place, as the JAX package's ``_inplace``: a
    Paddle tensor is replaced by the result (its value, its dtype when
    ``dtype`` is given or ``x`` is an integer, and its gradient path:
    ``Tensor._replace_impl``) and returned; a plain torch tensor gets the
    result out of place, as the reference's raw arrays do."""
    y = softmax(x, axis, dtype)
    if isinstance(x, Tensor):
        x._replace_impl(y)
        return x
    return y


@cast_point("log_softmax")
def log_softmax(x: torch.Tensor, axis: int = -1, dtype=None,
                name=None) -> torch.Tensor:
    """Log-softmax along ``axis`` after :func:`softmax`'s cast (an integer
    ``x`` becomes float32)."""
    return torch.log_softmax(_float_input(x, dtype), dim=axis)
