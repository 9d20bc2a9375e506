"""Activation functionals (port of ``paddle1_tpu/nn/functional/activation.py``,
its whole ``__all__``).

Each op is a :func:`amp.cast_point` under the name the JAX package passes
to ``autograd.engine.apply`` for it (``relu6``, ``gelu``, ``prelu``, ...),
so ``auto_cast``'s ``custom_white_list`` / ``custom_black_list`` can name
it. Formulas are the JAX package's, not torch's same-named functions where
the two differ: ``hardsigmoid``'s slope 0.1666667 and offset 0.5,
``softplus(beta, threshold)``, ``thresholded_relu(threshold, value)``,
``maxout(groups, axis)`` (the channel axis split as ``[C / groups,
groups]``, the max over the second), ``prelu(weight, data_format)``.

Gradients at the kinks are the JAX package's too. ``jnp.clip`` is
``minimum(maximum(x, lo), hi)``, whose gradient at a bound is one half
(jax's max/min split a tie evenly, as ``torch.maximum``/``torch.minimum``
do), so ``hardtanh``, ``hardsigmoid`` and ``hardswish`` clip through
:func:`_clip` here, not ``torch.clamp`` (whose gradient at a bound is 1);
``relu6`` is ``jax.nn.relu6``, whose gradient at 0 and 6 is 0, as
``torch.nn.functional.relu6``'s is; ``leaky_relu``'s and ``prelu``'s
gradient at 0 is 1, as ``where(x >= 0, ...)``'s (torch's leaky ReLU
gives the slope there).

``rrelu`` in training and ``gumbel_softmax`` draw from ``generator`` (the
default generator of x's device when None): torch's streams are not the
JAX package's keys, so they agree with it in distribution only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tF

from ...amp import cast_point
from ...core import dtype as dtypes
from ...core.errors import InvalidArgumentError
from ...core.flags import flag_active
from ...core.tensor import Tensor
from ...ops import softmax as psm

__all__ = [
    "relu", "relu6", "relu_", "elu", "elu_", "selu", "celu", "gelu",
    "sigmoid",
    "hardsigmoid", "hardswish", "hardtanh", "hardshrink", "softshrink",
    "tanhshrink", "leaky_relu", "prelu", "rrelu", "log_sigmoid", "maxout",
    "silu", "swish", "mish", "softplus", "softsign", "tanh", "tanh_",
    "thresholded_relu", "log_softmax", "softmax", "softmax_", "glu",
    "gumbel_softmax",
]


def _inplace(x, out):
    """The in-place contract of the ``*_`` variants (the JAX package's
    ``_inplace``): a Paddle tensor is replaced by the result (its value,
    its dtype and its gradient path: ``Tensor._replace_impl``) and
    returned; a plain torch tensor gets the result out of place, as the
    reference's raw arrays do."""
    if isinstance(x, Tensor):
        x._replace_impl(out)
        return x
    return out


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: 1 inside, 1/2 at a bound,
    0 outside."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


@cast_point("relu")
def relu(x: torch.Tensor, name=None) -> torch.Tensor:
    return torch.relu(x)


@cast_point("relu6")
def relu6(x: torch.Tensor, name=None) -> torch.Tensor:
    """``min(max(x, 0), 6)`` (``jax.nn.relu6``: gradient 0 at 0 and 6). An
    elementwise op: it keeps x's memory format, channels-last included."""
    return tF.relu6(x)


def relu_(x: torch.Tensor, name=None) -> torch.Tensor:
    return _inplace(x, relu(x))


@cast_point("elu")
def elu(x: torch.Tensor, alpha: float = 1.0, name=None) -> torch.Tensor:
    return tF.elu(x, alpha)


def elu_(x: torch.Tensor, alpha: float = 1.0, name=None) -> torch.Tensor:
    return _inplace(x, elu(x, alpha=alpha))


@cast_point("selu")
def selu(x: torch.Tensor, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772, name=None) -> torch.Tensor:
    """``scale * where(x > 0, x, alpha * expm1(x))`` with the given
    ``scale`` and ``alpha`` (the expm1 taken of ``min(x, 0)``, which the
    ``where`` leaves unchanged, so a large x cannot send inf into the
    backward)."""
    neg = alpha * torch.expm1(torch.clamp(x, max=0.0))
    return scale * torch.where(x > 0, x, neg)


@cast_point("celu")
def celu(x: torch.Tensor, alpha: float = 1.0, name=None) -> torch.Tensor:
    return tF.celu(x, alpha)


@cast_point("gelu")
def gelu(x: torch.Tensor, approximate: bool = False,
         name=None) -> torch.Tensor:
    """GELU: exact (erf), as BERT's ``hidden_act="gelu"`` runs it, or
    with ``approximate`` the tanh form (``jax.nn.gelu(approximate=...)``
    in the JAX package)."""
    return tF.gelu(x, approximate="tanh" if approximate else "none")


@cast_point("sigmoid")
def sigmoid(x: torch.Tensor, name=None) -> torch.Tensor:
    return torch.sigmoid(x)


@cast_point("hardsigmoid")
def hardsigmoid(x: torch.Tensor, slope: float = 0.1666667,
                offset: float = 0.5, name=None) -> torch.Tensor:
    """``clip(slope * x + offset, 0, 1)``; Paddle's slope 0.1666667, not
    torch's 1/6."""
    return _clip(slope * x + offset, 0.0, 1.0)


@cast_point("hardswish")
def hardswish(x: torch.Tensor, name=None) -> torch.Tensor:
    """``x * clip(x + 3, 0, 6) / 6``."""
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


@cast_point("hardtanh")
def hardtanh(x: torch.Tensor, min: float = -1.0, max: float = 1.0,
             name=None) -> torch.Tensor:
    return _clip(x, min, max)


@cast_point("hardshrink")
def hardshrink(x: torch.Tensor, threshold: float = 0.5,
               name=None) -> torch.Tensor:
    """``x`` where ``|x| > threshold``, else 0."""
    return tF.hardshrink(x, threshold)


@cast_point("softshrink")
def softshrink(x: torch.Tensor, threshold: float = 0.5,
               name=None) -> torch.Tensor:
    """``x -+ threshold`` beyond ``+-threshold``, else 0."""
    return tF.softshrink(x, threshold)


@cast_point("tanhshrink")
def tanhshrink(x: torch.Tensor, name=None) -> torch.Tensor:
    return x - torch.tanh(x)


class _LeakyReLU(torch.autograd.Function):
    """``torch.nn.functional.leaky_relu`` forward (one kernel), with
    ``jax.nn.leaky_relu``'s gradient: 1 at ``x == 0``, where torch's is
    the slope."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return tF.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


@cast_point("leaky_relu")
def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01,
               name=None) -> torch.Tensor:
    """``x`` where ``x >= 0``, ``negative_slope * x`` elsewhere (the
    reference's ``jax.nn.leaky_relu``, its gradient at 0 included). An
    elementwise op: it keeps x's memory format, channels-last included."""
    return _LeakyReLU.apply(x, float(negative_slope))


@cast_point("prelu")
def prelu(x: torch.Tensor, weight: torch.Tensor, data_format: str = "NCHW",
          name=None) -> torch.Tensor:
    """``where(x >= 0, x, w * x)``: one slope for all (``weight`` of one
    element) or one per channel, on axis 1 (``NC...``) or the last axis."""
    if weight.numel() == 1:
        w = torch.reshape(weight, ())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format == "NCHW" else x.dim() - 1] = weight.numel()
        w = torch.reshape(weight, shape)
    return torch.where(x >= 0, x, w * x)


@cast_point("rrelu")
def rrelu(x: torch.Tensor, lower: float = 1.0 / 8.0,
          upper: float = 1.0 / 3.0, training: bool = True, name=None, *,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Randomized leaky ReLU: in training each negative element is scaled
    by its own slope drawn from ``U(lower, upper)`` (from ``generator``);
    out of training by ``(lower + upper) / 2``."""
    if training:
        slope = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        slope.uniform_(lower, upper, generator=generator)
        return torch.where(x >= 0, x, slope * x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


@cast_point("log_sigmoid")
def log_sigmoid(x: torch.Tensor, name=None) -> torch.Tensor:
    return tF.logsigmoid(x)


@cast_point("maxout")
def maxout(x: torch.Tensor, groups: int, axis: int = 1,
           name=None) -> torch.Tensor:
    """The max over ``groups`` consecutive channels: axis ``axis`` of C is
    split as ``[C / groups, groups]``, the max taken over the second (a
    tie's gradient split evenly, as ``jnp.max``'s)."""
    ax = axis % x.dim()
    c = int(x.shape[ax])
    if c % groups:
        raise InvalidArgumentError(
            f"maxout: {c} channels on axis {axis} are not a multiple of "
            f"groups={groups}")
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + \
        tuple(x.shape[ax + 1:])
    return torch.amax(torch.reshape(x, shape), dim=ax + 1)


@cast_point("silu")
def silu(x: torch.Tensor, name=None) -> torch.Tensor:
    return tF.silu(x)


def swish(x: torch.Tensor, name=None) -> torch.Tensor:
    return silu(x)


@cast_point("mish")
def mish(x: torch.Tensor, name=None) -> torch.Tensor:
    """``x * tanh(softplus(x))``."""
    return tF.mish(x)


@cast_point("softplus")
def softplus(x: torch.Tensor, beta: float = 1.0, threshold: float = 20.0,
             name=None) -> torch.Tensor:
    """``x`` where ``beta * x > threshold``, else ``log(1 + exp(beta * x))
    / beta``."""
    return tF.softplus(x, beta, threshold)


@cast_point("softsign")
def softsign(x: torch.Tensor, name=None) -> torch.Tensor:
    return tF.softsign(x)


@cast_point("tanh")
def tanh(x: torch.Tensor, name=None) -> torch.Tensor:
    return torch.tanh(x)


def tanh_(x: torch.Tensor, name=None) -> torch.Tensor:
    return _inplace(x, tanh(x))


@cast_point("thresholded_relu")
def thresholded_relu(x: torch.Tensor, threshold: float = 1.0,
                     value: float = 0.0, name=None) -> torch.Tensor:
    """``x`` where ``x > threshold``, else ``value``."""
    return tF.threshold(x, threshold, value)


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
    """:func:`softmax` in place (:func:`_inplace`): a Paddle tensor takes
    the result's value, its dtype when ``dtype`` is given or ``x`` is an
    integer, and its gradient path."""
    return _inplace(x, softmax(x, axis, dtype))


@cast_point("log_softmax")
def log_softmax(x: torch.Tensor, axis: int = -1, dtype=None,
                name=None) -> torch.Tensor:
    """Log-softmax along ``axis`` after :func:`softmax`'s cast (an integer
    ``x`` becomes float32)."""
    return torch.log_softmax(_float_input(x, dtype), dim=axis)


@cast_point("glu")
def glu(x: torch.Tensor, axis: int = -1, name=None) -> torch.Tensor:
    """``a * sigmoid(b)`` of the two halves of ``axis``."""
    return tF.glu(x, axis)


@cast_point("gumbel_softmax")
def gumbel_softmax(x: torch.Tensor, temperature: float = 1.0,
                   hard: bool = False, axis: int = -1, name=None, *,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """``softmax((x + g) / temperature)`` with standard Gumbel noise ``g``
    (``-log(-log(u))``, u from ``generator``); ``hard``: the one-hot of the
    argmax in the forward, the soft sample's gradient (straight-through)."""
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    u.uniform_(generator=generator)
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y
