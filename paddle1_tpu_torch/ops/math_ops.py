"""Math, reduction, comparison and search ops (port of
``paddle1_tpu/ops/math_ops.py``).

Each op takes the reference's parameters in the reference's positions
and computes with torch functions, so autograd supplies the gradient the
JAX package gets from ``jax.vjp``. Inputs may be Paddle tensors (the
facade), plain torch tensors, or data that :func:`to_tensor` accepts
(placed on the current place); a Python scalar beside a tensor follows
the tensor's device. Outputs are Paddle tensors when an input is one.

Ops that run on the host in the JAX package (``unique``, ``bincount``,
``histogram``, ``masked_select``, ``nonzero``) run on the input's device
here. Integer results are int64 where the JAX package, without x64,
stores int32. Nothing here calls a tensor method whose Paddle meaning
differs from torch's: the ops call torch functions.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..amp import BLACK_LIST, WHITE_LIST, cast_point
from ..core import dtype as dtypes
from ..core.errors import InvalidArgumentError
from ..core.tensor import to_tensor, update_in_place

__all__: list = []   # filled at the bottom


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _operand(y, like: torch.Tensor) -> torch.Tensor:
    """``y`` as a tensor on ``like``'s device: a Python scalar becomes a
    0-d tensor (so torch's type promotion treats it as the JAX package's
    weakly typed scalar), other data goes through :func:`to_tensor`."""
    if isinstance(y, torch.Tensor):
        return y
    if isinstance(y, (bool, int, float, complex)):
        return torch.tensor(y, device=like.device)
    return to_tensor(y, place=like.device)


def _pair(x, y):
    if isinstance(y, torch.Tensor) and not isinstance(x, torch.Tensor):
        if isinstance(x, (bool, int, float, complex)):
            x = to_tensor(x, dtype=y.dtype, place=y.device)
        else:
            x = to_tensor(x, place=y.device)
    x = _t(x)
    return x, _operand(y, x)


def _named(opname, op):
    """``op`` under its Paddle name; an op that ``auto_cast``'s lists
    name casts there (``amp.cast_point``)."""
    op.__name__ = op.__qualname__ = opname
    return cast_point(opname)(op) if opname in WHITE_LIST | BLACK_LIST \
        else op


def _unary(opname, fn):
    def op(x, name=None):
        return fn(_t(x))
    return _named(opname, op)


def _binary(opname, fn):
    def op(x, y, name=None):
        return fn(*_pair(x, y))
    return _named(opname, op)


def _float(x: torch.Tensor) -> torch.Tensor:
    """``x`` as floating point (the default dtype for integers and bool),
    as jnp promotes integer inputs of transcendental ops."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(dtypes.get_default_dtype())


# -- elementwise binary -------------------------------------------------------
add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
pow = _binary("pow", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", lambda x, y: torch.atan2(_float(x), _float(y)))
hypot = _binary("hypot", lambda x, y: torch.hypot(_float(x), _float(y)))
copysign = _binary("copysign", torch.copysign)
nextafter = _binary("nextafter", torch.nextafter)
ldexp = _binary("ldexp", lambda x, y: x * torch.pow(2.0, y))
heaviside = _binary("heaviside", torch.heaviside)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
logaddexp = _binary("logaddexp", torch.logaddexp)
inner = _binary("inner", torch.inner)
outer = _binary("outer", lambda x, y: torch.outer(torch.reshape(x, (-1,)),
                                                  torch.reshape(y, (-1,))))
kron = _binary("kron", torch.kron)
cross = _binary("cross", lambda x, y: torch.linalg.cross(x, y, dim=-1))
dot = _binary("dot", lambda x, y: torch.sum(x * y, -1) if x.dim() > 1
              else torch.dot(x, y))
mv = _binary("mv", torch.matmul)

# -- elementwise unary --------------------------------------------------------
abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)      # half to even, as jnp.round
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", torch.frac)
sign = _unary("sign", torch.sign)
reciprocal = _unary("reciprocal", lambda x: torch.reciprocal(_float(x)))
erf = _unary("erf", lambda x: torch.erf(_float(x)))
erfinv = _unary("erfinv", lambda x: torch.erfinv(_float(x)))
sigmoid = _unary("sigmoid", lambda x: torch.sigmoid(_float(x)))
digamma = _unary("digamma", lambda x: torch.digamma(_float(x)))
lgamma = _unary("lgamma", lambda x: torch.lgamma(_float(x)))
i0 = _unary("i0", lambda x: torch.special.i0(_float(x)))
i1 = _unary("i1", lambda x: torch.special.i1(_float(x)))
angle = _unary("angle", torch.angle)
conj = _unary("conj", torch.conj_physical)
real = _unary("real", lambda x: torch.real(x) if x.is_complex() else x)
imag = _unary("imag", lambda x: torch.imag(x) if x.is_complex()
              else torch.zeros_like(x))
deg2rad = _unary("deg2rad", lambda x: torch.deg2rad(_float(x)))
rad2deg = _unary("rad2deg", lambda x: torch.rad2deg(_float(x)))
isfinite = _unary("isfinite", torch.isfinite)
isinf = _unary("isinf", torch.isinf)
isnan = _unary("isnan", torch.isnan)


def logit(x, eps=None, name=None):
    x = _t(x)
    if eps:
        x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def lerp(x, y, weight, name=None):
    x, y = _pair(x, y)
    return x + weight * (y - x)


def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, torch.Tensor) else min
    hi = max.item() if isinstance(max, torch.Tensor) else max
    x = _t(x)
    if lo is None and hi is None:
        return torch.clone(x)
    return torch.clamp(x, lo, hi)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = _t(x)
    if isinstance(scale, torch.Tensor):
        scale = scale.item()
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * _t(x))


def multiplex(inputs, index, name=None):
    xs = [_t(x) for x in inputs]
    stacked = torch.stack(xs, 0)
    idx = torch.reshape(_t(index).to(torch.int64),
                        (1, -1) + (1,) * (stacked.dim() - 2))
    idx = idx.expand((1,) + tuple(stacked.shape[1:]))
    return torch.gather(stacked, 0, idx)[0]


# -- matmul family ------------------------------------------------------------

@cast_point("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = _pair(x, y)
    if transpose_x and a.dim() >= 2:
        a = torch.swapaxes(a, -1, -2)
    if transpose_y and b.dim() >= 2:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


def mm(input, mat2, name=None):
    """Non-broadcasting matmul: batch dims must match exactly and inner
    dims must agree (the reference's shape assertion)."""
    a, b = _t(input), _t(mat2)
    if a.dim() < 1 or b.dim() < 1:
        raise InvalidArgumentError("mm: inputs must have ndim >= 1")
    ka = a.shape[-1]
    kb = b.shape[-2] if b.dim() >= 2 else b.shape[-1]
    if ka != kb or tuple(a.shape[:-2]) != tuple(b.shape[:-2]):
        raise InvalidArgumentError(
            f"mm does not broadcast: got shapes {list(a.shape)} x "
            f"{list(b.shape)}; use matmul for broadcasting semantics")
    return matmul(a, b)


@cast_point("bmm")
def bmm(x, y, name=None):
    return torch.matmul(*_pair(x, y))


def increment(x, value=1.0, name=None):
    """``x + value`` in ``x``'s dtype, written into ``x`` (Paddle's
    in-place contract, ``core.tensor.update_in_place``) when it is a
    tensor."""
    if not isinstance(x, torch.Tensor):
        return _t(x) + value
    v = torch.tensor(value, device=x.device).to(x.dtype)
    return update_in_place(x, torch.add, v, native=torch.Tensor.add_)


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def broadcast_shape(x_shape, y_shape):
    """Shape-only broadcast result."""
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def tanh_(x, name=None):
    """``tanh`` written into ``x`` (``core.tensor.update_in_place``)."""
    floating = x.is_floating_point() or x.is_complex()
    return update_in_place(x, torch.tanh,
                           native=torch.Tensor.tanh_ if floating else None)


@cast_point("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * _t(input) + alpha * torch.matmul(_t(x), _t(y))


@cast_point("einsum")
def einsum(equation, *operands):
    return torch.einsum(equation, *[_t(o) for o in operands])


def matmul_int8(x, y, name=None):
    """Integer product with int32 accumulation, contracting the last axis
    of ``x`` with the first of ``y`` (the reference's ``dot_general`` with
    ``preferred_element_type=int32``). On the CPU any integer dtype; on a
    card, torch's ``_int_mm`` rules, else ``InvalidArgumentError`` (never
    a silent cast to float): int8 inputs, ``y`` 2-D, ``x``'s rows (all
    axes but the last, flattened) more than 16, and the contracted and
    output widths multiples of 8."""
    a, b = _t(x), _t(y)
    if a.is_floating_point() or b.is_floating_point() or \
            a.is_complex() or b.is_complex():
        raise InvalidArgumentError(
            f"matmul_int8 takes integer inputs, got {a.dtype} x {b.dtype}")
    if a.shape[-1] != b.shape[0]:
        raise InvalidArgumentError(
            f"matmul_int8: x {list(a.shape)} and y {list(b.shape)} do not "
            "contract (x's last axis against y's first)")
    lead, rest = tuple(a.shape[:-1]), tuple(b.shape[1:])
    a2 = torch.reshape(a, (-1, a.shape[-1]))
    b2 = torch.reshape(b, (b.shape[0], -1))
    if a.device.type != "cuda":
        out = torch.matmul(a2.to(torch.int32), b2.to(torch.int32))
        return torch.reshape(out, lead + rest)
    m, k, n = a2.shape[0], a2.shape[1], b2.shape[1]
    if a.dtype != torch.int8 or b.dtype != torch.int8 or b.dim() != 2 or \
            m <= 16 or k % 8 or n % 8 or k == 0:
        raise InvalidArgumentError(
            "matmul_int8 on a card runs torch._int_mm, whose rules these "
            f"inputs break: x {list(a.shape)} {a.dtype}, y {list(b.shape)} "
            f"{b.dtype}; it needs int8 inputs, y 2-D, x's rows (all axes "
            "but the last) > 16, and the contracted and output widths "
            "multiples of 8")
    out = torch._int_mm(a2.contiguous(), b2.contiguous())
    return torch.reshape(out, lead + rest)


# -- reductions ---------------------------------------------------------------

def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        return tuple(int(a) for a in torch.reshape(axis, (-1,)).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x: torch.Tensor, axis):
    """Reduction axes as a tuple of non-negative ints (every axis for
    None)."""
    ax = _norm_axis(axis)
    if ax is None:
        return tuple(range(x.dim()))
    if isinstance(ax, int):
        ax = (ax,)
    nd = builtins.max(x.dim(), 1)
    return tuple(sorted({a % nd for a in ax}))


def _over(fn):
    """A reduction over a tuple of axes from a torch function that takes
    one ``dim`` at a time (innermost first)."""
    def red(x, dims, keepdim):
        if x.dim() == 0:
            return fn(x, 0, keepdim)
        for d in sorted(dims, reverse=True):
            x = fn(x, d, True)
        if not keepdim:
            x = torch.squeeze(x, dims) if dims else x
        return x
    return red


def _reduce(opname, fn, prep=None):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        x = _t(x)
        if prep is not None:
            x = prep(x)
        y = fn(x, _dims(x, axis), keepdim)
        if dtype is not None:
            y = y.to(dtypes.convert_dtype(dtype))
        return y
    return _named(opname, op)


def _bool(x):
    return x if x.dtype == torch.bool else x != 0


def _sum(x, dims, keepdim):
    """A sum in ``x``'s dtype (torch's sums integers in int64); bools
    count in int64."""
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    return torch.sum(x, dims, keepdim, dtype=x.dtype) if dims else \
        torch.clone(x)


sum = _reduce("sum", _sum)
mean = _reduce("mean", lambda x, d, k: torch.mean(x, d, k) if d
               else torch.clone(x), prep=_float)
prod = _reduce("prod", _over(torch.prod))
max = _reduce("max", lambda x, d, k: torch.amax(x, d, k))
min = _reduce("min", lambda x, d, k: torch.amin(x, d, k))
amax = _reduce("amax", lambda x, d, k: torch.amax(x, d, k))
amin = _reduce("amin", lambda x, d, k: torch.amin(x, d, k))
nansum = _reduce("nansum", lambda x, d, k: torch.nansum(x, d, k) if d
                 else torch.nan_to_num(x, nan=0.0))
nanmean = _reduce("nanmean", lambda x, d, k: torch.nanmean(x, d, k) if d
                  else torch.clone(x), prep=_float)
all = _reduce("all", lambda x, d, k: torch.all(x, d, k) if d else torch.clone(x),
              prep=_bool)
any = _reduce("any", lambda x, d, k: torch.any(x, d, k) if d else torch.clone(x),
              prep=_bool)
logsumexp = _reduce("logsumexp", lambda x, d, k: torch.logsumexp(x, d, k)
                    if d else torch.clone(x), prep=_float)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _float(_t(x))
    return torch.std(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _float(_t(x))
    return torch.var(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(x, q, axis, keepdim):
    """``jnp.quantile`` (linear interpolation) over ``axis`` (an int, a
    list, or None for all): the axes are moved last and flattened."""
    x = _float(_t(x))
    dims = _dims(x, axis)
    keep = [d for d in range(x.dim()) if d not in dims]
    moved = torch.permute(x, keep + list(dims)) if x.dim() else x
    flat = torch.reshape(moved, tuple(x.shape[d] for d in keep) + (-1,))
    qt = q if isinstance(q, torch.Tensor) else torch.tensor(
        q, dtype=x.dtype, device=x.device)
    out = torch.quantile(flat, qt.to(x.dtype), dim=-1)
    if keepdim:
        lead = tuple(out.shape[:out.dim() - len(keep)])
        full = [1 if d in dims else x.shape[d] for d in range(x.dim())]
        out = torch.reshape(out, lead + tuple(full))
    return out


def median(x, axis=None, keepdim=False, name=None):
    """The median over ``axis``, one tensor; for an even count the mean of
    the two middle values (``jnp.median``; torch's ``median`` takes the
    lower one and returns indices too)."""
    return _quantile(x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q, axis, keepdim)


def _cumulative(fn, x, axis, dtype):
    x = _t(x)
    if axis is None:
        x, axis = torch.reshape(x, (-1,)), 0
    y = fn(x, axis)
    return y.to(dtypes.convert_dtype(dtype)) if dtype else y


def cumsum(x, axis=None, dtype=None, name=None):
    """Cumulative sum along ``axis``; over the flattened input when
    ``axis`` is None."""
    return _cumulative(torch.cumsum, x, axis, dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    return _cumulative(torch.cumprod, x, dim, dtype)


def cummax(x, axis=None, dtype="int64", name=None):
    """The running maximum along ``axis`` (flattened for None): the
    values only, as the reference returns."""
    return _cumulative(lambda t, a: torch.cummax(t, a)[0], x, axis, None)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    xs = [_t(x) for x in inputs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.sum(torch.diagonal(_t(x), offset, axis1, axis2), -1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_t(x), offset, axis1, axis2)


# -- comparison / logical -----------------------------------------------------

equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
logical_not = _unary("logical_not", torch.logical_not)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
bitwise_not = _unary("bitwise_not", torch.bitwise_not)


def equal_all(x, y, name=None):
    """One bool (a 0-d tensor on the inputs' device): same shape and
    every element equal."""
    x, y = _pair(x, y)
    if tuple(x.shape) != tuple(y.shape):
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.all(torch.eq(x, y))


def _same(x, y):
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """One bool (a 0-d tensor on the inputs' device), not torch's Python
    bool."""
    return torch.all(isclose(x, y, rtol, atol, equal_nan))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _same(*_pair(x, y))
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds (any non-zero value), else ``y``;
    with neither given, the indices of the non-zero elements as a tuple
    (``nonzero(condition, as_tuple=True)``)."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    c = _bool(_t(condition))
    x = _operand(x, c)
    y = _operand(y, c)
    return torch.where(c, x, y)


def nonzero(x, as_tuple=False):
    """Indices of the non-zero elements, int64 (``[N, ndim]``, or a tuple
    of ``[N]`` with ``as_tuple``). The output's shape depends on the data,
    so it reads the count back to the host (a sync on a card)."""
    x = _t(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


# -- search / sort ------------------------------------------------------------

def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = _t(x)
    y = torch.argmax(torch.reshape(x, (-1,))) if axis is None else \
        torch.argmax(x, int(axis), keepdim)
    return y.to(dtypes.convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = _t(x)
    y = torch.argmin(torch.reshape(x, (-1,))) if axis is None else \
        torch.argmin(x, int(axis), keepdim)
    return y.to(dtypes.convert_dtype(dtype))


def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(_t(x), dim=axis, descending=descending,
                         stable=True)


def sort(x, axis=-1, descending=False, name=None):
    return torch.sort(_t(x), dim=axis, descending=descending,
                      stable=True)[0]


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    v, i = torch.topk(_t(x), k, dim=axis, largest=largest, sorted=sorted)
    return v, i


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq, v = _t(sorted_sequence), _t(values)
    if seq.dim() > 1 and v.dim() == seq.dim() and \
            not v.is_contiguous():
        v = v.contiguous()
    return torch.searchsorted(seq.contiguous(), v, out_int32=out_int32,
                              right=right)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique``'s outputs in its order: the sorted unique values,
    then (as asked) the index of each one's first occurrence, the inverse
    and the counts, in ``dtype``. The count of unique values depends on
    the data (a sync on a card)."""
    x = _t(x)
    flat = torch.reshape(x, (-1,)) if axis is None else x
    dim = 0 if axis is None else int(axis) % builtins.max(x.dim(), 1)
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    if not (return_index or return_inverse or return_counts):
        return vals
    it = dtypes.convert_dtype(dtype)
    outs = [vals]
    if return_index:
        n = flat.shape[dim]
        first = torch.full((vals.shape[dim],), n, dtype=torch.int64,
                           device=x.device)
        first = first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin")
        outs.append(first.to(it))
    if return_inverse:     # np.unique's: the input's shape for axis None
        outs.append(torch.reshape(inv, tuple(x.shape)).to(it)
                    if axis is None else inv.to(it))
    if return_counts:
        outs.append(counts.to(it))
    return tuple(outs)


def bincount(x, weights=None, minlength=0, name=None):
    w = None if weights is None else _t(weights)
    out = torch.bincount(_t(x), w, minlength)
    return out.to(dtypes.get_default_dtype()) if out.is_floating_point() \
        else out


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts (int64) of ``bins`` equal bins over ``[min, max]`` (the
    data's range when both are 0); values outside are left out."""
    x = _float(_t(input))
    if min == 0 and max == 0:
        lo, hi = torch.aminmax(x)
        lo, hi = float(lo), float(hi)
    else:
        lo, hi = float(min), float(max)
    return torch.histc(x, bins, lo, hi).to(torch.int64)


def masked_select(x, mask, name=None):
    x = _t(x)
    return torch.masked_select(x, _bool(_operand(mask, x)))


def index_sample(x, index):
    return torch.gather(_t(x), 1, _t(index).to(torch.int64))


def index_select(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at ``index``; an index of any shape
    takes that shape's place (``jnp.take``)."""
    x, i = _t(x), _t(index).to(torch.int64)
    axis = int(axis) % builtins.max(x.dim(), 1)
    out = torch.index_select(x, axis, torch.reshape(i, (-1,)))
    if i.dim() == 1:
        return out
    return torch.reshape(out, tuple(x.shape[:axis]) + tuple(i.shape) +
                         tuple(x.shape[axis + 1:]))


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among ties)
    and the index of its first occurrence, as the reference computes
    them."""
    x = _t(x)
    moved = torch.movedim(x, axis, -1)
    xs = torch.sort(moved, dim=-1)[0]
    eq = torch.sum((torch.unsqueeze(xs, -2) == torch.unsqueeze(xs, -1)).to(
        torch.int64), -1)
    best = torch.argmax(eq, -1, keepdim=True)
    vals = torch.gather(xs, -1, best)[..., 0]
    idx = torch.argmax((moved == torch.unsqueeze(vals, -1)).to(torch.int8),
                       -1)
    if keepdim:
        return (torch.movedim(torch.unsqueeze(vals, -1), -1, axis),
                torch.movedim(torch.unsqueeze(idx, -1), -1, axis))
    return vals, idx


__all__ = sorted(
    k for k, v in list(globals().items())
    if callable(v) and not k.startswith("_") and
    getattr(v, "__module__", "") == __name__)
