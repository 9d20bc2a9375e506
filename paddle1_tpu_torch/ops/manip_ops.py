"""Creation, random, manipulation and casting ops (port of
``paddle1_tpu/ops/manip_ops.py``).

Creation ops place their output on the current place
(``core.place.get_device()``: the card unless the caller asks for the
CPU); ``*_like`` ops on their input's device. Random ops draw from the
device's generator, which ``paddle.seed`` seeds (``core/generator.py``),
or from the ``generator`` given keyword-only after the reference's
parameters; torch's Philox gives other numbers than the JAX package's
threefry for the same seed. In-place ops (``reshape_``, ``flatten_``,
``scatter_``, ``assign(x, output)``) follow Paddle's in-place contract
(``core.tensor.update_in_place``). The ops call torch functions, never a
tensor method whose Paddle meaning differs from torch's.
"""

from __future__ import annotations

import builtins
from typing import List

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.errors import InvalidArgumentError
from ..core.place import get_device
from ..core.tensor import Tensor, to_tensor, update_in_place

__all__: list = []   # filled at the bottom


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _axis(axis) -> int:
    return int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)


def _shape_list(shape) -> List[int]:
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in torch.reshape(shape, (-1,)).tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in shape]


def _dev() -> torch.device:
    return get_device().torch_device()


def _new(t: torch.Tensor) -> Tensor:
    """A new tensor as a Paddle tensor (a leaf, stop_gradient True)."""
    return t.as_subclass(Tensor)


def _dt(dtype):
    return None if dtype is None else dtypes.convert_dtype(dtype)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


# -- creation -----------------------------------------------------------------

def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape_list(shape),
                            dtype=dtypes.convert_dtype(dtype), device=_dev()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape_list(shape),
                           dtype=dtypes.convert_dtype(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, bool):
        dtype = "bool"
    elif dtype is None and isinstance(fill_value, int):
        dtype = "int64"
    return _new(torch.full(_shape_list(shape), fill_value,
                           dtype=dtypes.convert_dtype(dtype), device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return _new(torch.zeros_like(_t(x), dtype=_dt(dtype)))


def ones_like(x, dtype=None, name=None):
    return _new(torch.ones_like(_t(x), dtype=_dt(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return _new(torch.full_like(_t(x), _scalar(fill_value), dtype=_dt(dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def builtins_all_int(*vals):
    return builtins.all(isinstance(v, (int, np.integer)) for v in vals)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if builtins_all_int(start, end, step)
                 else dtypes.get_default_dtype())
    return _new(torch.arange(start, end, step,
                             dtype=dtypes.convert_dtype(dtype),
                             device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)),
                               dtype=dtypes.convert_dtype(dtype),
                               device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace(_scalar(start), _scalar(stop), int(num),
                               base=base, dtype=dtypes.convert_dtype(dtype),
                               device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _new(torch.eye(num_rows, num_rows if num_columns is None
                          else num_columns,
                          dtype=dtypes.convert_dtype(dtype), device=_dev()))


def diag(x, offset=0, padding_value=0, name=None):
    x = _t(x)
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            r = torch.arange(out.shape[0], device=x.device)
            c = torch.arange(out.shape[1], device=x.device)
            mask = torch.unsqueeze(c, 0) - torch.unsqueeze(r, 1) == offset
            out = torch.where(mask, out, torch.tensor(
                padding_value, dtype=out.dtype, device=x.device))
        return out
    return torch.diagonal(x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(_t(x), offset)


def meshgrid(*args, **kwargs):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*[_t(x) for x in ts], indexing="ij"))


def tril(x, diagonal=0, name=None):
    return torch.tril(_t(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(_t(x), diagonal)


def clone(x, name=None):
    return torch.clone(_t(x))


def assign(x, output=None):
    """A copy of ``x`` (data or a tensor; the gradient flows through it),
    or, with ``output``, ``x`` written into ``output``."""
    out = torch.clone(_t(x)) if isinstance(x, torch.Tensor) else to_tensor(x)
    if output is not None:
        same = out.shape == output.shape and out.dtype == output.dtype \
            and out.device == output.device
        return update_in_place(output, _value, out,
                               native=torch.Tensor.copy_ if same else None)
    return out


def _value(_, value):
    return value


# -- random creation ----------------------------------------------------------

def rand(shape, dtype=None, name=None, *, generator=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0, generator=generator)


def randn(shape, dtype=None, name=None, *, generator=None):
    return _new(torch.randn(_shape_list(shape),
                            dtype=dtypes.convert_dtype(dtype), device=_dev(),
                            generator=generator))


def standard_normal(shape, dtype=None, name=None, *, generator=None):
    return randn(shape, dtype, generator=generator)


def gaussian(shape, mean=0.0, std=1.0, dtype=None, name=None, *,
             generator=None):
    return _new(mean + std * torch.randn(
        _shape_list(shape), dtype=dtypes.convert_dtype(dtype),
        device=_dev(), generator=generator))


def normal(mean=0.0, std=1.0, shape=None, name=None, *, generator=None):
    """Normal samples: of ``mean``'s (or ``std``'s) shape when either is a
    tensor, else of ``shape`` ([1] when None)."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        base = mean if isinstance(mean, torch.Tensor) else std
        noise = torch.randn(tuple(base.shape),
                            dtype=dtypes.get_default_dtype(),
                            device=base.device, generator=generator)
        return _new((mean + std * noise).detach())
    return _new(mean + std * torch.randn(
        _shape_list(shape if shape is not None else [1]),
        dtype=dtypes.get_default_dtype(), device=_dev(),
        generator=generator))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *,
            generator=None):
    """Uniform samples in ``[min, max)``. A non-zero ``seed`` draws from a
    generator of its own seeded with it (the same numbers on every call,
    whatever the global state), as in the reference."""
    dev = _dev()
    if seed:
        generator = torch.Generator(dev).manual_seed(int(seed))
    out = torch.empty(_shape_list(shape), dtype=dtypes.convert_dtype(dtype),
                      device=dev)
    return _new(out.uniform_(min, max, generator=generator))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None, *,
            generator=None):
    if high is None:
        low, high = 0, low
    return _new(torch.randint(low, high, _shape_list(shape),
                              dtype=dtypes.convert_dtype(dtype),
                              device=_dev(), generator=generator))


def randint_like(x, low=0, high=None, dtype=None, name=None, *,
                 generator=None):
    x = _t(x)
    if high is None:
        low, high = 0, low
    return _new(torch.randint(low, high, tuple(x.shape),
                              dtype=_dt(dtype) or x.dtype, device=x.device,
                              generator=generator))


def randperm(n, dtype="int64", name=None, *, generator=None):
    return _new(torch.randperm(n, dtype=dtypes.convert_dtype(dtype),
                               device=_dev(), generator=generator))


def bernoulli(x, name=None, *, generator=None):
    return _new(torch.bernoulli(_t(x).detach(), generator=generator))


def multinomial(x, num_samples=1, replacement=False, name=None, *,
                generator=None):
    return _new(torch.multinomial(_t(x).detach(), num_samples, replacement,
                                  generator=generator))


# -- manipulation -------------------------------------------------------------

def cast(x, dtype):
    return _t(x).to(dtypes.convert_dtype(dtype))


def reshape(x, shape, name=None):
    return torch.reshape(_t(x), _shape_list(shape))


def reshape_(x, shape, name=None):
    return update_in_place(x, reshape, shape)


def transpose(x, perm, name=None):
    """Permute the axes of ``x`` to ``perm`` (a view)."""
    return torch.permute(_t(x), [int(p) for p in perm])


def t(x, name=None):
    x = _t(x)
    if x.dim() < 2:
        return x
    return torch.swapaxes(x, -1, -2)


def moveaxis(x, source, destination, name=None):
    return torch.movedim(_t(x), source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(_t(x), axis0, axis1)


transpose_ = transpose


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Merge axes ``start_axis..stop_axis`` (inclusive, negative from the
    end) into one, in row-major order whatever ``x``'s memory format."""
    x = _t(x)
    if x.dim() == 0:
        return torch.reshape(x, (1,))
    return torch.flatten(x, start_axis, stop_axis)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return update_in_place(x, flatten, start_axis, stop_axis)


def squeeze(x, axis=None, name=None):
    """Drop the size-1 axes among ``axis`` (an int or a list; every one
    for None); listed axes of another size stay."""
    x = _t(x)
    if axis is None:
        return torch.squeeze(x)
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    nd = builtins.max(x.dim(), 1)
    dims = tuple(a % nd for a in (_axis(a) for a in ax)
                 if x.dim() and x.shape[a % nd] == 1)
    return torch.squeeze(x, dims) if dims else x


def unsqueeze(x, axis, name=None):
    """Insert size-1 axes at ``axis`` (an int or a list, positions in the
    output)."""
    x = _t(x)
    ax = _shape_list(axis) if isinstance(axis, torch.Tensor) else \
        (list(axis) if isinstance(axis, (list, tuple)) else [axis])
    out_nd = x.dim() + len(ax)
    for a in sorted(int(a) % out_nd for a in ax):
        x = torch.unsqueeze(x, a)
    return x


squeeze_ = squeeze
unsqueeze_ = unsqueeze


def concat(x, axis=0, name=None):
    """Join the tensors of ``x`` along ``axis`` (an int or a one-element
    tensor). Inputs that share a memory format give an output in it
    (``torch.cat``): channels-last activations stay channels-last."""
    return torch.cat([_t(e) for e in x], dim=_axis(axis))


def stack(x, axis=0, name=None):
    return torch.stack([_t(e) for e in x], dim=int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """Cut ``x`` along ``axis`` into ``num_or_sections`` equal parts (an
    int that divides the axis) or into parts of the listed sizes, one of
    which may be -1 (the rest). Returns a list of views."""
    x = _t(x)
    axis = _axis(axis)
    dim = int(x.shape[axis])
    if isinstance(num_or_sections, (int, np.integer)):
        num_or_sections = int(num_or_sections)
        if dim % num_or_sections:
            raise InvalidArgumentError(
                f"split: axis {axis} of size {dim} is not divisible into "
                f"{num_or_sections} parts")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_axis(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sizes) if s < 0]
        if neg:
            sizes[neg[0]] = dim - builtins.sum(s for s in sizes if s >= 0)
    if builtins.sum(sizes) != dim:
        raise InvalidArgumentError(
            f"split: sections {sizes} do not add up to axis {axis}'s size "
            f"{dim}")
    return list(torch.split_with_sizes(x, sizes, dim=axis))


def unbind(input, axis=0):
    return list(torch.unbind(_t(input), dim=axis))


unstack = unbind


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tile(x, repeat_times, name=None):
    return torch.tile(_t(x), _shape_list(repeat_times))


def expand(x, shape, name=None):
    """Broadcast ``x`` to ``shape``; -1 keeps the input's size."""
    return torch.Tensor.expand(_t(x), _shape_list(shape))


def expand_as(x, y, name=None):
    return expand(x, list(_t(y).shape))


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(_t(x), _shape_list(shape))


def broadcast_tensors(inputs, name=None):
    shapes = [tuple(_t(i).shape) for i in inputs]
    out_shape = np.broadcast_shapes(*shapes)
    return [broadcast_to(i, list(out_shape)) for i in inputs]


def flip(x, axis, name=None):
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(_t(x), [int(a) for a in ax])


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(_t(x), k, [int(a) for a in axes])


def roll(x, shifts, axis=None, name=None):
    if axis is None:
        return torch.roll(_t(x), shifts)
    return torch.roll(_t(x), shifts, axis)


def _index(i) -> torch.Tensor:
    return _t(i).to(torch.int64)


def gather(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at ``index`` (flattened when it has
    more than one axis; a 0-d index drops the axis)."""
    x, i = _t(x), _index(index)
    axis = _axis(axis) % builtins.max(x.dim(), 1)
    out = torch.index_select(x, axis, torch.reshape(i, (-1,)))
    return torch.squeeze(out, axis) if i.dim() == 0 else out


def gather_nd(x, index, name=None):
    x, i = _t(x), _index(index)
    return x[tuple(torch.unbind(i, -1))]


def take_along_axis(arr, indices, axis, broadcast=True):
    return torch.take_along_dim(_t(arr), _index(indices), dim=axis)


def put_along_axis(arr, indices, values, axis, reduce="assign"):
    x, i = _t(arr), _index(indices)
    v = values if isinstance(values, torch.Tensor) else \
        torch.tensor(values, device=x.device)
    v = torch.broadcast_to(v.to(x.dtype), tuple(i.shape))
    if reduce == "assign":
        return torch.scatter(x, axis, i, v)
    if reduce == "add":
        return torch.scatter_add(x, axis, i, v)
    if reduce in ("multiply", "mul"):
        return torch.scatter_reduce(x, axis, i, v, "prod")
    raise InvalidArgumentError(
        f"put_along_axis: reduce must be assign, add or multiply, got "
        f"{reduce!r}")


def scatter(x, index, updates, overwrite=True, name=None):
    """``x`` with the rows at ``index`` (along axis 0) set to ``updates``;
    with ``overwrite=False`` those rows are zeroed and every update is
    added (duplicates accumulate)."""
    x, i, u = _t(x), _index(index), _t(updates)
    i = torch.reshape(i, (-1,))
    u = u.to(x.dtype)
    if overwrite:
        return torch.index_copy(x, 0, i, u)
    return torch.index_add(torch.index_copy(x, 0, i, torch.zeros_like(u)),
                           0, i, u)


def _scatter_native(x, index, updates, overwrite):
    """:func:`scatter`'s result written into ``x`` by torch's in-place
    ops."""
    i = torch.reshape(_index(index), (-1,))
    u = _t(updates).to(x.dtype)
    torch.Tensor.index_copy_(x, 0, i, u if overwrite else torch.zeros_like(u))
    if not overwrite:
        torch.Tensor.index_add_(x, 0, i, u)


def scatter_(x, index, updates, overwrite=True, name=None):
    return update_in_place(x, scatter, index, updates, overwrite,
                           native=_scatter_native)


def scatter_nd_add(x, index, updates, name=None):
    x, i = _t(x), _index(index)
    return torch.index_put(x, tuple(torch.unbind(i, -1)),
                           _t(updates).to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    u = _t(updates)
    base = torch.zeros(_shape_list(shape), dtype=u.dtype, device=u.device)
    return scatter_nd_add(base, index, u)


def index_add(x, index, axis, value, name=None):
    x = _t(x)
    return torch.index_add(x, _axis(axis), _index(index),
                           _t(value).to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x = _t(x)
    v = value if isinstance(value, torch.Tensor) else \
        torch.tensor(value, device=x.device)
    return torch.index_put(x, tuple(_index(i) for i in indices),
                           v.to(x.dtype), accumulate=accumulate)


def masked_fill(x, mask, value, name=None):
    x = _t(x)
    m = _t(mask)
    m = m if m.dtype == torch.bool else m != 0
    if isinstance(value, torch.Tensor):
        return torch.where(m, value.to(x.dtype), x)
    return torch.masked_fill(x, m, value)


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """``x`` with ``value`` on the main diagonal of its last two axes (the
    reference ignores ``offset`` and ``wrap``)."""
    x = _t(x)
    mask = torch.eye(x.shape[-2], x.shape[-1], dtype=torch.bool,
                     device=x.device)
    return torch.where(mask, torch.tensor(value, dtype=x.dtype,
                                          device=x.device), x)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = _t(x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(device=x.device, dtype=torch.int64)
    return torch.repeat_interleave(x, repeats, dim=axis)


builtins_slice = builtins.slice


def slice(input, axes, starts, ends):
    def _v(vs):
        return [int(v.item()) if isinstance(v, torch.Tensor) else int(v)
                for v in vs]
    axes, starts, ends = list(axes), _v(starts), _v(ends)
    x = _t(input)
    idx = [builtins_slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[a] = builtins_slice(s, e)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis, negative strides included (gathered by
    index, since torch's slices step forward only)."""
    x = _t(x)
    for a, s, e, st in zip(axes, starts, ends, strides):
        a = int(a) % x.dim()
        rows = range(*builtins_slice(int(s), int(e), int(st)).indices(
            x.shape[a]))
        if st > 0:
            x = torch.narrow(x, a, rows.start, len(rows)) if st == 1 else \
                x[(builtins_slice(None),) * a + (builtins_slice(
                    rows.start, rows.stop, rows.step),)]
        else:
            x = torch.index_select(x, a, torch.tensor(
                list(rows), dtype=torch.int64, device=x.device))
    return x


def crop(x, shape=None, offsets=None, name=None):
    """The window of ``shape`` (-1: to the end) at ``offsets``, which are
    clamped so the window fits (``lax.dynamic_slice``)."""
    x = _t(x)
    shape = _shape_list(shape)
    offsets = _shape_list(offsets) if offsets is not None else [0] * x.dim()
    for d, (sh, off) in enumerate(zip(shape, offsets)):
        size = sh if sh != -1 else x.shape[d] - off
        start = builtins.min(builtins.max(off, 0), x.shape[d] - size)
        x = torch.narrow(x, d, start, size)
    return x


def numel(x, name=None):
    """The element count as a 0-d int64 tensor on ``x``'s device."""
    x = _t(x)
    return _new(torch.tensor(torch.Tensor.numel(x), dtype=torch.int64,
                             device=x.device))


def shape(input):
    """The shape as a 1-D int32 tensor on ``input``'s device."""
    x = _t(input)
    return _new(torch.tensor(list(x.shape), dtype=torch.int32,
                             device=x.device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    x = _t(input)
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(x, size, rounding_mode="floor") == shard_id,
                       torch.remainder(x, size),
                       torch.tensor(ignore_value, dtype=x.dtype,
                                    device=x.device))


def as_complex(x, name=None):
    x = _t(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = _t(x)
    return torch.stack([torch.real(x), torch.imag(x)], -1)


def view(x, shape_or_dtype, name=None):
    """A reshape for a list or tuple; for a dtype the same bytes read as
    that dtype."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return torch.Tensor.view(_t(x), dtypes.convert_dtype(shape_or_dtype))


def _atleast(fn, inputs):
    outs = [fn(_t(x)) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs):
    return _atleast(torch.atleast_3d, inputs)


__all__ = sorted(
    k for k, v in list(globals().items())
    if callable(v) and not k.startswith("_") and
    getattr(v, "__module__", "") == __name__ and
    not k.startswith("builtins"))
