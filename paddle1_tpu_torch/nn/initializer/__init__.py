"""Weight initializers (port of ``paddle1_tpu/nn/initializer``).

Each initializer is a callable ``(shape, dtype) -> torch.Tensor`` with
the JAX package's arguments and the port's own keyword-only
``generator`` (a ``torch.Generator``) and ``device``, taken at
construction or at the call (the constructor's win). A random one draws
in f32 on the CPU from the generator (None: the CPU's default generator,
which ``paddle1_tpu_torch.seed`` seeds) and then moves to the device
(None: the current place), so one seed gives the same weights on either
device. Torch's streams are not the JAX package's: the same seed gives
other numbers there, with the same distribution.

``Layer.create_parameter`` calls an initializer with the layer's
``generator`` and ``device``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ...core import dtype as dtypes

__all__ = [
    "Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Bilinear", "Orthogonal", "Dirac", "calculate_gain",
]


def _fans(shape: Sequence[int]):
    shape = list(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    # conv weight layout NCHW-filter: [out_c, in_c, *spatial]
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "selu": 3.0 / 4.0}
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return gains.get(nonlinearity, 1.0)


class Initializer:
    """Base: subclasses fill :meth:`_values` (f32 on the CPU);
    ``__call__`` casts and moves the result."""

    def __init__(self, *, generator: Optional[torch.Generator] = None,
                 device=None):
        self._generator = generator
        self._device = device

    def _values(self, shape, generator) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, shape, dtype=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
        gen = self._generator if self._generator is not None else generator
        dev = self._device if self._device is not None else device
        if dev is None:
            from ...core.place import get_device
            dev = get_device().torch_device()
        t = self._values(tuple(int(s) for s in shape), gen)
        return t.to(device=dev, dtype=dtypes.convert_dtype(dtype))


def _empty(shape):
    return torch.empty(shape, dtype=torch.float32)


class Constant(Initializer):
    def __init__(self, value: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self.value = value

    def _values(self, shape, generator):
        return torch.full(shape, float(self.value), dtype=torch.float32)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self.low, self.high = low, high

    def _values(self, shape, generator):
        return _empty(shape).uniform_(self.low, self.high,
                                      generator=generator)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self.mean, self.std = mean, std

    def _values(self, shape, generator):
        return _empty(shape).normal_(self.mean, self.std,
                                     generator=generator)


class TruncatedNormal(Initializer):
    """N(mean, std²) cut at two standard deviations."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self.mean, self.std = mean, std

    def _values(self, shape, generator):
        t = torch.nn.init.trunc_normal_(_empty(shape), 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
        return self.mean + self.std * t


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _values(self, shape, generator):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _empty(shape).uniform_(-limit, limit, generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _values(self, shape, generator):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _empty(shape).normal_(0.0, std, generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self._fan_in = fan_in
        self.gain = calculate_gain(nonlinearity, negative_slope)

    def _values(self, shape, generator):
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = self.gain * math.sqrt(3.0 / fi)
        return _empty(shape).uniform_(-limit, limit, generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self._fan_in = fan_in
        self.gain = calculate_gain(nonlinearity, negative_slope)

    def _values(self, shape, generator):
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = self.gain / math.sqrt(fi)
        return _empty(shape).normal_(0.0, std, generator=generator)


class Assign(Initializer):
    """The given values (numpy, a list or a tensor), reshaped to the
    parameter's shape when they differ."""

    def __init__(self, value, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self.value = value

    def _values(self, shape, generator):
        v = self.value
        arr = v.detach().cpu().float().numpy() if isinstance(
            v, torch.Tensor) else np.asarray(v)
        if tuple(arr.shape) != tuple(shape):
            arr = arr.reshape(shape)
        return torch.from_numpy(np.array(arr, dtype=np.float32))


class Bilinear(Initializer):
    """For transposed-conv upsampling kernels (the reference's
    BilinearInitializer); a 4-D weight."""

    def _values(self, shape, generator):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D weight")
        weight = np.zeros(shape, dtype=np.float32)
        f = math.ceil(shape[3] / 2)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape[2:]))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[:, :, y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight)


class Orthogonal(Initializer):
    """``gain`` times a (semi-)orthogonal matrix over the last axis (the
    rows are the other axes flattened), from the QR of a standard normal
    draw with R's diagonal signs folded in, as ``jax.nn.initializers.
    orthogonal`` builds it."""

    def __init__(self, gain: float = 1.0, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self.gain = gain

    def _values(self, shape, generator):
        n_cols = shape[-1] if shape else 1
        n_rows = int(np.prod(shape)) // max(n_cols, 1)
        a = _empty((max(n_rows, n_cols), min(n_rows, n_cols))).normal_(
            generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return self.gain * q.reshape(shape)


class Dirac(Initializer):
    """Identity-preserving conv kernel: 1 at each group's channel pairs'
    spatial centres."""

    def __init__(self, groups: int = 1, name=None, *,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(generator=generator, device=device)
        self.groups = groups

    def _values(self, shape, generator):
        w = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                w[(g * (oc // self.groups) + i, i, *centers)] = 1.0
        return torch.from_numpy(w)
