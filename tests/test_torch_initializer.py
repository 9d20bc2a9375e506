"""The port's initializers (``paddle1_tpu_torch.nn.initializer``) against
the JAX package's (``paddle1_tpu/nn/initializer/__init__.py``).

The deterministic ones (``Constant``, ``Assign``, ``Bilinear``,
``Dirac``), the fans and ``calculate_gain`` must be equal exactly. The
random ones draw from torch's generator, whose stream is not jax's by
design, so both packages are held to the same bounds and moments: the
mean within 5 standard errors, the standard deviation within 2 %, on
2^18 draws.
"""

import math

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
from paddle1_tpu.nn import initializer as JI
from paddle1_tpu_torch.nn import initializer as TI

N = 1 << 18


def _j(init, shape, dtype="float32"):
    return np.asarray(init(shape, dtype))


def _tt(init, shape, dtype="float32", seed=0):
    return init(shape, dtype, generator=torch.Generator().manual_seed(seed),
                device="cpu")


def _tn(init, shape, dtype="float32", seed=0):
    return _tt(init, shape, dtype, seed).float().numpy()


FAN_SHAPES = [[], [7], [3, 5], [8, 4, 3, 3], [16, 2, 5], [6, 2, 1, 3, 3]]


@pytest.mark.parametrize("shape", FAN_SHAPES, ids=str)
def test_fans_are_the_references(shape):
    assert TI._fans(shape) == JI._fans(shape)


GAINS = [("sigmoid", None), ("linear", None), ("conv2d", None),
         ("tanh", None), ("relu", None), ("selu", None),
         ("leaky_relu", None), ("leaky_relu", 0.2), ("unknown", None)]


@pytest.mark.parametrize("name,param", GAINS)
def test_calculate_gain_is_the_references(name, param):
    assert TI.calculate_gain(name, param) == JI.calculate_gain(name, param)


DETERMINISTIC = [
    ("Constant", lambda m: m.Constant(0.25), [4, 3]),
    ("Assign", lambda m: m.Assign(np.arange(12, dtype=np.float32)),
     [3, 4]),
    ("Assign-list", lambda m: m.Assign([[1.5, -2.0], [0.0, 3.0]]), [2, 2]),
    ("Bilinear", lambda m: m.Bilinear(), [2, 3, 4, 4]),
    ("Bilinear-odd", lambda m: m.Bilinear(), [1, 1, 3, 5]),
    ("Dirac", lambda m: m.Dirac(), [4, 4, 3, 3]),
    ("Dirac-groups", lambda m: m.Dirac(groups=2), [6, 3, 3, 3]),
]


@pytest.mark.parametrize("name,make,shape", DETERMINISTIC,
                         ids=[d[0] for d in DETERMINISTIC])
def test_deterministic_initializers_are_the_references(name, make, shape):
    np.testing.assert_array_equal(_tn(make(TI), shape), _j(make(JI), shape))


def test_constant_takes_the_dtype_and_device():
    t = TI.Constant(1.5)([3], "bfloat16", device="cpu")
    assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
    assert (t.float() == 1.5).all()


def _moments(a):
    a = np.asarray(a, np.float64).ravel()
    return a.mean(), a.std(), a.min(), a.max()


def _check_moments(a, mean, std, lo=None, hi=None):
    m, s, amin, amax = _moments(a)
    assert abs(m - mean) <= 5 * std / math.sqrt(a.size), (m, mean)
    assert abs(s - std) <= 0.02 * std, (s, std)
    if lo is not None:
        assert amin >= lo and amax <= hi, (amin, amax, lo, hi)


# shape [N/64, 64] keeps fan_in + fan_out fixed for the Xavier bounds
SHAPE = [N // 64, 64]
FI, FO = SHAPE
U3 = 1 / math.sqrt(3)          # a uniform's std over its half-width
TRUNC_STD = 0.87962566103423978  # std of N(0, 1) cut at +-2

RANDOM = [
    ("Uniform", lambda m: m.Uniform(-0.5, 1.5), 0.5, U3, -0.5, 1.5),
    ("Normal", lambda m: m.Normal(0.3, 2.0), 0.3, 2.0, None, None),
    ("TruncatedNormal", lambda m: m.TruncatedNormal(1.0, 0.5),
     1.0, 0.5 * TRUNC_STD, 0.0, 2.0),
    ("XavierUniform", lambda m: m.XavierUniform(),
     0.0, math.sqrt(6 / (FI + FO)) * U3, -math.sqrt(6 / (FI + FO)),
     math.sqrt(6 / (FI + FO))),
    ("XavierNormal", lambda m: m.XavierNormal(gain=2.0),
     0.0, 2.0 * math.sqrt(2 / (FI + FO)), None, None),
    ("KaimingUniform", lambda m: m.KaimingUniform(),
     0.0, math.sqrt(2) * math.sqrt(3 / FI) * U3,
     -math.sqrt(2) * math.sqrt(3 / FI), math.sqrt(2) * math.sqrt(3 / FI)),
    ("KaimingNormal", lambda m: m.KaimingNormal(nonlinearity="tanh"),
     0.0, 5 / 3 / math.sqrt(FI), None, None),
]


@pytest.mark.parametrize("name,make,mean,std,lo,hi", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_initializers_match_by_bounds_and_moments(name, make, mean,
                                                         std, lo, hi):
    jp.seed(0)
    _check_moments(_j(make(JI), SHAPE), mean, std, lo, hi)
    got = _tt(make(TI), SHAPE)
    assert tuple(got.shape) == tuple(SHAPE) and got.dtype == torch.float32
    _check_moments(got.numpy(), mean, std, lo, hi)


@pytest.mark.parametrize("name,make", [(r[0], r[1]) for r in RANDOM] +
                         [("Orthogonal", lambda m: m.Orthogonal(1.5))],
                         ids=[r[0] for r in RANDOM] + ["Orthogonal"])
def test_random_initializers_follow_the_generator(name, make):
    """One seed, the same values; the generator bound at construction
    wins over the caller's; the default generator is torch's CPU one."""
    a, b = _tn(make(TI), [32, 16], seed=7), _tn(make(TI), [32, 16], seed=7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _tn(make(TI), [32, 16], seed=8))
    bound = make(TI)
    bound._generator = torch.Generator().manual_seed(7)
    np.testing.assert_array_equal(_tn(bound, [32, 16], seed=99), a)
    torch.manual_seed(7)
    np.testing.assert_array_equal(
        make(TI)([32, 16], device="cpu").numpy(), a)


@pytest.mark.parametrize("shape", [[16, 16], [8, 32], [24, 2, 3, 4]],
                         ids=str)
def test_orthogonal_is_orthogonal_like_the_reference(shape):
    jp.seed(0)
    for w in (_j(JI.Orthogonal(1.5), shape),
              _tn(TI.Orthogonal(1.5), shape)):
        assert w.shape == tuple(shape)
        flat = w.reshape(-1, shape[-1])
        small = min(flat.shape)
        gram = flat.T @ flat if flat.shape[0] >= flat.shape[1] else \
            flat @ flat.T
        np.testing.assert_allclose(gram, 2.25 * np.eye(small), atol=1e-5)


def test_initializer_port_arguments_are_keyword_only():
    import inspect
    for cls in (TI.Constant, TI.Normal, TI.XavierUniform, TI.Assign):
        params = inspect.signature(cls).parameters
        assert params["generator"].kind == inspect.Parameter.KEYWORD_ONLY
        assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY
