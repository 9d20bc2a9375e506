"""The op namespace's cases, without JAX: each ``Case`` is one call of a
``paddle1_tpu_torch.ops`` function (or a Tensor method) on seeded numpy
inputs. The parity tests (``tests/test_torch_{math,manip,linalg}_ops.py``,
``tests/test_torch_tensor_patch.py``, through ``tests/test_torch_op_parity.py``)
run each case through the JAX package and the port on the CPU;
``chip_smoke.py`` phase 23 runs each on CUDA tensors against the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

# f32 tolerances (absolute and relative): elementwise ops, reductions,
# linear algebra on reconstructions
ELEM, RED, LINALG = 1e-6, 1e-5, 1e-4


def R(shape, seed=0, kind="n"):
    """Seeded numpy data: ``n`` normal, ``p`` in [0.5, 2), ``u`` in
    (0.1, 0.9), ``i`` int32 in [-5, 5), ``k`` int32 in [0, 5), ``b``
    bool, f32 for the float kinds."""
    rng = np.random.default_rng(seed)
    if kind == "n":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "p":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if kind == "u":
        return rng.uniform(0.1, 0.9, shape).astype(np.float32)
    if kind == "i":
        return rng.integers(-5, 5, shape).astype(np.int32)
    if kind == "k":
        return rng.integers(0, 5, shape).astype(np.int32)
    if kind == "b":
        return rng.random(shape) < 0.5
    raise ValueError(kind)


@dataclass
class Case:
    """``op(*args, **kw)`` in both packages. ``args`` hold numpy arrays
    (made tensors in each package), lists of them, or plain values;
    ``grad`` lists the argument positions whose gradient is compared;
    ``after`` names argument positions whose tensors are compared after
    the call too (in-place ops)."""
    op: str
    args: Sequence[Any]
    kw: dict = field(default_factory=dict)
    grad: Sequence[int] = ()
    tol: float = ELEM
    x64: bool = False
    id: str = ""
    after: Sequence[int] = ()
    check: Optional[Callable] = None   # check(jax_out, port_out) instead

    def name(self):
        return self.id or self.op


def ids(cases):
    seen, out = {}, []
    for c in cases:
        n = c.name()
        seen[n] = seen.get(n, 0) + 1
        out.append(n if seen[n] == 1 else f"{n}-{seen[n]}")
    return out


def np_of(t) -> np.ndarray:
    """A host copy of a tensor of either package (``numpy()``), a plain
    torch tensor included."""
    if type(t) is torch.Tensor:
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy())


def close(want, got, tol=None):
    tol = LINALG if tol is None else tol
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def method(name):
    """``Tensor.name`` called as ``x.name(*rest)``."""
    return lambda x, *a, **k: getattr(x, name)(*a, **k)


def math_cases():
    """The math ops' cases (``tests/test_torch_math_ops.py``)."""
    X, Y = R((3, 4), 1), R((3, 4), 2)
    P, U = R((3, 4), 3, "p"), R((3, 4), 4, "u")
    I1, I2 = R((3, 4), 5, "i"), R((3, 4), 6, "k") + 1
    B1, B2 = R((3, 4), 7, "b"), R((3, 4), 8, "b")
    XN = X.copy()
    XN[0, 1], XN[2, 3] = np.nan, np.inf
    EV = R((2, 6), 9)            # even counts for the median

    BINARY_GRAD = ["add", "subtract", "multiply", "maximum", "minimum", "fmax",
                   "fmin", "atan2", "hypot", "logaddexp"]
    CASES = [Case(op, [X, Y], grad=[0, 1]) for op in BINARY_GRAD]
    CASES += [
        Case("divide", [X, P], grad=[0, 1]),
        Case("pow", [P, Y], grad=[0, 1]),
        Case("add", [X, 2.5], grad=[0], id="add-scalar"),
        Case("multiply", [3, X], grad=[1], id="multiply-scalar-first"),
        Case("subtract", [I1, I2], id="subtract-int"),
        Case("floor_divide", [X, P]),
        Case("floor_divide", [I1, I2], id="floor_divide-int"),
        Case("remainder", [X, P]),
        Case("mod", [I1, I2]),
        Case("floor_mod", [X, -P]),
        Case("copysign", [X, Y], grad=[0]),
        Case("nextafter", [X, Y]),
        Case("ldexp", [X, R((3, 4), 10, "k")], grad=[0]),
        Case("heaviside", [X, Y]),
        Case("gcd", [I1, I2]),
        Case("lcm", [I1, I2]),
        Case("inner", [X, R((5, 4), 11)], grad=[0, 1], tol=RED),
        Case("outer", [R((3,), 12), R((4,), 13)], grad=[0, 1]),
        Case("kron", [R((2, 3), 14), R((3, 2), 15)], grad=[0, 1]),
        Case("cross", [R((4, 3), 16), R((4, 3), 17)], grad=[0, 1], tol=RED),
        Case("dot", [R((5,), 18), R((5,), 19)], grad=[0, 1], tol=RED),
        Case("dot", [X, Y], grad=[0, 1], tol=RED, id="dot-2d"),
        Case("mv", [X, R((4,), 20)], grad=[0, 1], tol=RED),
    ]

    UNARY = {"abs": X, "neg": X, "exp": X, "expm1": X, "log": P, "log2": P,
             "log10": P, "log1p": P, "sqrt": P, "rsqrt": P, "square": X,
             "sin": X, "cos": X, "tan": U, "asin": U, "acos": U, "atan": X,
             "sinh": X, "cosh": X, "tanh": X, "asinh": X, "acosh": P + 1,
             "atanh": U - 0.5, "floor": X * 3, "ceil": X * 3, "round": X * 3,
             "trunc": X * 3, "frac": X * 3, "sign": X, "reciprocal": P,
             "erf": X, "erfinv": U * 2 - 1, "sigmoid": X, "digamma": P,
             "lgamma": P, "i0": X, "i1": X, "conj": X, "real": X, "imag": X,
             "deg2rad": X, "rad2deg": X}
    # library implementations of these special functions differ by a few ulps
    SPECIAL_TOL = {"erfinv": 1e-5, "digamma": 1e-5, "lgamma": 1e-5,
                   "i0": 1e-5, "i1": 1e-5, "tan": 1e-5, "acosh": 1e-5}
    # the imaginary part of real data is a constant in both packages
    CASES += [Case(op, [x], grad=[] if op == "imag" else [0],
                   tol=SPECIAL_TOL.get(op, ELEM)) for op, x in UNARY.items()]
    CASES += [
        Case("angle", [X]),
        Case("isfinite", [XN]), Case("isinf", [XN]), Case("isnan", [XN]),
        Case("abs", [I1], id="abs-int"),
        Case("logit", [U], grad=[0]),
        Case("logit", [U], {"eps": 0.2}, grad=[0], id="logit-eps"),
        Case("lerp", [X, Y, 0.3], grad=[0, 1]),
        Case("clip", [X], {"min": -0.5, "max": 0.7}, grad=[0]),
        Case("clip", [X], {"max": 0.1}, grad=[0], id="clip-max"),
        Case("scale", [X], {"scale": 2.0, "bias": 0.5}, grad=[0]),
        Case("scale", [X], {"scale": 2.0, "bias": 0.5,
                            "bias_after_scale": False, "act": "relu"},
             grad=[0], id="scale-before-relu"),
        Case("stanh", [X], grad=[0]),
        Case("multiplex", [[X, Y, P], np.array([[2], [0], [1]], np.int32)],
             grad=[]),
        Case("matmul", [X, R((4, 5), 21)], grad=[0, 1], tol=RED),
        Case("matmul", [X, Y], {"transpose_y": True}, grad=[0, 1], tol=RED,
             id="matmul-transpose_y"),
        Case("matmul", [R((2, 4, 3), 22), R((5, 4), 23)],
             {"transpose_x": True, "transpose_y": True}, grad=[0, 1], tol=RED,
             id="matmul-batched-transposes"),
        Case("mm", [X, R((4, 2), 24)], grad=[0, 1], tol=RED),
        Case("bmm", [R((2, 3, 4), 25), R((2, 4, 2), 26)], grad=[0, 1], tol=RED),
        Case("addmm", [R((3, 2), 27), X, R((4, 2), 28)],
             {"beta": 0.5, "alpha": 2.0}, grad=[0, 1, 2], tol=RED),
        Case("einsum", ["ij,kj->ik", X, Y], grad=[1, 2], tol=RED),
        # inside torch._int_mm's rules, which the card holds it to
        Case("matmul_int8", [R((32, 16), 29, "i").astype(np.int8),
                             R((16, 8), 30, "i").astype(np.int8)]),
        Case("broadcast_shape", [[3, 1, 4], [2, 1]]),
        Case("add_n", [[X, Y, P]], grad=[]),
        Case("trace", [R((4, 4), 31)], grad=[0], tol=RED),
        Case("trace", [R((2, 3, 4), 32)], {"offset": 1, "axis1": 1, "axis2": 2},
             grad=[0], tol=RED, id="trace-offset"),
        Case("diagonal", [R((2, 3, 4), 33)], {"offset": -1, "axis1": 1,
                                              "axis2": 2}, grad=[0]),
    ]

    REDUCTIONS = ["sum", "mean", "prod", "max", "min", "amax", "amin",
                  "logsumexp"]
    AXES = [dict(), dict(axis=1), dict(axis=[0, 1], keepdim=True),
            dict(axis=-1, keepdim=True)]
    CASES += [Case(op, [X], kw, grad=[0], tol=RED, id=f"{op}-{i}")
              for op in REDUCTIONS for i, kw in enumerate(AXES)]
    CASES += [
        # without x64 the reference's float64 is float32
        Case("sum", [X], {"axis": 0, "dtype": "float64"}, x64=True,
             id="sum-dtype"),
        Case("sum", [I1], {"axis": 1}, id="sum-int"),
        Case("sum", [B1], id="sum-bool", x64=True),
        Case("mean", [I1], id="mean-int", tol=RED),
        Case("nansum", [np.where(np.isinf(XN), np.nan, XN)], {"axis": 1},
             tol=RED),
        Case("nanmean", [np.where(np.isinf(XN), np.nan, XN)], {"axis": 0},
             tol=RED),
        Case("all", [B1], {"axis": 1}), Case("any", [B1]),
        Case("all", [X], id="all-float"),
        Case("std", [X], {"axis": 1}, grad=[0], tol=RED),
        Case("std", [X], {"unbiased": False}, grad=[0], tol=RED, id="std-all"),
        Case("var", [X], {"axis": [0, 1], "keepdim": True}, grad=[0], tol=RED),
        Case("median", [EV], {"axis": 1}, grad=[0], tol=RED),
        Case("median", [EV], grad=[0], tol=RED, id="median-all"),
        Case("median", [R((3, 5), 34)], {"axis": 0, "keepdim": True},
             grad=[0], tol=RED, id="median-odd-keepdim"),
        Case("quantile", [X, 0.3], {"axis": 1}, grad=[0], tol=RED),
        Case("quantile", [X, [0.2, 0.9]], grad=[0], tol=RED,
             id="quantile-list"),
        Case("cumsum", [X], {"axis": 1}, grad=[0], tol=RED),
        Case("cumsum", [X], grad=[0], tol=RED, id="cumsum-flat"),
        Case("cumsum", [I1], {"axis": 0, "dtype": "float32"}, id="cumsum-dtype"),
        Case("cumprod", [P], {"dim": 1}, grad=[0], tol=RED),
        Case("cummax", [X], {"axis": 1}, grad=[0]),
        Case("cummax", [X], grad=[0], id="cummax-flat"),
    ]

    CMP = ["equal", "not_equal", "greater_than", "greater_equal", "less_than",
           "less_equal"]
    XE = np.where(R((3, 4), 35, "b"), Y, X)      # some elements equal to Y
    CASES += [Case(op, [XE, Y]) for op in CMP]
    CASES += [Case("equal", [I1, 2], id="equal-scalar")]
    CASES += [Case(op, [B1, B2]) for op in ("logical_and", "logical_or",
                                            "logical_xor")]
    CASES += [Case("logical_not", [B1])]
    CASES += [Case(op, [I1, I2]) for op in ("bitwise_and", "bitwise_or",
                                            "bitwise_xor")]
    CASES += [
        Case("bitwise_not", [I1]),
        Case("equal_all", [X, X.copy()]),
        Case("equal_all", [X, Y], id="equal_all-differs"),
        Case("allclose", [X, X + 1e-7]),
        Case("allclose", [X, Y], id="allclose-differs"),
        Case("isclose", [XE, Y + 1e-6], {"atol": 1e-5}),
        Case("where", [B1, X, Y], grad=[1, 2]),
        Case("where", [X > 0, X, 0.0], grad=[1], id="where-scalar"),
        Case("where", [B1], x64=True, id="where-condition-only"),
        Case("nonzero", [B1], x64=True),
        Case("nonzero", [I1], {"as_tuple": True}, x64=True,
             id="nonzero-as_tuple"),
        Case("argmax", [X], x64=True), Case("argmin", [X], x64=True),
        Case("argmax", [X], {"axis": 1, "keepdim": True}, x64=True,
             id="argmax-axis"),
        Case("argmin", [X], {"axis": 0}, x64=True, id="argmin-axis"),
        Case("argmax", [X], {"axis": 1, "dtype": "int32"}, id="argmax-int32"),
        Case("argsort", [X], x64=True),
        Case("argsort", [X], {"axis": 0, "descending": True}, x64=True,
             id="argsort-descending"),
        Case("sort", [X], {"axis": 0}, grad=[0]),
        Case("sort", [X], {"descending": True}, grad=[0], id="sort-descending"),
        Case("topk", [X, 2], grad=[0], x64=True),
        Case("topk", [X, 2], {"axis": 0, "largest": False}, grad=[0], x64=True,
             id="topk-smallest"),
        Case("searchsorted", [np.sort(R((6,), 36)), X], x64=True),
        Case("searchsorted", [np.sort(R((3, 6), 37), -1), X],
             {"right": True, "out_int32": True}, id="searchsorted-2d-int32"),
        Case("unique", [R((3, 4), 38, "k")]),
        Case("unique", [R((3, 4), 38, "k"), True, True, True], x64=True,
             id="unique-all"),
        Case("unique", [R((6, 2), 39, "k") % 2], {"return_inverse": True,
                                                   "axis": 0}, x64=True,
             id="unique-axis"),
        Case("bincount", [R((10,), 40, "k")], {"minlength": 7}, x64=True),
        Case("bincount", [R((10,), 40, "k"), R((10,), 41, "p")],
             id="bincount-weights", tol=RED),
        Case("histogram", [X], {"bins": 5}, x64=True),
        Case("histogram", [X], {"bins": 4, "min": -1, "max": 1}, x64=True,
             id="histogram-range"),
        # the reference selects on the host, outside its graph
        Case("masked_select", [X, B1]),
        Case("index_sample", [X, np.array([[0, 3], [1, 1], [2, 0]], np.int32)],
             grad=[0]),
        Case("index_select", [X, np.array([3, 0], np.int32)], {"axis": 1},
             grad=[0]),
        Case("index_select", [X, np.array([[2, 0], [1, 1]], np.int32)],
             grad=[0], id="index_select-2d-index"),
        Case("mode", [R((3, 7), 42, "k")], x64=True),
    ]
    CASES += [Case("increment", [X, 2.0], after=[0]),
              Case("tanh_", [X], after=[0]), Case("is_tensor", [X])]
    return CASES



def manip_cases():
    """The manipulation ops' cases (``tests/test_torch_manip_ops.py``)."""
    X, Y = R((3, 4), 1), R((3, 4), 2)
    X3 = R((2, 3, 4), 3)
    I1 = R((3, 4), 5, "i")
    B1 = R((3, 4), 7, "b")
    IDX = np.array([2, 0], np.int32)

    CASES = [
        Case("zeros", [[2, 3]]), Case("ones", [[2, 3]], {"dtype": "int32"}),
        Case("full", [[2, 3], 1.5]),
        Case("full", [[2], 7], x64=True, id="full-int"),
        Case("full", [[2], True], id="full-bool"),
        Case("empty", [[2, 3]]),
        Case("zeros_like", [X]), Case("ones_like", [I1]),
        Case("full_like", [X, 2.5]), Case("empty_like", [X]),
        Case("zeros_like", [X], {"dtype": "int32"}, id="zeros_like-dtype"),
        Case("arange", [5], x64=True),
        Case("arange", [1, 10, 3], x64=True, id="arange-step"),
        Case("arange", [0.0, 1.0, 0.25], id="arange-float"),
        Case("linspace", [0.0, 1.0, 5]),
        Case("logspace", [0.0, 2.0, 3]),
        Case("eye", [3]), Case("eye", [2, 4], id="eye-rect"),
        Case("diag", [R((3,), 10)], grad=[0]),
        Case("diag", [R((3,), 10)], {"offset": 1, "padding_value": 9.0},
             grad=[0], id="diag-offset-padding"),
        Case("diag", [X], {"offset": -1}, grad=[0], id="diag-of-matrix"),
        Case("diagflat", [R((2, 2), 11)], {"offset": 1}, grad=[0]),
        Case("meshgrid", [R((3,), 12), R((2,), 13)], grad=[0]),
        Case("meshgrid", [[R((3,), 12), R((2,), 13)]], id="meshgrid-list"),
        Case("tril", [X], grad=[0]), Case("triu", [X], {"diagonal": 1},
                                          grad=[0]),
        Case("clone", [X], grad=[0]),
        Case("assign", [X], grad=[0]),
        Case("assign", [[[1.0, 2.0]]], id="assign-data"),
        Case("cast", [X, "int32"]), Case("cast", [I1, "float32"],
                                         id="cast-int-float"),
        Case("cast", [X, "bool"], id="cast-bool"),
        Case("cast", [X, "float64"], x64=True, grad=[0], id="cast-float64"),
        Case("reshape", [X, [2, -1]], grad=[0]),
        Case("reshape", [X3, (4, 6)], grad=[0], id="reshape-tuple"),
        Case("transpose", [X3, [1, 0, 2]], grad=[0]),
        Case("transpose_", [X3, [2, 0, 1]], grad=[0]),
        Case("t", [X], grad=[0]), Case("t", [R((3,), 14)], id="t-1d"),
        Case("moveaxis", [X3, 0, -1], grad=[0]),
        Case("swapaxes", [X3, 0, 2], grad=[0]),
        Case("flatten", [X3], grad=[0]),
        Case("flatten", [X3, 1], grad=[0], id="flatten-from-1"),
        Case("squeeze", [R((1, 3, 1), 15)], grad=[0]),
        Case("squeeze", [R((1, 3, 1), 15), [0, 1]], grad=[0],
             id="squeeze-list-keeps-non-unit"),
        Case("squeeze_", [R((1, 3, 1), 15), -1]),
        Case("unsqueeze", [X, [0, 2]], grad=[0]),
        Case("unsqueeze", [X, -1], grad=[0], id="unsqueeze-negative"),
        Case("unsqueeze_", [X, 1]),
        Case("concat", [[X, Y], 1], grad=[]),
        Case("stack", [[X, Y], -1]),
        Case("split", [X, 3], grad=[0]),
        Case("split", [R((2, 12), 16), 3, 1], id="split-3-along-1"),
        Case("split", [X, [1, -1, 2], 1], grad=[0], id="split-sections"),
        Case("unstack", [X3, 1], grad=[0]), Case("unbind", [X3, 2], grad=[0]),
        Case("chunk", [X3, 2, 2], grad=[0]),
        Case("tile", [X, [2, 1]], grad=[0]),
        Case("tile", [R((3,), 17), [2, 2]], id="tile-prepends"),
        Case("expand", [R((3, 1), 18), [2, 3, 4]], grad=[0]),
        Case("expand", [R((3, 1), 18), [-1, 5]], grad=[0], id="expand-minus1"),
        Case("expand_as", [R((1, 4), 19), X], grad=[0]),
        Case("broadcast_to", [R((1, 4), 19), [3, 4]], grad=[0]),
        Case("broadcast_tensors", [[R((3, 1), 20), R((1, 4), 21)]]),
        Case("flip", [X3, [0, 2]], grad=[0]),
        Case("flip", [X, 1], grad=[0], id="flip-int"),
        Case("rot90", [X], grad=[0]),
        Case("rot90", [X3, 3, [1, 2]], grad=[0], id="rot90-k3"),
        Case("roll", [X, 1], grad=[0]),
        Case("roll", [X, [1, -1], [0, 1]], grad=[0], id="roll-axes"),
        Case("gather", [X, IDX], grad=[0]),
        Case("gather", [X, IDX, 1], grad=[0], id="gather-axis1"),
        Case("gather_nd", [X3, np.array([[0, 1], [1, 2]], np.int32)], grad=[0]),
        Case("take_along_axis", [X, np.array([[0, 3], [1, 1], [2, 0]],
                                             np.int32), 1], grad=[0]),
        Case("put_along_axis", [X, np.array([[0], [3], [1]], np.int32), Y[:, :1],
                                1], grad=[0]),
        Case("put_along_axis", [X, np.array([[0, 0], [3, 1], [1, 1]], np.int32),
                                2.0, 1, "add"], grad=[0], id="put_along_axis-add"),
        Case("put_along_axis", [X, np.array([[0], [3], [1]], np.int32), 3.0, 1,
                                "multiply"], id="put_along_axis-multiply"),
        Case("scatter", [X, IDX, R((2, 4), 22)], grad=[0]),
        Case("scatter", [X, np.array([1, 1, 0], np.int32), R((3, 4), 23), False],
             grad=[0], id="scatter-accumulate"),
        Case("scatter_nd_add", [X, np.array([[0, 1], [2, 3], [0, 1]], np.int32),
                                R((3,), 24)], grad=[0]),
        Case("scatter_nd", [np.array([[1], [0], [1]], np.int32), R((3, 4), 25),
                            [2, 4]]),
        Case("index_add", [X, IDX, 0, R((2, 4), 26)], grad=[0]),
        Case("index_put", [X, [np.array([0, 2], np.int32),
                               np.array([1, 3], np.int32)], R((2,), 27)],
             grad=[0]),
        Case("index_put", [X, [np.array([0, 0], np.int32),
                               np.array([1, 1], np.int32)], R((2,), 27), True],
             id="index_put-accumulate"),
        Case("masked_fill", [X, B1, -1.0], grad=[0]),
        Case("masked_fill", [X, B1, np.float32(3.0) * np.ones((), np.float32)],
             id="masked_fill-tensor"),
        Case("fill_diagonal", [X, 5.0], grad=[0]),
        Case("repeat_interleave", [X, 2, 1], grad=[0]),
        Case("repeat_interleave", [R((3,), 28), np.array([1, 0, 2], np.int32)],
             id="repeat_interleave-tensor"),
        Case("slice", [X3, [0, 2], [1, 1], [2, 100]], grad=[0]),
        Case("strided_slice", [X3, [1, 2], [0, 3], [3, 0], [2, -1]], grad=[0]),
        Case("crop", [X, [2, 2], [1, 1]], grad=[0]),
        Case("crop", [X, [2, -1], [1, 1]], grad=[0], id="crop-to-end"),
        Case("crop", [X, [2, 3], [2, 3]], id="crop-clamped"),
        Case("numel", [X], x64=True),
        Case("shape", [X3]),
        Case("shard_index", [np.array([[1], [6], [12], [19]], np.int32), 20, 2,
                             1]),
        Case("as_complex", [R((3, 2), 29)]),
        Case("view", [X, [4, 3]], grad=[0]),
        Case("view", [X, "int32"], id="view-dtype"),
        Case("atleast_1d", [np.float32(2.0) * np.ones((), np.float32)]),
        Case("atleast_2d", [R((3,), 30)]),
        Case("atleast_3d", [X]),
        Case("atleast_3d", [R((3,), 30), X], id="atleast_3d-many"),
    ]
    CASES += [
        Case("as_real", [(X + 1j * Y).astype(np.complex64)]),
        Case("reshape_", [X, [6, 2]], after=[0]),
        Case("flatten_", [X3], after=[0]),
        Case("scatter_", [X, IDX, Y[:2]], after=[0]),
    ]
    return CASES



def linalg_cases():
    """The linear algebra cases (``tests/test_torch_linalg_ops.py``)."""
    A = R((4, 4), 1) + 4 * np.eye(4, dtype=np.float32)     # well conditioned
    SPD = (A @ A.T + np.eye(4, dtype=np.float32)).astype(np.float32)
    B = R((4, 2), 2)
    TALL = R((6, 3), 3)
    LOW = (R((5, 2), 4) @ R((2, 4), 5)).astype(np.float32)      # rank 2
    UPPER = np.triu(A).astype(np.float32)
    L = np.linalg.cholesky(SPD).astype(np.float32)
    ROT = np.array([[0.0, -2.0, 0.5], [1.0, 0.0, 0.2], [0.0, 0.3, 1.5]],
                   np.float32)    # complex eigenvalues


    def _svd_check(x):
        def check(jo, to):
            u, s, vh = (np_of(t) for t in to)
            close(np_of(jo[1]), s)
            close(x, (u * s[..., None, :]) @ vh)
            assert [np_of(t).shape for t in jo] == [np_of(t).shape for t in to]
        return check


    def _qr_check(x):
        def check(jo, to):
            q, r = (np_of(t) for t in to)
            close(x, q @ r)
            close(np.eye(q.shape[-1]), q.T @ q)
            close(np.abs(np_of(jo[1])), np.abs(r))     # R up to row signs
        return check


    def _eigh_check(x):
        def check(jo, to):
            w, v = (np_of(t) for t in to)
            close(np_of(jo[0]), w)
            close(x, (v * w) @ v.T)
        return check


    def _eig_check(x):
        def check(jo, to):
            w, v = (np_of(t) for t in to)
            assert str(to[0].dtype) == "torch.complex64"
            close(np.sort_complex(np_of(jo[0])), np.sort_complex(w))
            close(x.astype(np.complex64) @ v, v * w)
        return check


    def _eigvals_check(jo, to):
        close(np.sort_complex(np_of(jo)), np.sort_complex(np_of(to)))


    def _lstsq_check(jo, to):
        sol, res, rank, sv = to
        close(np_of(jo[0]), np_of(sol))
        close(np_of(jo[1]), np_of(res))
        assert int(np_of(rank)) == int(np_of(jo[2])) and str(rank.dtype) == \
            "torch.int32"
        close(np_of(jo[3]), np_of(sv))


    CASES = [
        Case("cholesky", [SPD], grad=[0], tol=LINALG),
        Case("cholesky", [SPD], {"upper": True}, grad=[0], tol=LINALG,
             id="cholesky-upper"),
        Case("inv", [A], grad=[0], tol=LINALG),
        Case("inverse", [A], tol=LINALG),
        Case("pinv", [TALL], grad=[0], tol=LINALG),
        Case("svd", [TALL], check=_svd_check(TALL)),
        Case("qr", [TALL], check=_qr_check(TALL)),
        Case("lu", [A], tol=LINALG),
        Case("lu", [A], {"get_infos": True}, tol=LINALG, id="lu-infos"),
        Case("matrix_power", [A * 0.5, 3], grad=[0], tol=LINALG),
        Case("det", [A], grad=[0], tol=LINALG),
        Case("slogdet", [A], grad=[0], tol=LINALG),
        Case("solve", [A, B], grad=[0, 1], tol=LINALG),
        Case("solve", [A, R((4,), 6)], grad=[0, 1], tol=LINALG,
             id="solve-vector"),
        Case("triangular_solve", [UPPER, B], grad=[1], tol=LINALG),
        Case("triangular_solve", [UPPER, B], {"transpose": True,
                                              "unitriangular": True},
             grad=[1], tol=LINALG, id="triangular_solve-transposed"),
        Case("cholesky_solve", [B, L], {"upper": False}, grad=[0], tol=LINALG),
        Case("lstsq", [TALL, R((6, 2), 7)], check=_lstsq_check),
        Case("lstsq", [LOW, R((5,), 8)], id="lstsq-rank-deficient",
             check=_lstsq_check),
        Case("eig", [ROT], check=_eig_check(ROT)),
        Case("eigh", [SPD], check=_eigh_check(SPD)),
        Case("eigvals", [ROT], check=_eigvals_check),
        Case("eigvalsh", [SPD], grad=[0], tol=LINALG),
        Case("norm", [A], grad=[0], tol=LINALG),
        Case("norm", [TALL], {"p": 1, "axis": 0}, grad=[0], tol=LINALG,
             id="norm-1"),
        Case("norm", [TALL], {"p": float("inf"), "axis": [0, 1],
                              "keepdim": True}, grad=[0], tol=LINALG,
             id="norm-inf"),
        Case("norm", [TALL], {"p": 0, "axis": 1}, tol=LINALG, id="norm-0"),
        Case("norm", [TALL], {"p": 3, "axis": 1}, grad=[0], tol=LINALG,
             id="norm-3"),
        Case("norm", [TALL], {"p": "fro", "axis": [0, 1]}, grad=[0],
             tol=LINALG, id="norm-fro-axes"),
        Case("dist", [A, SPD * 0.1], grad=[0, 1], tol=LINALG),
        Case("cond", [A], tol=LINALG),
        Case("matrix_rank", [LOW], x64=True),
        Case("matrix_rank", [LOW], {"tol": 0.5}, x64=True,
             id="matrix_rank-tol"),
        Case("multi_dot", [[A, B, R((2, 3), 9)]], grad=[], tol=LINALG),
        Case("cov", [TALL], grad=[0], tol=LINALG),
        Case("cov", [TALL], {"rowvar": False, "ddof": False}, grad=[0],
             tol=LINALG, id="cov-columns"),
        Case("corrcoef", [TALL], grad=[0], tol=LINALG),
        Case("householder_product", [TALL, R((3,), 10, "u")], grad=[0],
             tol=LINALG),
    ]
    return CASES



def method_cases():
    """The Tensor methods' cases (``tests/test_torch_tensor_patch.py``)."""
    X, Y = R((3, 4), 1), R((3, 4), 2)
    X3 = R((2, 3, 4), 3)
    P = R((3, 4), 4, "p")
    B1 = R((3, 4), 5, "b")
    IDX = np.array([2, 0], np.int32)


    M = [
        Case("astype", [X, "int32"]), Case("cast", [X, "float16"]),
        Case("reshape", [X, [2, 6]], grad=[0]),
        Case("reshape", [X, 6, 2], grad=[0], id="reshape-ints"),
        Case("sum", [X], {"axis": 1}, grad=[0], tol=RED),
        Case("sum", [X, 0, True], grad=[0], tol=RED, id="sum-positional"),
        Case("mean", [X], {"axis": [0, 1]}, grad=[0], tol=RED),
        Case("max", [X, 1], grad=[0]), Case("min", [X], grad=[0]),
        Case("all", [B1], {"axis": 0}), Case("any", [B1]),
        Case("abs", [X], grad=[0]), Case("pow", [P, 2.0], grad=[0]),
        Case("dim", [X]), Case("numel_", [X]),
        Case("numel", [X], x64=True),
        Case("matmul", [X, Y], {"transpose_y": True}, grad=[0, 1], tol=RED),
        Case("split", [R((2, 12), 6), 3, 1], grad=[0]),
        Case("split", [R((2, 12), 6), [4, 8]], {"axis": 1}, grad=[0],
             id="split-sections"),
        Case("chunk", [X, 2, 1], grad=[0]),
        Case("transpose", [X3, [2, 0, 1]], grad=[0]),
        Case("unsqueeze", [X, [0, 3]], grad=[0]),
        Case("squeeze", [R((1, 3, 1), 7), [0]], grad=[0]),
        Case("flatten", [X3, 1], grad=[0]),
        Case("gather", [X, IDX, 1], grad=[0]),
        Case("index_select", [X, IDX], grad=[0]),
        Case("index_add", [X, IDX, 0, R((2, 4), 8)], grad=[0]),
        Case("scatter", [X, IDX, R((2, 4), 9)], grad=[0]),
        Case("median", [X, 1], grad=[0], tol=RED),
        Case("unique", [np.round(X), True, True, True], x64=True),
        Case("where", [B1, X, Y], grad=[1, 2]),
        Case("cumsum", [X], grad=[0], tol=RED),
        Case("cumsum", [X, 0], grad=[0], tol=RED, id="cumsum-axis"),
        Case("dot", [X, Y], grad=[0, 1], tol=RED),
        Case("equal", [X, X]), Case("equal_all", [X, X]),
        Case("topk", [X, 2], grad=[0], x64=True),
        Case("argmax", [X, 1], x64=True), Case("argsort", [X], x64=True),
        Case("sort", [X, 0], grad=[0]),
        Case("expand", [R((3, 1), 10), [3, 5]], grad=[0]),
        Case("tile", [X, [1, 2]], grad=[0]),
        Case("flip", [X, [0]], grad=[0]), Case("roll", [X, 1, 1], grad=[0]),
        Case("clip", [X, -0.5, 0.5], grad=[0]),
        Case("scale", [X, 2.0, 1.0], grad=[0]),
        Case("stanh", [X], grad=[0]),
        Case("gather_nd", [X3, np.array([[1, 2]], np.int32)], grad=[0]),
        Case("take_along_axis", [X, np.array([[1], [0], [3]], np.int32), 1],
             grad=[0]),
        Case("put_along_axis", [X, np.array([[1], [0], [3]], np.int32), 0.0, 1],
             grad=[0]),
        Case("masked_fill", [X, B1, 0.0], grad=[0]),
        Case("masked_select", [X, B1]),
        Case("slice", [X3, [1], [1], [3]], grad=[0]),
        Case("strided_slice", [X3, [2], [3], [0], [-2]], grad=[0]),
        Case("repeat_interleave", [X, 2, 0], grad=[0]),
        Case("trace", [X], grad=[0], tol=RED),
        Case("diagonal", [X3, 0, 1, 2], grad=[0]),
        Case("var", [X, 1], grad=[0], tol=RED),
        Case("std", [X], grad=[0], tol=RED),
        Case("logsumexp", [X, 1], grad=[0], tol=RED),
        Case("mode", [np.round(X3)], x64=True),
        Case("unbind", [X3, 1], grad=[0]),
        Case("view", [X, [4, 3]], grad=[0]),
        Case("cummax", [X, 1], grad=[0]),
        Case("nonzero", [B1], x64=True),
        Case("increment", [X, 2.0], after=[0]),
        Case("tanh_", [X], after=[0]),
        Case("scale_", [X, 2.0, 0.5], after=[0]),
        Case("add_", [X, Y], after=[0]),
        Case("subtract_", [X, 1.5], after=[0]),
        Case("multiply_", [X, Y], after=[0]),
        Case("clip_", [X, -0.1, 0.2], after=[0]),
        Case("zero_", [X], after=[0]), Case("fill_", [X, 3.0], after=[0]),
        Case("reshape_", [X, [4, 3]], after=[0]),
        Case("flatten_", [X3], after=[0]),
        Case("scatter_", [X, IDX, R((2, 4), 11)], after=[0]),
        Case("get_tensor", [X]),
    ]
    return M



def sequence_cases():
    """``ops/sequence_ops.py``'s 18 ops (``tests/test_torch_sequence_ops.py``)
    on ragged rows, an empty row among them."""
    D3 = R((3, 5, 4), 30)
    L = np.array([5, 2, 0], np.int32)
    L1 = np.array([3, 1, 4], np.int32)
    FLAT = R((8, 4), 31)
    IDS = np.array([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3], [5, 8, 9, 7, 9]],
                   np.int64)
    W = R((3 * 4, 6), 32)
    return [
        Case("sequence_mask", [L], {"maxlen": 6}, x64=True),
        Case("sequence_mask", [L1], {"dtype": "float32"},
             id="sequence_mask-float"),
        Case("sequence_pad", [FLAT, np.float32(-1.0), L1], grad=[0],
             x64=True),
        Case("sequence_pad", [FLAT, np.float32(0.5), L1], {"maxlen": 6},
             grad=[0], x64=True, id="sequence_pad-maxlen"),
        Case("sequence_unpad", [D3, L], grad=[0]),
        Case("sequence_pool", [D3, L], grad=[0], tol=RED),
        Case("sequence_pool", [D3, L, "average"], grad=[0], tol=RED,
             id="sequence_pool-average"),
        Case("sequence_pool", [D3, L, "sqrt"], grad=[0], tol=RED,
             id="sequence_pool-sqrt"),
        Case("sequence_pool", [D3, L1, "max"], grad=[0],
             id="sequence_pool-max"),
        Case("sequence_pool", [IDS, L1, "max"], x64=True,
             id="sequence_pool-max-int"),
        Case("sequence_pool", [D3, L, "last"], grad=[0],
             id="sequence_pool-last"),
        Case("sequence_first_step", [D3, L], grad=[0]),
        Case("sequence_last_step", [D3, L1], grad=[0]),
        Case("sequence_softmax", [D3, L1], grad=[0], tol=RED),
        Case("sequence_expand", [R((3, 2), 33), L1], grad=[0]),
        Case("sequence_expand_as", [R((3, 2), 34), L], grad=[0]),
        Case("sequence_reverse", [D3, L], grad=[0]),
        Case("sequence_concat", [[FLAT, R((6, 4), 35)],
                                 [L1, np.array([2, 0, 4], np.int32)]],
             x64=True),
        Case("sequence_conv", [D3, L1, W, 3], grad=[0, 2], tol=RED),
        Case("sequence_conv", [D3, L1, W, 3, -2, R((6,), 36)],
             grad=[0, 2, 5], tol=RED, id="sequence_conv-start-bias"),
        Case("sequence_enumerate", [IDS, L1, 3], {"pad_value": -1},
             x64=True),
        Case("sequence_erase", [IDS, L1, [1, 9]], x64=True),
        Case("sequence_reshape", [R((3, 4, 6), 37),
                                  np.array([4, 2, 0], np.int32), 3],
             grad=[0]),
        Case("sequence_scatter", [R((3, 6), 38),
                                  np.array([[0, 2, 2], [5, 1, 0],
                                            [3, 3, 4]], np.int64),
                                  R((3, 3), 39), L1], grad=[0, 2]),
        Case("sequence_slice", [D3, np.array([1, 0, 2], np.int64),
                                np.array([3, 2, 0], np.int64)], grad=[0],
             x64=True),
        Case("sequence_topk_avg_pooling", [D3, L1, [1, 2, 6]], grad=[0],
             tol=RED),
    ]


def _boxes(n, seed, scale=10.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, scale * 0.6, (n, 2))
    wh = rng.uniform(scale * 0.05, scale * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _jpeg_bytes(channels, seed, quality=90):
    """A seeded image (smooth, so the codec's rounding is exercised on
    structure) as baseline JPEG bytes from the port's encoder, uint8."""
    from paddle1_tpu_torch.core.jpeg import encode_jpeg_bytes
    rng = np.random.default_rng(seed)
    h, w = 21, 34
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(yy * 9 + xx * 5 + c * 40) % 256 for c in
                    range(channels)], -1) + rng.integers(0, 30, (h, w, 1))
    return np.frombuffer(encode_jpeg_bytes(np.clip(img, 0, 255).astype(
        np.uint8), quality=quality), np.uint8).copy()


def _jpeg_file(data):
    """``data`` written once a process to a file under the temporary
    directory (``read_file``'s case reads it)."""
    import os
    import tempfile
    path = os.path.join(tempfile.gettempdir(),
                        f"paddle1_tpu_torch_case_{os.getpid()}.jpg")
    if not os.path.exists(path):
        with open(path, "wb") as f:
            f.write(data.tobytes())
    return path


def vision_cases():
    """``vision/ops.py``'s names (``tests/test_torch_vision_ops.py``)
    beyond the inference four, and ``yolo_loss``; ``DeformConv2D`` is a
    layer, tested there. The JPEG pair decodes bytes the port's encoder
    wrote (the JAX package's encoder, copied)."""
    RGB, GRAY = _jpeg_bytes(3, 60), _jpeg_bytes(1, 61, quality=75)
    PRI, TGT = _boxes(5, 40), _boxes(4, 41)
    VAR = R((5, 4), 42, "u") * 0.3
    OFF = R((4, 5, 4), 43) * 0.2
    BX, SC = _boxes(30, 44), R((3, 30), 45, "u")
    FEAT, ROIS = R((2, 3, 12, 10), 46), _boxes(5, 47, 9.0)
    NUMS = np.array([2, 3], np.int32)
    X, OFFS = R((2, 4, 7, 6), 48), R((2, 36, 4, 3), 49) * 1.3
    W, B = R((6, 2, 3, 3), 50), R((6,), 51)
    MASK = R((2, 18, 4, 3), 52, "u")
    HEAD = R((2, 3 * 9, 4, 4), 53) * 1.5
    GT = np.concatenate([R((2, 5, 2), 54, "u"), R((2, 5, 2), 55, "u") * 0.5],
                        -1)
    LAB = np.array([[0, 3, 1, 2, -1], [3, 3, 0, -1, -1]], np.int32)
    ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    return [
        Case("box_coder", [PRI, VAR, TGT], grad=[2], tol=RED),
        Case("box_coder", [PRI, None, TGT], {"box_normalized": False},
             grad=[2], tol=RED, id="box_coder-unnormalized"),
        Case("box_coder", [PRI, VAR, OFF],
             {"code_type": "decode_center_size"}, grad=[2], tol=RED,
             id="box_coder-decode"),
        Case("box_coder", [PRI[:4], R((4,), 56, "u"), OFF],
             {"code_type": "decode_center_size", "axis": 1}, grad=[2],
             tol=RED, id="box_coder-decode-axis1"),
        Case("matrix_nms", [BX, SC], {"score_threshold": 0.1,
                                      "post_threshold": 0.05,
                                      "nms_top_k": 40, "keep_top_k": 20},
             tol=RED),
        Case("matrix_nms", [BX, SC], {"use_gaussian": True,
                                      "score_threshold": 0.1},
             tol=RED, id="matrix_nms-gaussian"),
        Case("roi_align", [FEAT, ROIS, NUMS],
             {"output_size": 3, "spatial_scale": 0.9,
              "sampling_ratio": 2}, grad=[0, 1], tol=RED),
        Case("roi_align", [FEAT, ROIS], {"output_size": (2, 4),
                                         "aligned": False},
             grad=[0], tol=RED, id="roi_align-unaligned"),
        Case("roi_pool", [FEAT, ROIS, NUMS], {"output_size": 3}, grad=[0],
             tol=RED),
        Case("prior_box", [np.zeros((1, 4, 5, 6), np.float32),
                           np.zeros((1, 3, 40, 48), np.float32),
                           [8.0, 16.0]],
             {"max_sizes": [12.0, 20.0], "aspect_ratios": [2.0, 3.0],
              "flip": True, "clip": True}, tol=RED),
        Case("generate_anchors", [16, (32, 64)], tol=RED),
        Case("distribute_fpn_proposals", [_boxes(20, 57, 300.0), 2, 5, 4,
                                          224], x64=True),
        Case("deform_conv2d", [X, OFFS, W, B],
             {"stride": 2, "padding": 1, "deformable_groups": 2,
              "groups": 2}, grad=[0, 1, 2, 3], tol=RED),
        Case("deform_conv2d", [X, OFFS, W, None, 2, 1, 1, 2, 2, MASK],
             grad=[0, 1, 2, 9], tol=RED, id="deform_conv2d-v2"),
        Case("yolo_loss", [HEAD, GT, LAB, ANCHORS, [3, 4, 5], 4, 0.7, 16],
             grad=[0], tol=RED),
        Case("yolo_loss", [HEAD, GT, LAB, ANCHORS, [3, 4, 5], 4, 0.5, 16,
                           R((2, 5), 58, "u")],
             {"use_label_smooth": False, "scale_x_y": 1.1}, grad=[0],
             tol=RED, id="yolo_loss-scores-scale"),
        Case("read_file", [_jpeg_file(RGB)]),
        Case("decode_jpeg", [RGB]),
        Case("decode_jpeg", [RGB], {"mode": "gray"}, id="decode_jpeg-gray"),
        Case("decode_jpeg", [GRAY], id="decode_jpeg-one-channel"),
    ]


# the random ops: ``(name, draw(namespace, **generator), support, (mean,
# variance))``; ``namespace`` has the package's ops and ``to_tensor``
N = 20000
RANDOM = [
    ("rand", lambda m, **g: m.rand([N], **g), (0.0, 1.0), (0.5, 1 / 12)),
    ("randn", lambda m, **g: m.randn([N], **g), None, (0.0, 1.0)),
    ("standard_normal", lambda m, **g: m.standard_normal([N], **g), None,
     (0.0, 1.0)),
    ("gaussian", lambda m, **g: m.gaussian([N], 2.0, 0.5, **g), None,
     (2.0, 0.25)),
    ("normal", lambda m, **g: m.normal(1.0, 2.0, [N], **g), None,
     (1.0, 4.0)),
    ("uniform", lambda m, **g: m.uniform([N], min=-2.0, max=2.0, **g),
     (-2.0, 2.0), (0.0, 16 / 12)),
    ("randint", lambda m, **g: m.randint(0, 10, [N], **g), (0, 9),
     (4.5, 99 / 12)),
    ("randint_like", lambda m, **g: m.randint_like(
        m.zeros([N], "int32"), 0, 10, **g), (0, 9), (4.5, 99 / 12)),
    ("bernoulli", lambda m, **g: m.bernoulli(
        m.full([N], 0.3), **g), (0.0, 1.0), (0.3, 0.21)),
    ("multinomial", lambda m, **g: m.multinomial(
        m.to_tensor(np.array([0.1, 0.2, 0.7], np.float32)), N, True, **g),
     (0, 2), (1.6, 0.44)),
    ("randperm", lambda m, **g: m.randperm(N, **g), (0, N - 1),
     ((N - 1) / 2, (N * N - 1) / 12)),
]
