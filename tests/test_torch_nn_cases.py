"""The nn slice's cases, without JAX: every name of the JAX package's
``nn/functional/{activation,norm,loss,common,pooling,crf}.py``,
``nn/layer_norm_act.py``, ``nn/layer_loss.py``, ``nn/layer_common.py`` and
``nn/layer_rnn.py`` ``__all__`` lists, the pooling layers of
``nn/layer_conv_pool.py`` and ``Conv2D`` (and ``unfold``/``fold`` of
``nn/functional/conv.py``), on seeded numpy inputs.

A :class:`Case` (``tests/test_torch_op_cases.py``) is one call of an
``nn.functional`` function; a :class:`LayerCase` builds ``nn.<op>(*ctor,
**ctor_kw)`` (its numpy arguments made tensors of the package, a
:func:`make` argument built as a layer of the package) in training or eval
mode and calls it. ``tests/test_torch_nn_parity.py`` runs each
through the JAX package and the port on the CPU (values, dtypes, the
gradients of the inputs listed in ``grad`` and of every parameter, the
tensors updated in place); ``chip_smoke.py`` phase 28 runs the port's on
CUDA tensors against the CPU.

Tolerances, f32 absolute and relative: elementwise ops ``ELEM`` (1e-6),
reductions and norms ``RED`` (1e-5), the CTC and the spectral norm's
power iteration ``LINALG`` (1e-4). Gradients at the kinks (``relu6`` at 0
and 6, ``hardswish`` at +-3, ``hardtanh`` at its bounds, ``hardshrink`` /
``softshrink`` at +-threshold, ``thresholded_relu`` at its threshold,
``leaky_relu`` and ``prelu`` at 0) are the JAX package's: one half at a
bound of ``jnp.clip``.

The batch norms' channel counts are multiples of 8, so on the card they
run the kernels (rows 8, 9 and 11), the affine-less ones included (F18).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from test_torch_op_cases import ELEM, LINALG, RED, Case, R, np_of  # noqa: F401

REDUCTIONS = ("none", "mean", "sum")


@dataclass
class LayerCase(Case):
    """``nn.<op>(*ctor, **ctor_kw)`` called on ``args``, in training mode
    unless ``train`` is False."""
    ctor: Sequence[Any] = ()
    ctor_kw: dict = field(default_factory=dict)
    train: bool = True


def _f32(*v):
    return np.array(v, np.float32)


def activation_cases():
    """``nn/functional/activation.py``'s 33 names."""
    X, X4 = R((3, 4), 1), R((2, 3, 4, 4), 2)
    C = []
    for op in ("relu", "sigmoid", "log_sigmoid", "silu", "swish", "mish",
               "softsign", "tanh", "tanhshrink", "gelu", "selu", "elu",
               "celu", "leaky_relu", "softplus", "hardsigmoid", "hardswish",
               "relu6", "hardtanh", "hardshrink", "softshrink",
               "thresholded_relu"):
        C.append(Case(op, [X * 4], grad=[0]))
    C += [
        Case("gelu", [X], {"approximate": True}, grad=[0], id="gelu-tanh"),
        Case("elu", [X], {"alpha": 0.5}, grad=[0], id="elu-alpha"),
        Case("celu", [X], {"alpha": 1.5}, grad=[0], id="celu-alpha"),
        Case("selu", [X], {"scale": 1.2, "alpha": 0.8}, grad=[0],
             id="selu-scale-alpha"),
        Case("leaky_relu", [X], {"negative_slope": 0.2}, grad=[0],
             id="leaky_relu-slope"),
        Case("softplus", [X * 10], grad=[0], id="softplus-past-threshold"),
        Case("softplus", [X * 4], {"beta": 2.0, "threshold": 5.0}, grad=[0],
             id="softplus-beta-threshold"),
        Case("hardsigmoid", [X * 4], {"slope": 0.2, "offset": 0.4},
             grad=[0], id="hardsigmoid-slope-offset"),
        Case("hardtanh", [X * 4], {"min": -2.0, "max": 3.0}, grad=[0],
             id="hardtanh-bounds"),
        Case("hardshrink", [X], {"threshold": 1.0}, grad=[0],
             id="hardshrink-threshold"),
        Case("softshrink", [X], {"threshold": 1.0}, grad=[0],
             id="softshrink-threshold"),
        Case("thresholded_relu", [X * 2], {"threshold": 0.5, "value": -1.0},
             grad=[0], id="thresholded_relu-value"),
        # the kinks: values at the bounds and thresholds exactly
        Case("relu6", [_f32(0, 6, -1, 3, 7, 0.5)], grad=[0],
             id="relu6-kinks"),
        Case("relu", [_f32(0, -1, 1)], grad=[0], id="relu-kink"),
        Case("leaky_relu", [_f32(0, -1, 1)], {"negative_slope": 0.2},
             grad=[0], id="leaky_relu-kink"),
        Case("hardswish", [_f32(-3, 3, 0, 1, -4, 4)], grad=[0],
             id="hardswish-kinks"),
        Case("hardtanh", [_f32(-1, 1, 0.5, 2, -2)], grad=[0],
             id="hardtanh-kinks"),
        Case("hardtanh", [_f32(-2, 3, 0.5, 4, -3)],
             {"min": -2.0, "max": 3.0}, grad=[0], id="hardtanh-kinks-bounds"),
        Case("hardshrink", [_f32(-0.5, 0.5, 0.2, 1, -1)], grad=[0],
             id="hardshrink-kinks"),
        Case("softshrink", [_f32(-0.5, 0.5, 0.2, 1, -1)], grad=[0],
             id="softshrink-kinks"),
        Case("thresholded_relu", [_f32(1, 2, 0, 0.5)], grad=[0],
             id="thresholded_relu-kink"),
        Case("hardsigmoid", [_f32(-3.0000002, 3.0000002, 0, -4, 4)],
             grad=[0], id="hardsigmoid-bounds"),
        Case("elu", [_f32(0, -1, 1)], grad=[0], id="elu-kink"),
        Case("selu", [_f32(0, -1, 1)], grad=[0], id="selu-kink"),
        Case("prelu", [X4, _f32(0.25)], grad=[0, 1], id="prelu-one-slope"),
        Case("prelu", [X4, _f32(0.1, 0.2, 0.3)], grad=[0, 1],
             id="prelu-per-channel"),
        Case("prelu", [R((2, 4, 4, 3), 3), _f32(0.1, 0.2, 0.3)],
             {"data_format": "NHWC"}, grad=[0, 1], id="prelu-nhwc"),
        Case("prelu", [_f32(0, -1, 2), _f32(0.3)], grad=[0, 1],
             id="prelu-kink"),
        Case("rrelu", [X], {"training": False}, grad=[0], id="rrelu-eval"),
        Case("rrelu", [X], {"lower": 0.2, "upper": 0.4, "training": False},
             grad=[0], id="rrelu-eval-bounds"),
        Case("maxout", [R((2, 4, 3, 3), 4), 2], grad=[0]),
        Case("maxout", [R((2, 3, 6), 5), 3, -1], grad=[0], id="maxout-last"),
        Case("maxout", [_f32(1, 1, 2, 3).reshape(1, 4, 1), 2], grad=[0],
             id="maxout-tie"),
        Case("glu", [R((3, 8), 6)], grad=[0]),
        Case("glu", [R((4, 3), 7), 0], grad=[0], id="glu-axis0"),
        Case("softmax", [X], grad=[0]),
        Case("softmax", [X, 0], grad=[0], id="softmax-axis0"),
        Case("log_softmax", [X], grad=[0], tol=RED),
        Case("relu_", [X], after=[0]),
        Case("elu_", [X], {"alpha": 0.5}, after=[0]),
        Case("tanh_", [X], after=[0]),
        Case("softmax_", [X], after=[0]),
    ]
    return C


def norm_cases():
    """``nn/functional/norm.py``'s names (``collect_stat_updates`` is a
    context manager of the compiled trainers; ``test_torch_conv.py``
    holds it)."""
    X3 = R((2, 3, 4), 10)
    X8 = R((2, 8, 3, 3), 11) * 2 + 0.5          # C % 8 == 0: the kernels
    W8, B8 = R((8,), 12, "p"), R((8,), 13)
    M8, V8 = R((8,), 14) * 0.1, R((8,), 15, "p")
    W4, B4 = R((4,), 16, "p"), R((4,), 17)
    X4 = R((2, 6, 3, 3), 18)
    W6, B6 = R((6,), 19, "p"), R((6,), 20)
    C = [
        Case("layer_norm", [X3, 4, W4, B4], grad=[0, 2, 3], tol=RED),
        Case("layer_norm", [X3, [4]], grad=[0], tol=RED,
             id="layer_norm-affine-less"),
        Case("layer_norm", [X3, [3, 4]], {"epsilon": 1e-3}, grad=[0],
             tol=RED, id="layer_norm-two-axes"),
    ]
    for training in (True, False):
        tag = "train" if training else "eval"
        C += [
            Case("batch_norm", [X8, M8, V8, W8, B8], {"training": training},
                 grad=[0, 3, 4], tol=RED, after=[1, 2], id=f"batch_norm-{tag}"),
            Case("batch_norm", [X8, M8, V8], {"training": training},
                 grad=[0], tol=RED, after=[1, 2],
                 id=f"batch_norm-{tag}-affine-less"),
            Case("batch_norm", [X8.transpose(0, 2, 3, 1).copy(), M8, V8, W8,
                                B8],
                 {"training": training, "data_format": "NHWC"},
                 grad=[0, 3, 4], tol=RED, after=[1, 2],
                 id=f"batch_norm-{tag}-nhwc"),
            Case("fused_batch_norm_act", [X8, M8, V8, W8, B8, training,
                                          0.9, 1e-5, "NCHW", "relu",
                                          R((2, 8, 3, 3), 21)],
                 grad=[0, 3, 4, 10], tol=RED, after=[1, 2],
                 id=f"fused_batch_norm_act-{tag}"),
        ]
    C += [
        Case("batch_norm", [R((6, 8), 22), M8, V8, W8, B8],
             {"training": True, "momentum": 0.5}, grad=[0, 3, 4], tol=RED,
             after=[1, 2], id="batch_norm-2d"),
        Case("batch_norm", [X8, M8, V8, W8, B8],
             {"training": True, "use_global_stats": True}, grad=[0, 3, 4],
             tol=RED, after=[1, 2], id="batch_norm-global-stats"),
        Case("instance_norm", [X4], grad=[0], tol=RED),
        Case("instance_norm", [X4, None, None, W6, B6], grad=[0, 3, 4],
             tol=RED, id="instance_norm-affine"),
        Case("instance_norm", [R((2, 3, 5), 23)], {"epsilon": 1e-3},
             grad=[0], tol=RED, id="instance_norm-1d"),
        Case("group_norm", [X4, 3], grad=[0], tol=RED),
        Case("group_norm", [X4, 2, 1e-5, W6, B6], grad=[0, 3, 4], tol=RED,
             id="group_norm-affine"),
        Case("group_norm", [X4.transpose(0, 2, 3, 1).copy(), 3, 1e-5, W6,
                            B6], {"data_format": "NHWC"}, grad=[0, 3, 4],
             tol=RED, id="group_norm-nhwc"),
        Case("local_response_norm", [R((2, 7, 3, 3), 24), 3], grad=[0],
             tol=RED),
        Case("local_response_norm", [R((2, 7, 3, 3), 25), 4],
             {"alpha": 1e-2, "beta": 0.5, "k": 2.0}, grad=[0], tol=RED,
             id="local_response_norm-even-size"),
        Case("local_response_norm", [R((2, 3, 3, 5), 26), 3],
             {"data_format": "NHWC"}, grad=[0], tol=RED,
             id="local_response_norm-nhwc"),
        Case("normalize", [R((3, 4), 27)], grad=[0], tol=RED),
        Case("normalize", [R((3, 4), 28)], {"p": 1, "axis": 0}, grad=[0],
             tol=RED, id="normalize-p1"),
        Case("normalize", [R((3, 4), 29)], {"p": 3, "axis": -1}, grad=[0],
             tol=RED, id="normalize-p3"),
    ]
    return C


def _pm1(shape, seed):
    return np.where(R(shape, seed) > 0, 1.0, -1.0).astype(np.float32)


def _binary(shape, seed):
    return (R(shape, seed) > 0).astype(np.float32)


def _log_softmax(x, axis=-1):
    z = x - x.max(axis=axis, keepdims=True)
    return (z - np.log(np.exp(z).sum(axis=axis, keepdims=True))).astype(
        np.float32)


# a custom hsigmoid tree: each row a path of node ids (negative: padding)
# and its branch bits
PATH_TABLE = np.array([[0, 1, -1], [0, 2, 3], [1, -1, -1], [3, 2, 0]],
                      np.int32)
PATH_CODE = np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0], [0, 0, 1]], np.int32)


def loss_cases():
    """``nn/functional/loss.py``'s 22 names, each reduction."""
    X, Y = R((4, 5), 30), R((4, 5), 31)
    U, U2 = R((4, 5), 32, "u"), R((4, 5), 33, "u")
    LOGP = _log_softmax(R((4, 5), 34))
    LAB = R((4,), 35, "k")                     # in [0, 5)
    CW = R((5,), 36, "p")
    IGN = np.array([1, 4, 1, 0], np.int32)     # two labels at ignore_index 1
    C = []
    for red in REDUCTIONS:
        C += [
            Case("binary_cross_entropy", [U, U2], {"reduction": red},
                 grad=[0], tol=RED),
            Case("binary_cross_entropy_with_logits", [X, U2],
                 {"reduction": red}, grad=[0], tol=RED),
            Case("nll_loss", [LOGP, LAB], {"reduction": red}, grad=[0],
                 tol=RED),
            Case("nll_loss", [LOGP, IGN], {"reduction": red,
                                           "ignore_index": 1},
                 grad=[0], tol=RED, id=f"nll_loss-ignore-{red}"),
            Case("nll_loss", [LOGP, IGN, CW], {"reduction": red,
                                               "ignore_index": 1},
                 grad=[0], tol=RED, id=f"nll_loss-weight-ignore-{red}"),
            Case("cross_entropy", [X, LAB], {"reduction": red}, grad=[0],
                 tol=RED),
            Case("cross_entropy", [X, IGN], {"reduction": red,
                                             "ignore_index": 1},
                 grad=[0], tol=RED, id=f"cross_entropy-ignore-{red}"),
            Case("cross_entropy", [X, IGN, CW], {"reduction": red,
                                                 "ignore_index": 1},
                 grad=[0], tol=RED, id=f"cross_entropy-weight-ignore-{red}"),
            Case("l1_loss", [X, Y], {"reduction": red}, grad=[0, 1],
                 tol=RED),
            Case("mse_loss", [X, Y], {"reduction": red}, grad=[0, 1],
                 tol=RED),
            Case("smooth_l1_loss", [X, Y], {"reduction": red, "delta": 0.5},
                 grad=[0, 1], tol=RED),
            Case("kl_div", [LOGP, U], {"reduction": red}, grad=[0, 1],
                 tol=RED),
            Case("margin_ranking_loss", [R((6,), 37), R((6,), 38),
                                         _pm1((6,), 39)],
                 {"reduction": red, "margin": 0.1}, grad=[0, 1], tol=RED),
            Case("hinge_embedding_loss", [X, _pm1((4, 5), 40)],
                 {"reduction": red, "margin": 0.5}, grad=[0], tol=RED),
            Case("cosine_embedding_loss", [X, Y, _pm1((4,), 41)],
                 {"reduction": red, "margin": 0.2}, grad=[0, 1], tol=RED),
            Case("soft_margin_loss", [X, _pm1((4, 5), 42)],
                 {"reduction": red}, grad=[0], tol=RED),
            Case("multi_label_soft_margin_loss", [X, _binary((4, 5), 43)],
                 {"reduction": red}, grad=[0], tol=RED),
            Case("triplet_margin_loss", [X, Y, R((4, 5), 44)],
                 {"reduction": red}, grad=[0, 1, 2], tol=RED),
            Case("sigmoid_focal_loss", [X, _binary((4, 5), 45)],
                 {"reduction": red}, grad=[0], tol=RED),
            Case("ctc_loss", [R((6, 2, 4), 46), np.array(
                [[1, 2, 3], [3, 1, 0]], np.int32), np.array([6, 5], np.int32),
                np.array([3, 2], np.int32)], {"reduction": red}, grad=[0],
                tol=LINALG),
        ]
    C += [
        Case("binary_cross_entropy", [U, U2, R((4, 5), 47, "p")], grad=[0],
             tol=RED, id="binary_cross_entropy-weight"),
        Case("binary_cross_entropy_with_logits", [X, U2, R((4, 5), 48, "p"),
                                                  "mean", R((5,), 49, "p")],
             grad=[0], tol=RED,
             id="binary_cross_entropy_with_logits-weights"),
        Case("nll_loss", [_log_softmax(R((2, 3, 5), 50)), R((2, 3), 51, "k")],
             grad=[0], tol=RED, id="nll_loss-3d"),
        Case("cross_entropy", [X, LAB, CW], grad=[0], tol=RED,
             id="cross_entropy-weight"),
        Case("cross_entropy", [X, U / U.sum(-1, keepdims=True)],
             {"soft_label": True}, grad=[0], tol=RED,
             id="cross_entropy-soft"),
        Case("softmax_with_cross_entropy", [X, LAB[:, None]], grad=[0],
             tol=RED),
        Case("square_error_cost", [X, Y], grad=[0, 1], tol=RED),
        Case("kl_div", [LOGP, U], {"reduction": "batchmean"}, grad=[0, 1],
             tol=RED, id="kl_div-batchmean"),
        Case("log_loss", [R((4, 1), 52, "u"), _binary((4, 1), 53)],
             grad=[0], tol=RED),
        Case("multi_label_soft_margin_loss", [X, _binary((4, 5), 54),
                                              R((4,), 55, "p")],
             grad=[0], tol=RED, id="multi_label_soft_margin_loss-weight"),
        Case("triplet_margin_loss", [X, Y, R((4, 5), 56)],
             {"p": 1.0, "swap": True, "margin": 2.0}, grad=[0, 1, 2],
             tol=RED, id="triplet_margin_loss-p1-swap"),
        Case("sigmoid_focal_loss", [X, _binary((4, 5), 57), _f32(3.0)],
             {"alpha": 0.5, "gamma": 1.5}, grad=[0], tol=RED,
             id="sigmoid_focal_loss-normalizer"),
        Case("npair_loss", [X, Y, np.array([0, 1, 0, 2], np.int32)],
             grad=[0, 1], tol=RED),
        Case("dice_loss", [np.exp(_log_softmax(R((2, 3, 4), 58))),
                           R((2, 3, 1), 59, "k") % 4], grad=[0], tol=RED),
        Case("ctc_loss", [R((2, 6, 4), 60), np.array(
            [[1, 2, 2], [3, 1, 0]], np.int32), np.array([6, 4], np.int32),
            np.array([3, 2], np.int32)], {"blank": 0}, grad=[0], tol=LINALG,
            id="ctc_loss-batch-first"),
        Case("hsigmoid_loss", [X, np.array([0, 5, 2, 3], np.int32), 6,
                               R((5, 5), 61), R((5,), 62)],
             grad=[0, 3, 4], tol=RED),
        Case("hsigmoid_loss", [X, np.array([0, 5, 2, 3], np.int32), 7,
                               R((6, 5), 63)],
             grad=[0, 3], tol=RED, id="hsigmoid_loss-no-bias"),
        Case("hsigmoid_loss", [X, np.array([0, 1, 2, 3], np.int32), 4,
                               R((4, 5), 64), R((4,), 65), PATH_TABLE,
                               PATH_CODE],
             grad=[0, 3, 4], tol=RED, id="hsigmoid_loss-custom-tree"),
    ]
    return C


def layer_cases():
    """``nn/layer_norm_act.py``'s layers (not its containers) and
    ``nn/layer_loss.py``'s, each called once (norms in training and eval
    mode); default parameters, or the JAX package's random ones carried
    across by the parity test."""
    X, X4 = R((3, 4), 70), R((2, 3, 4, 4), 71)
    X8 = R((2, 8, 3, 3), 72) * 2 + 0.5
    L = []
    for op, ctor in (("ReLU", ()), ("ReLU6", ()), ("Sigmoid", ()),
                     ("LogSigmoid", ()), ("Tanh", ()), ("Tanhshrink", ()),
                     ("Softsign", ()), ("Silu", ()), ("Swish", ()),
                     ("Mish", ()), ("ELU", (0.5,)), ("CELU", (1.5,)),
                     ("SELU", ()), ("GELU", (True,)), ("LeakyReLU", (0.2,)),
                     ("Hardshrink", (1.0,)), ("Hardsigmoid", ()),
                     ("Hardswish", ()), ("Hardtanh", (-2.0, 3.0)),
                     ("Softshrink", (1.0,)), ("Softplus", (2.0, 5.0)),
                     ("ThresholdedReLU", (0.5,)), ("Softmax", (0,)),
                     ("LogSoftmax", ()), ("GLU", ())):
        L.append(LayerCase(op, [X * 4], grad=[0], ctor=ctor, tol=RED))
    L += [
        LayerCase("Maxout", [X4.reshape(2, 4, 3, 4)], grad=[0], ctor=(2,)),
        LayerCase("PReLU", [X4], grad=[0]),
        LayerCase("PReLU", [X4], grad=[0], ctor=(3, 0.1),
                  id="PReLU-per-channel"),
        LayerCase("RReLU", [X], grad=[0], train=False),
    ]
    for train in (True, False):
        tag = "train" if train else "eval"
        L += [
            LayerCase("BatchNorm", [X8], grad=[0], ctor=(8,), train=train,
                      tol=RED, id=f"BatchNorm-{tag}"),
            LayerCase("BatchNorm1D", [R((6, 8), 73)], grad=[0], ctor=(8,),
                      train=train, tol=RED, id=f"BatchNorm1D-{tag}"),
            LayerCase("BatchNorm1D", [R((2, 8, 5), 74)], grad=[0],
                      ctor=(8,), train=train, tol=RED,
                      id=f"BatchNorm1D-ncl-{tag}"),
            LayerCase("BatchNorm2D", [X8], grad=[0], ctor=(8,), train=train,
                      tol=RED, id=f"BatchNorm2D-{tag}"),
            LayerCase("BatchNorm2D", [X8], grad=[0], ctor=(8,),
                      ctor_kw={"weight_attr": False, "bias_attr": False},
                      train=train, tol=RED,
                      id=f"BatchNorm2D-affine-less-{tag}"),
            LayerCase("BatchNorm3D", [R((2, 8, 2, 3, 3), 75)], grad=[0],
                      ctor=(8,), train=train, tol=RED,
                      id=f"BatchNorm3D-{tag}"),
            LayerCase("SyncBatchNorm", [X8], grad=[0], ctor=(8,),
                      train=train, tol=RED, id=f"SyncBatchNorm-{tag}"),
        ]
    L += [
        LayerCase("LayerNorm", [R((2, 3, 4), 76)], grad=[0], ctor=(4,),
                  tol=RED),
        LayerCase("RMSNorm", [R((2, 3, 4), 77)], grad=[0], ctor=(4,),
                  tol=RED),
        LayerCase("GroupNorm", [R((2, 6, 3, 3), 78)], grad=[0], ctor=(3, 6),
                  tol=RED),
        LayerCase("GroupNorm", [R((2, 6, 3, 3), 79)], grad=[0], ctor=(2, 6),
                  ctor_kw={"weight_attr": False, "bias_attr": False},
                  tol=RED, id="GroupNorm-affine-less"),
        LayerCase("InstanceNorm1D", [R((2, 3, 5), 80)], grad=[0], ctor=(3,),
                  tol=RED),
        LayerCase("InstanceNorm2D", [X4], grad=[0], ctor=(3,), tol=RED),
        LayerCase("InstanceNorm3D", [R((2, 3, 2, 3, 3), 81)], grad=[0],
                  ctor=(3,), tol=RED),
        LayerCase("InstanceNorm2D", [X4], grad=[0], ctor=(3,),
                  ctor_kw={"weight_attr": False}, tol=RED,
                  id="InstanceNorm2D-affine-less"),
        LayerCase("LocalResponseNorm", [R((2, 7, 3, 3), 82)], grad=[0],
                  ctor=(3,), tol=RED),
        LayerCase("SpectralNorm", [R((4, 3, 2), 83)], grad=[0],
                  ctor=((4, 3, 2),), ctor_kw={"power_iters": 3},
                  tol=LINALG),
        LayerCase("SpectralNorm", [R((4, 3, 2), 84)], grad=[0],
                  ctor=((4, 3, 2), 1), tol=LINALG, id="SpectralNorm-dim1"),
    ]
    XL, YL = R((4, 5), 85), R((4, 5), 86)
    LAB = R((4,), 87, "k")
    IGN = np.array([1, 4, 1, 0], np.int32)
    U, U2 = R((4, 5), 88, "u"), R((4, 5), 89, "u")
    L += [
        LayerCase("CrossEntropyLoss", [XL, LAB], grad=[0], tol=RED),
        LayerCase("CrossEntropyLoss", [XL, IGN], grad=[0], tol=RED,
                  ctor=(R((5,), 90, "p"), 1),
                  id="CrossEntropyLoss-weight-ignore"),
        LayerCase("CrossEntropyLoss", [XL, IGN], grad=[0], tol=RED,
                  ctor_kw={"ignore_index": 1, "reduction": "sum",
                           "label_smoothing": 0.1},
                  id="CrossEntropyLoss-ignore-smoothing"),
        LayerCase("NLLLoss", [_log_softmax(XL), IGN], grad=[0], tol=RED,
                  ctor=(R((5,), 91, "p"), 1), id="NLLLoss-weight-ignore"),
        LayerCase("NLLLoss", [_log_softmax(XL), LAB], grad=[0], tol=RED),
        LayerCase("BCELoss", [U, U2], grad=[0], tol=RED),
        LayerCase("BCEWithLogitsLoss", [XL, U2], grad=[0], tol=RED,
                  ctor_kw={"pos_weight": R((5,), 92, "p")}),
        LayerCase("L1Loss", [XL, YL], grad=[0, 1], tol=RED),
        LayerCase("MSELoss", [XL, YL], grad=[0, 1], tol=RED,
                  ctor=("sum",)),
        LayerCase("SmoothL1Loss", [XL, YL], grad=[0, 1], tol=RED,
                  ctor=("mean", 0.5)),
        LayerCase("KLDivLoss", [_log_softmax(XL), U], grad=[0, 1],
                  tol=RED, ctor=("batchmean",)),
        LayerCase("MarginRankingLoss", [R((6,), 93), R((6,), 94),
                                        _pm1((6,), 95)],
                  grad=[0, 1], tol=RED, ctor=(0.1,)),
        LayerCase("HingeEmbeddingLoss", [XL, _pm1((4, 5), 96)], grad=[0],
                  tol=RED),
        LayerCase("CosineEmbeddingLoss", [XL, YL, _pm1((4,), 97)],
                  grad=[0, 1], tol=RED, ctor=(0.2,)),
        LayerCase("TripletMarginLoss", [XL, YL, R((4, 5), 98)],
                  grad=[0, 1, 2], tol=RED, ctor=(1.0, 2.0, 1e-6, True)),
        LayerCase("SoftMarginLoss", [XL, _pm1((4, 5), 99)], grad=[0],
                  tol=RED),
        LayerCase("MultiLabelSoftMarginLoss", [XL, _binary((4, 5), 100)],
                  grad=[0], tol=RED, ctor=(R((4,), 101, "p"),)),
        LayerCase("CTCLoss", [R((6, 2, 4), 102), np.array(
            [[1, 2, 3], [3, 1, 0]], np.int32), np.array([6, 5], np.int32),
            np.array([3, 2], np.int32)], grad=[0], tol=LINALG),
        LayerCase("HSigmoidLoss", [XL, np.array([0, 5, 2, 3], np.int32)],
                  grad=[0], tol=RED, ctor=(5, 6)),
        LayerCase("HSigmoidLoss", [XL, np.array([0, 1, 2, 3], np.int32),
                                   PATH_TABLE, PATH_CODE],
                  grad=[0], tol=RED, ctor=(5, 4),
                  ctor_kw={"is_custom": True}, id="HSigmoidLoss-custom"),
    ]
    return L


def _one_hot(ids, n):
    return np.eye(n, dtype=np.float32)[ids]


def common_cases():
    """``nn/functional/common.py``'s names, and ``unfold``/``fold`` of
    ``conv.py``. The random ones run here at ``training=False`` or ``p =
    0``; their draws are checked by distribution (``RANDOM``)."""
    X4 = R((2, 3, 4, 5), 140)
    X3 = R((2, 3, 6), 141)
    IDS = R((3, 4), 142, "k")
    W = R((5, 4), 143)
    C = [
        Case("linear", [R((3, 4), 144), W.T.copy(), R((5,), 145)],
             grad=[0, 1, 2], tol=RED),
        Case("dropout", [X4], {"p": 0.0}, grad=[0], id="dropout-p0"),
        Case("dropout2d", [X4], {"training": False}, grad=[0]),
        Case("dropout2d", [X4], {"p": 0.0}, grad=[0], id="dropout2d-p0"),
        Case("dropout3d", [R((2, 3, 2, 2, 2), 146)], {"training": False},
             grad=[0]),
        Case("alpha_dropout", [X4], {"training": False}, grad=[0]),
        Case("alpha_dropout", [X4], {"p": 0.0}, grad=[0],
             id="alpha_dropout-p0"),
        Case("embedding", [IDS, W], grad=[1]),
        Case("embedding", [IDS, W], {"padding_idx": 2}, grad=[1],
             id="embedding-padding"),
        Case("embedding", [IDS, W], {"padding_idx": -1}, grad=[1],
             id="embedding-negative-padding"),
        Case("one_hot", [IDS, 5]),
        Case("one_hot", [np.array([0, 4, 5, -1], np.int32), 5],
             id="one_hot-out-of-range"),
        Case("pad", [X4, [1, 2, 0, 1]], {"value": 0.5}, grad=[0]),
        Case("pad", [X4, [0, 0, 1, 0, 1, 1, 2, 0]], grad=[0],
             id="pad-every-axis"),
        Case("pad", [X4, [1, 2, 2, 1]], {"mode": "reflect"}, grad=[0],
             id="pad-reflect"),
        Case("pad", [X4, [3, 1, 0, 2]], {"mode": "replicate"}, grad=[0],
             id="pad-replicate"),
        Case("pad", [X4, [2, 1, 1, 3]], {"mode": "circular"}, grad=[0],
             id="pad-circular"),
        Case("pad", [R((2, 4, 5, 3), 147), [1, 0, 2, 1]],
             {"data_format": "NHWC", "mode": "reflect"}, grad=[0],
             id="pad-nhwc"),
        Case("pad", [X3, [2, 1]], {"data_format": "NCL",
                                   "mode": "replicate"}, grad=[0],
             id="pad-ncl"),
        Case("pad", [R((1, 2, 3, 3, 4), 148), [1, 1, 0, 1, 1, 0]],
             {"data_format": "NCDHW", "mode": "reflect"}, grad=[0],
             id="pad-ncdhw"),
        Case("zeropad2d", [X4, [1, 0, 2, 1]], grad=[0]),
        Case("cosine_similarity", [R((3, 4), 149), R((3, 4), 150)],
             grad=[0, 1], tol=RED),
        Case("cosine_similarity", [R((3, 4), 151), R((3, 4), 152)],
             {"axis": 0}, grad=[0, 1], tol=RED, id="cosine_similarity-axis0"),
        Case("label_smooth", [_one_hot(IDS, 5)], grad=[0]),
        Case("label_smooth", [_one_hot(IDS, 5),
                              R((1, 5), 153, "u")], {"epsilon": 0.2},
             grad=[0, 1], id="label_smooth-prior"),
        Case("pixel_shuffle", [R((2, 8, 3, 3), 154), 2], grad=[0]),
        Case("pixel_shuffle", [R((2, 3, 3, 8), 155), 2],
             {"data_format": "NHWC"}, grad=[0], id="pixel_shuffle-nhwc"),
        Case("pixel_unshuffle", [R((2, 2, 4, 6), 156), 2], grad=[0]),
        Case("channel_shuffle", [R((2, 6, 2, 2), 157), 3], grad=[0]),
        Case("interpolate", [X4], {"size": [7, 3], "mode": "bilinear",
                                   "align_corners": True}, grad=[0],
             id="interpolate-bilinear-corners"),
        Case("interpolate", [X4], {"scale_factor": 2, "mode": "bilinear",
                                   "align_corners": True}, grad=[0],
             id="interpolate-bilinear-corners-scale"),
        Case("interpolate", [R((2, 4, 5, 3), 158)],
             {"size": [6, 2], "mode": "bilinear", "align_corners": True,
              "data_format": "NHWC"}, grad=[0],
             id="interpolate-bilinear-corners-nhwc"),
        Case("interpolate", [X3], {"size": [9], "mode": "linear",
                                   "align_corners": True,
                                   "data_format": "NCW"}, grad=[0],
             id="interpolate-linear-corners"),
        Case("interpolate", [X4], {"scale_factor": 2}, grad=[0],
             id="interpolate-nearest"),
        # the antialiased jax.image.resize modes, up and down, integer and
        # not (sums of up to a few products: RED)
        Case("interpolate", [X4], {"size": [7, 3], "mode": "bilinear"},
             grad=[0], tol=RED, id="interpolate-bilinear"),
        Case("interpolate", [X4], {"scale_factor": 2, "mode": "bicubic"},
             grad=[0], tol=RED, id="interpolate-bicubic-up"),
        Case("interpolate", [R((2, 3, 9, 11), 159)],
             {"size": [4, 5], "mode": "bicubic"}, grad=[0], tol=RED,
             id="interpolate-bicubic-down"),
        Case("interpolate", [R((2, 3, 9, 11), 160)],
             {"scale_factor": 0.5, "mode": "bilinear"}, grad=[0], tol=RED,
             id="interpolate-bilinear-down"),
        Case("interpolate", [R((2, 3, 9, 11), 161)],
             {"size": [3, 4], "mode": "area"}, grad=[0], tol=RED,
             id="interpolate-area"),
        Case("interpolate", [X3], {"size": [10], "mode": "linear",
                                   "data_format": "NCW"}, grad=[0], tol=RED,
             id="interpolate-linear"),
        Case("interpolate", [R((2, 2, 5, 4, 6), 162)],
             {"size": [3, 7, 4], "mode": "trilinear"}, grad=[0], tol=RED,
             id="interpolate-trilinear"),
        Case("interpolate", [R((2, 5, 4, 3), 163)],
             {"scale_factor": 1.5, "mode": "bicubic",
              "data_format": "NHWC"}, grad=[0], tol=RED,
             id="interpolate-bicubic-nhwc"),
        Case("interpolate", [X4], {"size": [6, 8], "mode": "bicubic",
                                   "align_corners": True}, grad=[0],
             id="interpolate-bicubic-corners"),
        Case("upsample", [X4], {"size": [5, 8], "mode": "bilinear",
                                "align_corners": True}, grad=[0]),
        Case("bilinear", [R((3, 4), 159), R((3, 5), 160), R((2, 4, 5), 161),
                          R((2,), 162)], grad=[0, 1, 2, 3], tol=RED),
        Case("bilinear", [R((3, 4), 163), R((3, 5), 164), R((2, 4, 5), 165)],
             grad=[0, 1, 2], tol=RED, id="bilinear-no-bias"),
        Case("affine_grid", [R((2, 2, 3), 166), [2, 3, 4, 5]], grad=[0],
             tol=RED),
        Case("affine_grid", [R((2, 2, 3), 167), [2, 3, 4, 5]],
             {"align_corners": False}, grad=[0], tol=RED,
             id="affine_grid-centres"),
        Case("grid_sample", [X4, R((2, 3, 2, 2), 168) * 0.7], grad=[0, 1],
             tol=RED),
        Case("grid_sample", [X4, R((2, 3, 2, 2), 169) * 0.7],
             {"align_corners": False, "padding_mode": "border"},
             grad=[0, 1], tol=RED, id="grid_sample-border-centres"),
        Case("grid_sample", [X4, R((2, 3, 2, 2), 170) * 0.7],
             {"mode": "nearest"}, grad=[0], tol=RED,
             id="grid_sample-nearest"),
        Case("fold_", [R((2, 12, 12), 171), [4, 5], 2], grad=[0], tol=RED),
        Case("fold", [R((2, 12, 9), 172), [5, 4], 2, 2, 1], grad=[0],
             tol=RED, id="fold-stride-padding"),
        Case("unfold", [X4, 2], grad=[0]),
        Case("unfold", [X4, [2, 3], 2, [1, 0, 2, 1], 1], grad=[0],
             id="unfold-stride-asymmetric"),
        Case("unfold", [X4, 2, 1, 0, 2], grad=[0], id="unfold-dilation"),
        Case("temporal_shift", [R((4, 8, 2, 2), 173), 2], grad=[0]),
        Case("temporal_shift", [R((6, 6, 2, 2), 174), 3],
             {"shift_ratio": 0.5}, grad=[0], id="temporal_shift-half"),
        Case("diag_embed", [R((2, 3), 175)], grad=[0]),
        Case("diag_embed", [R((2, 3), 176)], {"offset": 1, "dim1": 0,
                                              "dim2": 2},
             grad=[0], id="diag_embed-offset-dims"),
        Case("diag_embed", [R((4,), 177)], {"offset": -2}, grad=[0],
             id="diag_embed-below"),
        Case("gather_tree", [R((4, 2, 3), 178, "k"),
                             np.random.default_rng(179).integers(
                                 0, 3, (4, 2, 3)).astype(np.int32)]),
        Case("sequence_mask", [np.array([2, 0, 4], np.int32)], x64=True),
        Case("sequence_mask", [np.array([2, 0, 4], np.int32)],
             {"maxlen": 6, "dtype": "float32"}, id="sequence_mask-maxlen"),
    ]
    return C


def common_layer_cases():
    """``nn/layer_common.py``'s layers (``Linear`` and ``Embedding`` with
    the JAX package's weights carried across)."""
    X4 = R((2, 3, 4, 5), 180)
    L = [
        LayerCase("Identity", [X4], grad=[0], ctor=(3, "unused")),
        LayerCase("Linear", [R((3, 4), 181)], grad=[0], ctor=(4, 6),
                  tol=RED),
        LayerCase("Embedding", [R((3, 4), 182, "k")], ctor=(5, 6),
                  ctor_kw={"padding_idx": 1}),
        LayerCase("Dropout", [X4], grad=[0], ctor=(0.3,), train=False),
        LayerCase("Dropout2D", [X4], grad=[0], ctor=(0.3,), train=False),
        LayerCase("Dropout3D", [R((2, 3, 2, 2, 2), 183)], grad=[0],
                  ctor=(0.3,), train=False),
        LayerCase("AlphaDropout", [X4], grad=[0], ctor=(0.3,), train=False),
        LayerCase("Flatten", [X4], grad=[0]),
        LayerCase("Flatten", [X4], grad=[0], ctor=(0, 2), id="Flatten-0-2"),
        LayerCase("Unflatten", [R((2, 12, 5), 184)], grad=[0],
                  ctor=(1, [3, 4])),
        LayerCase("Pad1D", [R((2, 3, 6), 185)], grad=[0], ctor=([1, 2],),
                  ctor_kw={"mode": "reflect"}),
        LayerCase("Pad2D", [X4], grad=[0], ctor=([1, 0, 2, 1],),
                  ctor_kw={"value": 1.5}),
        LayerCase("Pad3D", [R((1, 2, 3, 3, 4), 186)], grad=[0],
                  ctor=([1, 1, 0, 1, 1, 0],), ctor_kw={"mode": "replicate"}),
        LayerCase("ZeroPad2D", [X4], grad=[0], ctor=([2, 1, 0, 1],)),
        LayerCase("Upsample", [X4], grad=[0], ctor=(None, 2)),
        LayerCase("Upsample", [X4], grad=[0], ctor=([6, 7], None, "bilinear",
                                                  True),
                  id="Upsample-bilinear-corners"),
        LayerCase("UpsamplingNearest2D", [X4], grad=[0], ctor=([8, 10],)),
        LayerCase("UpsamplingBilinear2D", [X4], grad=[0], ctor=(None, 2)),
        LayerCase("Bilinear", [R((3, 4), 187), R((3, 5), 188)],
                  grad=[0, 1], ctor=(4, 5, 2), tol=RED),
        LayerCase("CosineSimilarity", [R((3, 4), 189), R((3, 4), 190)],
                  grad=[0, 1], tol=RED),
        LayerCase("PairwiseDistance", [R((3, 4), 191), R((3, 4), 192)],
                  grad=[0, 1], tol=RED),
        LayerCase("PairwiseDistance", [R((3, 4), 193), R((3, 4), 194)],
                  grad=[0, 1], ctor=(1.0, 1e-6, True), tol=RED,
                  id="PairwiseDistance-p1-keepdim"),
        LayerCase("PixelShuffle", [R((2, 8, 3, 3), 195)], grad=[0],
                  ctor=(2,)),
        LayerCase("PixelUnshuffle", [R((2, 2, 4, 6), 196)], grad=[0],
                  ctor=(2,)),
        LayerCase("ChannelShuffle", [R((2, 6, 2, 2), 197)], grad=[0],
                  ctor=(2,)),
        LayerCase("Fold", [R((2, 12, 12), 198)], grad=[0],
                  ctor=([4, 5], 2), tol=RED),
        LayerCase("Unfold", [X4], grad=[0], ctor=(2, 1, 1)),
    ]
    return L


def _ties(shape, seed):
    """f32 values from {0, ..., 4}: every pooling window holds ties."""
    return R(shape, seed, "k").astype(np.float32)


def _unpool_indices(n, c, h, w, k, seed):
    """A max pool's flat indices over ``[h, w]`` for ``k x k`` windows at
    stride ``k`` (one position drawn in each window)."""
    rng = np.random.default_rng(seed)
    oh, ow = h // k, w // k
    di, dj = (rng.integers(0, k, (n, c, oh, ow)) for _ in range(2))
    rows = np.arange(oh)[:, None] * k + di
    cols = np.arange(ow)[None, :] * k + dj
    return (rows * w + cols).astype(np.int32)


def pooling_cases():
    """``nn/functional/pooling.py``'s 14 names: NCL/NLC, NCHW/NHWC and
    NCDHW/NDHWC, ``ceil_mode``, ``exclusive``, string and asymmetric
    paddings, ``return_mask`` on tied windows (no gradient: the JAX
    package's mask cannot be differentiated through), ``max_unpool2d``."""
    X1, X2, X3 = R((2, 3, 9), 200), R((2, 3, 7, 6), 201), \
        R((2, 2, 5, 4, 6), 202)
    X1L, X2L, X3L = (np.ascontiguousarray(np.moveaxis(x, 1, -1))
                     for x in (X1, X2, X3))
    T1, T2, T3 = _ties((2, 3, 8), 203), _ties((2, 3, 6, 4), 204), \
        _ties((1, 2, 4, 4, 4), 205)
    C = [
        Case("avg_pool1d", [X1, 3, 2, 1], grad=[0]),
        Case("avg_pool1d", [X1, 3, 2, 1, False, True], grad=[0],
             id="avg_pool1d-inclusive-ceil"),
        Case("avg_pool1d", [X1L, 4, 2, "SAME"], {"data_format": "NLC"},
             grad=[0], id="avg_pool1d-nlc-same"),
        Case("avg_pool2d", [X2, 3, 2, 1], grad=[0]),
        Case("avg_pool2d", [X2, 3, 2, 1, True], grad=[0],
             id="avg_pool2d-ceil"),
        Case("avg_pool2d", [X2, [3, 2], [2, 1], [1, 0, 0, 1]],
             {"exclusive": False}, grad=[0], id="avg_pool2d-asymmetric"),
        Case("avg_pool2d", [X2L, 2, None, "SAME"], {"data_format": "NHWC"},
             grad=[0], id="avg_pool2d-nhwc-same"),
        Case("avg_pool2d", [X2, 2, 2, "VALID"], {"divisor_override": 3},
             grad=[0], id="avg_pool2d-divisor-override-ignored"),
        Case("avg_pool3d", [X3, 2, 2, 1], grad=[0]),
        Case("avg_pool3d", [X3L, 3, 2, 1, True, False],
             {"data_format": "NDHWC"}, grad=[0],
             id="avg_pool3d-ndhwc-ceil-inclusive"),
        Case("avg_pool3d", [X3, 2], {"divisor_override": 5}, grad=[0],
             id="avg_pool3d-divisor-override-ignored"),
        Case("max_pool1d", [X1, 3, 2, 1], grad=[0]),
        Case("max_pool1d", [X1L, 3, 2, 0, False, True, "NLC"], grad=[0],
             id="max_pool1d-nlc-ceil"),
        Case("max_pool1d", [T1, 2, None, 0, True], x64=True,
             id="max_pool1d-mask-ties"),
        Case("max_pool2d", [X2, 3, 2, [1, 0, 0, 1]], grad=[0],
             id="max_pool2d-asymmetric"),
        Case("max_pool2d", [X2, 3, 2, 0, False, True], grad=[0],
             id="max_pool2d-ceil"),
        Case("max_pool2d", [T2, 2, None, 0, True], x64=True,
             id="max_pool2d-mask-ties"),
        Case("max_pool2d", [np.ascontiguousarray(np.moveaxis(T2, 1, -1)),
                            [2, 2], [2, 1], 0, True], {"data_format": "NHWC"},
             x64=True, id="max_pool2d-mask-nhwc-overlap"),
        Case("max_pool3d", [X3, 2, 2, 1], grad=[0]),
        Case("max_pool3d", [X3L, 3, 2, 0, False, True, "NDHWC"], grad=[0],
             id="max_pool3d-ndhwc-ceil"),
        Case("max_pool3d", [T3, 2, None, 0, True], x64=True,
             id="max_pool3d-mask-ties"),
        Case("adaptive_avg_pool1d", [X1, 4], grad=[0], tol=RED),
        Case("adaptive_avg_pool1d", [X1, 3], grad=[0], tol=RED,
             id="adaptive_avg_pool1d-even"),
        Case("adaptive_avg_pool2d", [X2, [3, 4]], grad=[0], tol=RED),
        Case("adaptive_avg_pool2d", [X2L, 2, "NHWC"], grad=[0], tol=RED,
             id="adaptive_avg_pool2d-nhwc"),
        Case("adaptive_avg_pool3d", [X3, [2, 3, 4]], grad=[0], tol=RED),
        Case("adaptive_avg_pool3d", [X3L, 1, "NDHWC"], grad=[0], tol=RED,
             id="adaptive_avg_pool3d-ndhwc"),
        Case("adaptive_max_pool1d", [X1, 4], grad=[0]),
        Case("adaptive_max_pool1d", [X1, 3, True], grad=[0],
             id="adaptive_max_pool1d-mask-none"),
        Case("adaptive_max_pool2d", [X2, [3, 4]], grad=[0]),
        Case("adaptive_max_pool2d", [X2, 3, True], grad=[0],
             id="adaptive_max_pool2d-mask-none"),
        Case("adaptive_max_pool3d", [X3, [2, 3, 4]], grad=[0]),
        Case("adaptive_max_pool3d", [X3, 2, True], grad=[0],
             id="adaptive_max_pool3d-mask-none"),
        Case("lp_pool2d", [X2, 2, 3, 2, 1], grad=[0], tol=RED),
        Case("lp_pool2d", [X2L, 3.0, 2, None, 0, True, "NHWC"], grad=[0],
             tol=RED, id="lp_pool2d-p3-nhwc-ceil"),
        Case("max_unpool2d", [R((2, 3, 2, 3), 206),
                              _unpool_indices(2, 3, 4, 6, 2, 207), 2],
             grad=[0]),
        Case("max_unpool2d", [R((2, 3, 2, 3), 208),
                              _unpool_indices(2, 3, 4, 6, 2, 209), 2],
             {"output_size": [2, 3, 5, 7]}, grad=[0],
             id="max_unpool2d-output-size"),
    ]
    return C


def pooling_layer_cases():
    """The pooling layers of ``nn/layer_conv_pool.py`` and ``Conv2D``."""
    X1, X2, X3 = R((2, 3, 9), 210), R((2, 3, 7, 6), 211), \
        R((2, 2, 5, 4, 6), 212)
    L = [
        LayerCase("Conv2D", [X2], grad=[0], ctor=(3, 4, 3),
                  ctor_kw={"padding": 1}, tol=RED),
        LayerCase("MaxPool1D", [X1], grad=[0], ctor=(3, 2, 1)),
        LayerCase("MaxPool2D", [X2], grad=[0], ctor=(3, 2, 1),
                  ctor_kw={"ceil_mode": True}),
        LayerCase("MaxPool3D", [X3], grad=[0], ctor=(2,)),
        LayerCase("AvgPool1D", [X1], grad=[0], ctor=(3, 2, 1),
                  ctor_kw={"exclusive": False}),
        LayerCase("AvgPool2D", [X2], grad=[0], ctor=(3, 2, 1)),
        LayerCase("AvgPool3D", [X3], grad=[0], ctor=(2, 2, 1),
                  ctor_kw={"ceil_mode": True}),
        LayerCase("AdaptiveAvgPool1D", [X1], grad=[0], ctor=(4,), tol=RED),
        LayerCase("AdaptiveAvgPool2D", [X2], grad=[0], ctor=([3, 4],),
                  tol=RED),
        LayerCase("AdaptiveAvgPool3D", [X3], grad=[0], ctor=(2,), tol=RED),
        LayerCase("AdaptiveMaxPool1D", [X1], grad=[0], ctor=(4,)),
        LayerCase("AdaptiveMaxPool2D", [X2], grad=[0], ctor=([3, 4],)),
        LayerCase("AdaptiveMaxPool3D", [X3], grad=[0], ctor=([2, 3, 4],)),
        LayerCase("MaxUnPool2D", [R((2, 3, 2, 3), 213),
                                  _unpool_indices(2, 3, 4, 6, 2, 214)],
                  grad=[0], ctor=(2,)),
    ]
    return L


def conv_cases():
    """``nn/functional/conv.py``'s convolutions (``unfold``/``fold`` are
    in :func:`common_cases`): strides, padding specs, dilation, groups,
    ``output_padding`` and both data formats (f32 sums of up to 72
    products: RED)."""
    X1, X2, X3 = R((2, 4, 9), 250), R((2, 4, 7, 6), 251), \
        R((2, 4, 5, 6, 4), 252)
    W1, W2, W3 = R((6, 2, 3), 253), R((6, 2, 3, 3), 254), \
        R((6, 2, 3, 3, 2), 255)
    T1, T2, T3 = R((4, 3, 3), 256), R((4, 3, 3, 3), 257), \
        R((4, 3, 2, 3, 3), 258)
    B = R((6,), 259)
    last = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, -1))  # noqa
    return [
        Case("conv1d", [X1, W1, B], {"stride": 2, "padding": 1,
                                     "groups": 2}, grad=[0, 1, 2], tol=RED),
        Case("conv1d", [last(X1), W1], {"padding": "SAME", "dilation": 2,
                                        "groups": 2, "data_format": "NLC"},
             grad=[0, 1], tol=RED, id="conv1d-nlc-same"),
        Case("conv2d", [X2, W2, B], {"padding": [1, 0, 2, 1], "groups": 2},
             grad=[0, 1, 2], tol=RED, id="conv2d-asymmetric"),
        Case("conv2d", [last(X2), W2, B], {"stride": 2, "padding": "VALID",
                                           "groups": 2,
                                           "data_format": "NHWC"},
             grad=[0, 1, 2], tol=RED, id="conv2d-nhwc-valid"),
        Case("conv3d", [X3, W3, B], {"stride": [1, 2, 1], "padding": 1,
                                     "dilation": [2, 1, 1], "groups": 2},
             grad=[0, 1, 2], tol=RED),
        Case("conv3d", [last(X3), W3], {"padding": "SAME", "groups": 2,
                                        "data_format": "NDHWC"},
             grad=[0, 1], tol=RED, id="conv3d-ndhwc-same"),
        Case("conv1d_transpose", [X1, T1, B], {"stride": 2, "padding": 1,
                                               "output_padding": 1,
                                               "groups": 2},
             grad=[0, 1, 2], tol=RED),
        Case("conv1d_transpose", [last(X1), T1], {
            "stride": 3, "padding": [2, 0], "output_padding": 2,
            "dilation": 2, "groups": 2, "data_format": "NLC"},
             grad=[0, 1], tol=RED, id="conv1d_transpose-nlc-asymmetric"),
        Case("conv2d_transpose", [X2, T2, B], {"stride": 2, "padding": 1,
                                               "output_padding": 1,
                                               "groups": 2},
             grad=[0, 1, 2], tol=RED),
        Case("conv2d_transpose", [X2, T2, B], {"stride": 2,
                                               "padding": "SAME",
                                               "groups": 2},
             grad=[0, 1, 2], tol=RED, id="conv2d_transpose-same"),
        Case("conv2d_transpose", [last(X2), T2], {
            "stride": [2, 1], "padding": "VALID", "dilation": [1, 2],
            "groups": 2, "data_format": "NHWC"}, grad=[0, 1], tol=RED,
             id="conv2d_transpose-nhwc-valid"),
        Case("conv3d_transpose", [X3, T3, B], {"stride": 2, "padding": 1,
                                               "output_padding": 1,
                                               "groups": 2},
             grad=[0, 1, 2], tol=RED),
        Case("conv3d_transpose", [last(X3), T3, B], {
            "stride": [1, 2, 2], "padding": [1, 0, 0], "groups": 2,
            "data_format": "NDHWC"}, grad=[0, 1, 2], tol=RED,
             id="conv3d_transpose-ndhwc"),
    ]


def conv_layer_cases():
    """``nn/layer_conv_pool.py``'s convolution layers (``Conv2D`` is in
    :func:`pooling_layer_cases`); their weights the JAX package's,
    carried across."""
    X1, X2, X3 = R((2, 4, 9), 260), R((2, 4, 7, 6), 261), \
        R((2, 4, 5, 6, 4), 262)
    return [
        LayerCase("Conv1D", [X1], grad=[0], ctor=(4, 6, 3),
                  ctor_kw={"stride": 2, "padding": 1, "groups": 2},
                  tol=RED),
        LayerCase("Conv3D", [X3], grad=[0], ctor=(4, 6, [3, 3, 2]),
                  ctor_kw={"padding": "SAME", "dilation": 2}, tol=RED),
        LayerCase("Conv1DTranspose", [X1], grad=[0], ctor=(4, 6, 3, 2, 1,
                                                            1, 2),
                  tol=RED),
        LayerCase("Conv2DTranspose", [X2], grad=[0], ctor=(4, 6, 3),
                  ctor_kw={"stride": 2, "padding": 1, "output_padding": 1,
                           "groups": 2}, tol=RED),
        LayerCase("Conv2DTranspose", [np.ascontiguousarray(
            np.moveaxis(X2, 1, -1))], grad=[0], ctor=(4, 6, [2, 3]),
                  ctor_kw={"stride": 2, "data_format": "NHWC",
                           "bias_attr": False}, tol=RED,
                  id="Conv2DTranspose-nhwc-no-bias"),
        LayerCase("Conv3DTranspose", [X3], grad=[0], ctor=(4, 6, 2),
                  ctor_kw={"stride": 2, "dilation": [1, 2, 1]}, tol=RED),
    ]


def crf_cases():
    """``nn/functional/crf.py``'s 2 names: ragged lengths, label marks,
    tied scores."""
    rng = np.random.default_rng(220)
    E, W = R((3, 5, 4), 221), R((6, 4), 222)
    Y = rng.integers(0, 4, (3, 5)).astype(np.int64)
    L = np.array([5, 2, 4], np.int64)
    ET, WT = _ties((3, 5, 4), 223), _ties((6, 4), 224)
    return [
        Case("linear_chain_crf", [E, W, Y], grad=[0, 1], tol=RED),
        Case("linear_chain_crf", [E, W, Y, L], grad=[0, 1], tol=RED,
             id="linear_chain_crf-ragged"),
        Case("crf_decoding", [E, W]),
        Case("crf_decoding", [E, W, Y, L], id="crf_decoding-marks-ragged"),
        Case("crf_decoding", [ET, WT, None, L], id="crf_decoding-ties"),
    ]


def make(name, *ctor):
    """A constructor argument that is itself a layer: ``make(nn)`` builds
    ``nn.<name>(*ctor)`` in the package the case runs in."""
    return lambda nn: getattr(nn, name)(*ctor)


def rnn_layer_cases():
    """``nn/layer_rnn.py``'s layers (every name but the abstract
    ``RNNCellBase``, whose ``get_initial_states`` every cell case runs),
    their outputs and final states compared as one structure; the weights
    the JAX package's, carried across."""
    X2, X3 = R((3, 4), 230), R((3, 5, 4), 231)
    H1, H2 = R((3, 6), 232), R((4, 3, 6), 233)
    return [
        LayerCase("SimpleRNNCell", [X2, H1], grad=[0, 1], ctor=(4, 6),
                  tol=RED),
        LayerCase("SimpleRNNCell", [X2], grad=[0], ctor=(4, 6, "relu"),
                  tol=RED, id="SimpleRNNCell-relu"),
        LayerCase("LSTMCell", [X2], grad=[0], ctor=(4, 6), tol=RED),
        LayerCase("GRUCell", [X2, H1], grad=[0, 1], ctor=(4, 6), tol=RED),
        LayerCase("RNN", [X3], grad=[0], ctor=(make("GRUCell", 4, 6),),
                  tol=RED),
        LayerCase("RNN", [X3], grad=[0],
                  ctor=(make("LSTMCell", 4, 6), True, True), tol=RED,
                  id="RNN-reverse-time-major"),
        LayerCase("BiRNN", [X3], grad=[0], ctor=(make("LSTMCell", 4, 6),
                                                 make("LSTMCell", 4, 6)),
                  tol=RED),
        LayerCase("LSTM", [X3], grad=[0], ctor=(4, 6, 2, "bidirect"),
                  tol=RED),
        LayerCase("LSTM", [X3, [H2[:2], H2[2:]]], grad=[0],
                  ctor=(4, 6, 2), tol=RED, id="LSTM-states"),
        LayerCase("GRU", [X3, H2], grad=[0, 1], ctor=(4, 6, 2),
                  tol=RED),
        LayerCase("GRU", [X3], grad=[0], ctor=(4, 6, 2, "forward", True,
                                               0.5), train=False, tol=RED,
                  id="GRU-time-major-dropout-eval"),
        LayerCase("SimpleRNN", [X3], grad=[0],
                  ctor=(4, 6, 2, "bidirectional", False, 0.0, "relu"),
                  tol=RED),
        LayerCase("RNNBase", [X3], grad=[0], ctor=(4, 6), tol=RED),
    ]


def all_cases():
    """``(group, case)`` for every case: ``F`` (``nn.functional``) or
    ``nn`` (a layer)."""
    return ([("F", c) for c in activation_cases() + norm_cases() +
             loss_cases() + common_cases() + pooling_cases() +
             conv_cases() + crf_cases()] +
            [("nn", c) for c in layer_cases() + common_layer_cases() +
             pooling_layer_cases() + conv_layer_cases() +
             rnn_layer_cases()])


# the random activations: ``(name, draw(F, x, **generator), check)``; the
# draws compared by distribution. rrelu's slopes lie in [lower, upper]
# with mean (lower + upper) / 2 on the negative inputs; gumbel_softmax's
# hard samples pick each class as often as softmax(x) says, its soft
# samples sum to 1.
N_DRAWS = 20000
GUMBEL_LOGITS = np.log(np.array([0.1, 0.2, 0.7], np.float32))


def _rrelu(F, to_tensor, **g):
    x = to_tensor(-np.ones(N_DRAWS, np.float32))
    return F.rrelu(x, 0.1, 0.3, training=True, **g)


def _gumbel(F, to_tensor, **g):
    x = to_tensor(np.tile(GUMBEL_LOGITS, (N_DRAWS, 1)))
    return F.gumbel_softmax(x, 0.5, hard=True, **g)


def _dropout2d(F, to_tensor, **g):
    x = to_tensor(np.ones((N_DRAWS // 10, 10, 2, 2), np.float32))
    return F.dropout2d(x, 0.25, **g)


def _alpha_dropout(F, to_tensor, **g):
    x = to_tensor(np.random.default_rng(9).standard_normal(
        N_DRAWS).astype(np.float32))
    return F.alpha_dropout(x, 0.2, **g)


RANDOM = [("rrelu", _rrelu), ("gumbel_softmax", _gumbel),
          ("dropout2d", _dropout2d), ("alpha_dropout", _alpha_dropout)]


def random_check(name, out: np.ndarray):
    """Raise AssertionError unless ``out`` (a draw of RANDOM's ``name``) has
    the distribution the JAX package's draws have."""
    if name == "dropout2d":
        # whole channels kept (scaled by 1 / 0.75) or dropped, a quarter
        # of them dropped
        per_channel = out.reshape(out.shape[0], out.shape[1], -1)
        assert np.all(per_channel.min(-1) == per_channel.max(-1))
        kept = per_channel[..., 0]
        assert set(np.unique(kept).tolist()) <= {0.0, np.float32(1 / 0.75)}
        assert abs((kept == 0).mean() - 0.25) < 0.015, (kept == 0).mean()
        return
    if name == "alpha_dropout":
        # a standard normal input keeps mean 0 and variance 1; the dropped
        # fifth sit at one value
        assert abs(out.mean()) < 0.03 and abs(out.var() - 1) < 0.05, \
            (out.mean(), out.var())
        vals, counts = np.unique(out, return_counts=True)
        assert abs(counts.max() / out.size - 0.2) < 0.015
        return
    if name == "rrelu":
        slope = -out
        assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.3 + 1e-6
        assert abs(slope.mean() - 0.2) < 5e-3, slope.mean()
        assert abs(slope.var() - 0.04 / 12) < 5e-4, slope.var()
    else:
        assert out.shape == (N_DRAWS, 3)
        np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-6)
        # the straight-through sum y_hard + y - y rounds within an ulp of 1
        assert np.all(np.minimum(np.abs(out), np.abs(out - 1)) < 1e-6)
        np.testing.assert_allclose(out.mean(0), [0.1, 0.2, 0.7], atol=0.015)
