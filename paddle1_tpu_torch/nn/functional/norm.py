"""Normalization functionals (port of ``paddle1_tpu/nn/functional/norm.py``,
its whole ``__all__``: ``batch_norm``, ``fused_batch_norm_act``,
``layer_norm``, ``instance_norm``, ``group_norm``, ``local_response_norm``,
``normalize`` and the running-statistics capture; and of ``SyncBatchNorm``'s
cross-replica statistics from ``paddle1_tpu/nn/layer_norm_act.py``).

A batch, instance or group norm takes its affine ``weight`` and ``bias``
both or neither, as the JAX package does; given one alone it raises
(the JAX package raises on a weight alone and drops a bias alone: ROADMAP,
by design).

Under a ``dp`` binding (``distributed.env.spmd_axes(dp=group)``, which
``ParallelEngine`` opens around its forward on a mesh) each rank holds
one shard of a global batch, and a training-mode batch norm normalizes
with the statistics of the WHOLE batch, as the JAX engine's batch norms
do on a batch sharded over its mesh: per-rank f32 sums (the
``local_moments`` kernel), one differentiable SUM all-reduce, then the
given-statistics normalize (``fused_bn_norm``)."""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as tF

from ...amp import cast_point
from ...core.errors import InvalidArgumentError
from ...core.flags import flag_active
from ...distributed.collective import differentiable_all_reduce
from ...distributed.env import current_spmd_axis
from ...ops import fused_bn as fbn
from ...ops import layer_norm as ln
from ._layout import channels_last_region

__all__ = ["batch_norm", "fused_batch_norm_act", "layer_norm",
           "instance_norm", "group_norm", "local_response_norm",
           "normalize", "collect_stat_updates", "fused_bn_active"]


@cast_point("layer_norm")
def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-05, name=None) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` axes, which are
    flattened into one (``weight``/``bias`` likewise; None stands for
    ones / zeros, the affine-less form). Under
    ``fused_layer_norm`` (``auto`` = CUDA tensors) the kernel's wrapper
    runs under an autograd function whose backward is the plain formula,
    and raises on inputs outside the kernel's contract; otherwise the
    plain version runs under PyTorch's autograd."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = tuple(int(s) for s in normalized_shape)
    lead = tuple(x.shape[:x.dim() - len(shape)])
    if not shape or tuple(x.shape[len(lead):]) != shape:
        raise InvalidArgumentError(
            f"layer_norm: normalized_shape {list(shape)} is not the "
            f"trailing shape of x {tuple(x.shape)}")
    fn = ln.layer_norm if flag_active("fused_layer_norm", x.device) \
        else ln.layer_norm_ref
    n = math.prod(shape)
    if weight is None:
        weight = torch.ones(n, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(n, dtype=x.dtype, device=x.device)
    y = fn(torch.reshape(x, (*lead, n)), torch.reshape(weight, (n,)),
           torch.reshape(bias, (n,)), epsilon)
    return torch.reshape(y, x.shape)


# ---------------------------------------------------------------------------
# running statistics
#
# Eager calls blend the batch statistics into the running buffers in
# place. A framework-owned step (distributed.ParallelEngine) opens a
# collector around its forward instead: each batch norm then RECORDS its
# update (the buffer it was handed, the batch statistics, the momentum),
# and the engine blends once per step into its f32 buffers after the
# optimizer update, as the JAX engine folds them into the step's output.

_stat_sink = threading.local()


class StatUpdate:
    """One recorded running-statistics update: the buffers the layer was
    handed (identity keys into the step's leaves), the detached batch
    statistics and the layer's momentum."""

    __slots__ = ("old_mean", "old_var", "mean", "var", "momentum")

    def __init__(self, old_mean, old_var, mean, var, momentum):
        self.old_mean = old_mean
        self.old_var = old_var
        self.mean = mean
        self.var = var
        self.momentum = momentum


@contextlib.contextmanager
def collect_stat_updates():
    """Arm the running-statistics capture for this thread; yields the
    list of :class:`StatUpdate` the step consumes."""
    prev = getattr(_stat_sink, "sink", None)
    sink: list = []
    _stat_sink.sink = sink
    try:
        yield sink
    finally:
        _stat_sink.sink = prev


def _update_running_stats(running_mean, running_var, mean, var, momentum):
    """Paddle's convention: ``new = m * old + (1 - m) * batch`` with the
    biased batch variance (``torch.nn.BatchNorm2d`` inverts the momentum
    and keeps the unbiased variance)."""
    if running_mean is None:
        return
    mean, var = mean.detach(), var.detach()
    sink = getattr(_stat_sink, "sink", None)
    if sink is not None:
        sink.append(StatUpdate(running_mean, running_var, mean, var,
                               float(momentum)))
        return
    with torch.no_grad():
        for buf, stat in ((running_mean, mean), (running_var, var)):
            buf.copy_(momentum * buf + (1 - momentum) * stat)


def fused_bn_active(shape, dtype, device) -> bool:
    """Resolve the ``fused_bn`` flag (``auto``: CUDA tensors) for a
    channels-LAST input. On a CUDA tensor the flag alone decides: the
    wrapper then raises on an input outside the kernel's contract, and
    never hands it to the plain version. On a CPU tensor (``always``: the
    wrapper runs the plain version) the input must also be one the kernel
    takes (``ops.fused_bn.supported``), the JAX package's rule."""
    if not flag_active("fused_bn", device):
        return False
    return device.type != "cpu" or fbn.supported(shape, dtype)


def _apply_act(y, act):
    return torch.relu(y) if act == "relu" else y


def _check_affine(op, weight, bias):
    """``weight`` and ``bias`` come both or neither (module docstring)."""
    if (weight is None) != (bias is None):
        given = "weight" if bias is None else "bias"
        raise InvalidArgumentError(
            f"{op}: the affine weight and bias go together (both or "
            f"neither); got only the {given}")


def _scale_shift(y, weight, bias, bshape):
    """``y * weight + bias``, ``bshape`` broadcasting a ``[C]`` vector
    along the channel axis; ``y`` unchanged without an affine."""
    if weight is None:
        return y
    return y * bshape(weight) + bshape(bias)


def _rows(t, c):
    """``t`` as the kernels' ``[rows, C]``: a free view of channels-last
    memory. On the card a tensor with no such view is handed on as it is,
    and the wrapper's contract check raises: no hidden copy."""
    if t.is_contiguous() or t.device.type == "cpu":
        return torch.reshape(t, (-1, c))
    return t


# f32 holds every integer up to 2**24 exactly: the global row count's
# check is exact below it, within f32 rounding above
_F32_EXACT = float(2 ** 24)


def _check_equal_shards(count, n_local, world):
    """Every rank normalized the same number of rows: ``count`` (the
    all-reduced per-rank counts, f32) is ``world * n_local``. On the CPU a
    typed error; on the card an asynchronous device-side assert (no host
    sync inside the step)."""
    want = float(n_local * world)
    tol = 0.5 if want < _F32_EXACT else want * world * 2.0 ** -24
    msg = (f"cross-rank batch norm: the {world} ranks' shards hold unequal "
           f"row counts (this rank {n_local}); equal shards are required")
    count = count.detach()
    if count.device.type == "cpu":
        if abs(float(count) - want) > tol:
            raise InvalidArgumentError(msg)
    else:
        torch._assert_async((count - want).abs() <= tol, msg)


def _global_moments(xi, x2, ch_axis, group):
    """``(mean, var)``, f32 ``[C]``, of the group's whole batch, each rank
    holding an equal shard ``xi`` (``x2``: its ``[rows, C]`` view for the
    moments kernel, or None for the plain sums). One all-reduce of
    ``[sum, sum_sq, rows]`` each way; the count is the exact host integer
    ``rows * world``, checked against the reduced rows; the one-pass
    ``var = max(E[x^2] - mean^2, 0)`` of ``layer_norm_act.py:141-142``."""
    if x2 is not None:
        s, ss = fbn.local_moments(x2)
        n_local = int(x2.shape[0])
    else:
        axes = tuple(i for i in range(xi.dim()) if i != ch_axis)
        xf = xi.float()
        s, ss = torch.sum(xf, dim=axes), torch.sum(xf * xf, dim=axes)
        n_local = math.prod(int(xi.shape[i]) for i in axes)
    c, world = int(s.shape[0]), group.nranks
    parts = [s, ss]
    if world > 1:
        parts.append(s.new_full((1,), float(n_local)))
    g = differentiable_all_reduce(torch.cat(parts), group)
    if world > 1:
        _check_equal_shards(g[2 * c], n_local, world)
    inv = 1.0 / (n_local * world)
    mean = g[:c] * inv
    var = torch.clamp(g[c:2 * c] * inv - mean * mean, min=0.0)
    return mean, var


def _bn_infer(x, running_mean, running_var, weight, bias, residual, cfg):
    """A batch norm from given statistics; the statistics are inputs."""
    return _batch_norm_body(x, running_mean, running_var, weight, bias,
                            residual, *cfg)


def _bn_train(x, weight, bias, residual, stats, cfg):
    """A training batch norm; the running statistics (``stats``, a pair
    that no cast reaches) are written, not read."""
    return _batch_norm_body(x, stats[0], stats[1], weight, bias, residual,
                            *cfg)


# each mode under the JAX package's op name (``norm.py:259,297``), where
# ``auto_cast`` casts: x, weight, bias and the residual, and the running
# statistics only where they are read
_BN_OPS = {(what, stats): cast_point(f"{what}_{mode}")(fn)
           for what in ("batch_norm", "fused_bn_act")
           for stats, mode, fn in ((True, "infer", _bn_infer),
                                   (False, "train", _bn_train))}


def _batch_norm_impl(x, running_mean, running_var, weight, bias, training,
                     momentum, epsilon, data_format, use_global_stats, act,
                     residual, what):
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    cfg = (training, momentum, epsilon, data_format, use_global_stats, act)
    if use_stats:
        return _BN_OPS[what, True](x, running_mean, running_var, weight,
                                   bias, residual, cfg)
    return _BN_OPS[what, False](x, weight, bias, residual,
                                (running_mean, running_var), cfg)


def _batch_norm_body(x, running_mean, running_var, weight, bias, residual,
                     training, momentum, epsilon, data_format,
                     use_global_stats, act):
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    # an NCHW batch norm computes on channels-last memory inside the
    # region (_layout.py), which is what gives the kernels their
    # [rows, C] view
    nhwc_internal, to_internal, from_internal = channels_last_region(
        x.dim(), channel_last, x.device)
    # a 2-D [N, C] input has its channels last in either format
    eff_last = channel_last or nhwc_internal or x.dim() == 2
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    xi = to_internal(x)
    res = None if residual is None else to_internal(residual)
    nd = xi.dim()
    ch_axis = nd - 1 if eff_last else 1

    def bshape(v):
        shape = [1] * nd
        shape[ch_axis] = -1
        return torch.reshape(v, shape)

    fused = fused_bn_active(xi.shape, xi.dtype, xi.device)
    if fused and not eff_last:
        if xi.device.type == "cpu":
            fused = False
        else:
            raise InvalidArgumentError(
                "batch_norm: the fused_bn kernel needs a channels-last "
                "input (data_format NHWC, or NCHW under conv_nhwc); got x "
                f"{tuple(x.shape)} {data_format} (outside the kernel's "
                "contract; set fused_bn=never for the plain composition)")
    if fused:
        c = int(xi.shape[-1])
        x2 = _rows(xi, c)
        res2 = None if res is None else _rows(res, c)
        if weight is None:
            # the kernels take gamma and beta: an affine-less norm gets
            # ones and zeros, constants whose gradients autograd drops
            weight = torch.ones(c, dtype=torch.float32, device=xi.device)
            bias = torch.zeros(c, dtype=torch.float32, device=xi.device)

    group = None if use_stats else current_spmd_axis("dp")
    if group is not None:
        # the cross-rank arm: the group's statistics, then the
        # given-statistics normalize with the statistics differentiable
        mean, var = _global_moments(xi, x2 if fused else None, ch_axis,
                                    group)
        if fused:
            y2 = fbn.fused_bn_norm(x2, mean, var, weight, bias, epsilon, act,
                                   residual=res2)
            y = from_internal(torch.reshape(y2, xi.shape))
        else:
            y = (xi.float() - bshape(mean)) * torch.rsqrt(bshape(var) +
                                                          epsilon)
            if weight is not None:
                y = y * bshape(weight.float()) + bshape(bias.float())
            if res is not None:
                y = y + res.float()
            y = from_internal(_apply_act(y, act).to(xi.dtype))
        _update_running_stats(running_mean, running_var, mean, var, momentum)
        return y

    if use_stats:
        if fused:
            y2 = fbn.fused_bn_norm(x2, running_mean, running_var, weight,
                                   bias, epsilon, act, residual=res2)
            return from_internal(torch.reshape(y2, xi.shape))
        y = (xi - bshape(running_mean)) * torch.rsqrt(
            bshape(running_var) + epsilon)
        y = _scale_shift(y, weight, bias, bshape)
        if res is not None:
            y = y + res
        return from_internal(_apply_act(y, act))

    if fused:
        y2, mean, var = fbn.fused_bn_train(x2, weight, bias, epsilon, act,
                                           residual=res2)
        y = from_internal(y2.reshape(xi.shape))
    else:
        # the JAX package's own formula for this arm: f32 sums for 16-bit
        # inputs, the two-pass variance, the statistics cast to x.dtype
        reduce_axes = tuple(i for i in range(nd) if i != ch_axis)
        n = math.prod(int(xi.shape[i]) for i in reduce_axes)
        inv = 1.0 / n
        half = xi.element_size() == 2
        xf = xi.float() if half else xi
        mean = (xf.sum(dim=reduce_axes) * inv).to(xi.dtype)
        xc = xi - bshape(mean)
        xcf = xc.float() if half else xc
        var = ((xcf * xcf).sum(dim=reduce_axes) * inv).to(xi.dtype)
        y = xc * torch.rsqrt(bshape(var) + epsilon)
        y = _scale_shift(y, weight, bias, bshape)
        if res is not None:
            y = y + res
        y = from_internal(_apply_act(y, act))
    _update_running_stats(running_mean, running_var, mean, var, momentum)
    return y


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm with the running-statistics update (Paddle's
    ``batch_norm``): training mode normalizes with the batch statistics
    and blends them into ``running_mean``/``running_var``; eval (or
    ``use_global_stats=True``) normalizes with the running statistics.
    Under ``fused_bn`` a channels-last batch norm runs the hand-written
    kernels (``ops/fused_bn.py``), an affine-less one with gamma ones and
    beta zeros."""
    _check_affine("batch_norm", weight, bias)
    return _batch_norm_impl(x, running_mean, running_var, weight, bias,
                            training, momentum, epsilon, data_format,
                            use_global_stats, "identity", None, "batch_norm")


def fused_batch_norm_act(x, running_mean, running_var, weight, bias,
                         training=False, momentum=0.9, epsilon=1e-05,
                         data_format="NCHW", act="relu", residual=None,
                         use_global_stats=None, name=None):
    """``y = act(batch_norm(x) + residual)`` as one op (Paddle's
    ``fused_bn_activation_op`` / ``fused_bn_add_activation_op``); the
    same semantics as :func:`batch_norm` otherwise."""
    if act not in fbn.ACTS:
        raise InvalidArgumentError(
            f"fused_batch_norm_act: act must be one of {fbn.ACTS}, got "
            f"{act!r}")
    if weight is None or bias is None:
        raise InvalidArgumentError(
            "fused_batch_norm_act requires affine weight and bias; use "
            "batch_norm for the affine-less form")
    if residual is not None and tuple(residual.shape) != tuple(x.shape):
        raise InvalidArgumentError(
            f"fused_batch_norm_act: residual shape {list(residual.shape)} "
            f"must match x shape {list(x.shape)}")
    return _batch_norm_impl(x, running_mean, running_var, weight, bias,
                            training, momentum, epsilon, data_format,
                            use_global_stats, act, residual, "fused_bn_act")


def _bcast(v, nd, axis):
    shape = [1] * nd
    shape[axis] = -1
    return torch.reshape(v, shape)


@cast_point("instance_norm")
def instance_norm(x: torch.Tensor, running_mean=None, running_var=None,
                  weight=None, bias=None, use_input_stats: bool = True,
                  momentum: float = 0.9, epsilon: float = 1e-05,
                  data_format: str = "NCHW", name=None) -> torch.Tensor:
    """Per-sample, per-channel normalization over the spatial axes of a
    channels-first ``x`` (axes 2 on), with the biased variance, then the
    affine on axis 1. As in the JAX package the running statistics,
    ``use_input_stats``, ``momentum`` and ``data_format`` are taken and
    not read."""
    _check_affine("instance_norm", weight, bias)
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    return _scale_shift(y, weight, bias,
                        lambda v: _bcast(v, x.dim(), 1))


@cast_point("group_norm")
def group_norm(x: torch.Tensor, num_groups: int, epsilon: float = 1e-05,
               weight=None, bias=None, data_format: str = "NCHW",
               name=None) -> torch.Tensor:
    """Each sample's channels cut into ``num_groups`` groups, each group
    normalized over its channels and spatial axes (biased variance), then
    the per-channel affine; channels on axis 1, or last for ``NHWC``,
    ``NLC`` and ``NDHWC``."""
    _check_affine("group_norm", weight, bias)
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    xm = torch.movedim(x, -1, 1) if channel_last else x
    n, c = int(xm.shape[0]), int(xm.shape[1])
    if c % num_groups:
        raise InvalidArgumentError(
            f"group_norm: {c} channels are not a multiple of num_groups="
            f"{num_groups}")
    grouped = torch.reshape(xm, (n, num_groups, c // num_groups,
                                 *xm.shape[2:]))
    axes = tuple(range(2, grouped.dim()))
    mean = torch.mean(grouped, dim=axes, keepdim=True)
    var = torch.var(grouped, dim=axes, keepdim=True, unbiased=False)
    y = torch.reshape((grouped - mean) * torch.rsqrt(var + epsilon),
                      xm.shape)
    y = _scale_shift(y, weight, bias, lambda v: _bcast(v, xm.dim(), 1))
    return torch.movedim(y, 1, -1) if channel_last else y


@cast_point("local_response_norm")
def local_response_norm(x: torch.Tensor, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW",
                        name=None) -> torch.Tensor:
    """``x / (k + alpha * s) ** beta``, ``s`` the sum of ``x**2`` over a
    window of ``size`` channels around each (``size // 2`` before, the rest
    after, zero past the edges): the JAX package's formula, whose alpha is
    not divided by ``size``."""
    ax = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = torch.movedim(x * x, ax, -1)
    half = size // 2
    padded = tF.pad(sq, (half, size - half - 1))
    c = int(sq.shape[-1])
    s = padded[..., 0:c]
    for i in range(1, size):
        s = s + padded[..., i:i + c]
    return x / (k + alpha * torch.movedim(s, -1, ax)) ** beta


@cast_point("normalize")
def normalize(x: torch.Tensor, p=2, axis: int = 1, epsilon: float = 1e-12,
              name=None) -> torch.Tensor:
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    if p == 2:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** \
            (1.0 / p)
    return x / torch.clamp(n, min=epsilon)
