"""Fused batch norm, backward: the hand-written CUDA kernels and their
plain versions.

Port of ``paddle1_tpu/ops/pallas/fused_bn_bwd.py`` (``_train_bwd_kernel``,
``_norm_bwd_kernel``), in ``ops/cuda/fused_bn_bwd.cu``:

* :func:`train_bwd` — batch statistics: dgamma = sum(dy * xhat),
  dbeta = sum(dy), dx = gamma * rstd * (dy - dbeta/n - xhat * dgamma/n);
* :func:`norm_bwd` — given statistics: the same sums and
  dx = dy * gamma * rstd;

each with the relu mask (dy where the forward output y > 0) and the
residual's gradient (the masked dy) when asked. The ``fused_bn_bwd``
flag picks the kernel (``auto``: CUDA tensors) or the plain version
(:func:`train_bwd_ref`, :func:`norm_bwd_ref`: the JAX package's
``*_xla`` arms); a CPU tensor always runs the plain version, a CUDA
tensor under the flag launches the kernel or raises.

The training kernel is one cooperative launch of a persistent grid
(:func:`train_bwd_plan`): every CTA holds its chunk of rows of x and the
masked dy in shared memory across a grid barrier, so where the chunk
fits, x and dy cross device memory once. A launch the card refuses (more
CTAs than it holds at once, too much shared memory, a capture that does
not take a cooperative launch) raises :class:`KernelLaunchError`; nothing
falls back.

The given-statistics kernel is one launch too (:func:`norm_bwd_plan`: one
wave of co-resident CTAs): dx is row-local, so each CTA writes dx and a
partial row of its chunk's sums, and the last CTAs to arrive (tickets on
``fused_bn.tile_counters``) sum them in a fixed order.

``train_bwd.launches`` and ``norm_bwd.launches`` count calls that
launched the kernel: ONE per call, and one CUDA launch each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.errors import KernelLaunchError
from ..core.flags import flag_active
from .fused_bn import (_DTYPES, TrainPlan, _sm_count, block_width,
                       c_ints, check_channels, check_rows, coop_limits,
                       device_index, resident_plan, stats_f32, stats_plan,
                       supported, tile_counters)

__all__ = ["train_bwd", "norm_bwd", "train_bwd_ref", "norm_bwd_ref",
           "supported", "TrainBwdPlan", "train_bwd_plan",
           "train_bwd_launch_plan", "norm_bwd_plan"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = {
    # x, g, mean, var, y, dy, dx, dres, dg, db, psg, psb; rows; c, tx,
    # chunks; rows_per_chunk; resident, smem_bytes; eps; relu, dtype,
    # pdtype; stream
    "p1t_fused_bn_bwd_train": [_P] * 12 + [_L, _I, _I, _I, _L, _I, _I, _F,
                                           _I, _I, _I, _P],
    # as above with counters after psb, without resident, smem_bytes
    "p1t_fused_bn_bwd_norm": [_P] * 13 + [_L, _I, _I, _I, _L, _F, _I, _I,
                                          _I, _P],
    # dtype, pdtype, smem_bytes, &blocks
    "p1t_fused_bn_bwd_train_occupancy": [_I, _I, _I, _P],
    # dtype, pdtype, &blocks
    "p1t_fused_bn_bwd_norm_occupancy": [_I, _I, _P],
}
_fns = {}

# The training kernel's shared memory ahead of the resident rows
# (fused_bn_bwd.cu kBwdFixedSmem: column-sum scratch and five coefficient
# rows of the widest tile).
FIXED_SMEM = 256 * 8 * 4 + 5 * 256 * 4
TrainBwdPlan = TrainPlan


def train_bwd_plan(rows: int, c: int, itemsize: int, sms: int,
                   blocks_per_sm: int, smem_per_cta: int) -> TrainPlan:
    """:func:`fused_bn.resident_plan` of the training backward: x's and the
    masked dy's rows resident."""
    return resident_plan("train_bwd", rows, c, 2, itemsize, FIXED_SMEM,
                         sms, blocks_per_sm, smem_per_cta)


@functools.lru_cache(maxsize=None)
def _train_limits(index: int, dtype: int, pdtype: int):
    """``(sms, blocks_per_sm, smem_per_cta)`` of the training kernel on
    card ``index`` (:func:`fused_bn.coop_limits`)."""
    return coop_limits(_kernel("p1t_fused_bn_bwd_train_occupancy"),
                       "fused_bn_bwd", index, dtype, pdtype)


def train_bwd_launch_plan(x2, pdtype: int) -> TrainPlan:
    """:func:`train_bwd_plan` for ``x2`` on its card."""
    rows, c = (int(s) for s in x2.shape)
    return train_bwd_plan(rows, c, x2.element_size(), *_train_limits(
        device_index(x2.device), _DTYPES[x2.dtype], pdtype))


def norm_bwd_plan(rows: int, c: int, sms: int, blocks_per_sm: int):
    """Block and chunks of the given-statistics backward for ``[rows, C]``
    on a card of ``sms`` SMs that holds ``blocks_per_sm`` of its CTAs at
    once: ``(tx, chunks, rows_per_chunk)``. ``fused_bn.stats_plan``'s
    chunks, cut to one wave of co-resident CTAs where there are more:
    fewer and longer chunks, so fewer partial rows to sum and no second
    wave. Its sums follow the kernels' order over these chunks (a fold per
    lane class of chunks, then the tree); nothing else needs their bits. A
    pure function of its arguments."""
    tx, chunks, rpc = stats_plan(rows, c, sms)
    cap = max(1, sms * blocks_per_sm // block_width(c)[2])
    if chunks > cap:
        rpc = -(-rows // cap)
        chunks = -(-rows // rpc)
    return tx, chunks, rpc


@functools.lru_cache(maxsize=None)
def _norm_blocks_per_sm(index: int, dtype: int, pdtype: int) -> int:
    with torch.cuda.device(index):
        blocks, = c_ints(_kernel("p1t_fused_bn_bwd_norm_occupancy"),
                         "fused_bn_bwd", 1, dtype, pdtype)
    if blocks < 1:
        raise KernelLaunchError(
            f"p1t_fused_bn_bwd_norm_occupancy: {blocks} CTAs an SM")
    return blocks


def norm_bwd_launch_plan(x2, pdtype: int):
    """:func:`norm_bwd_plan` for ``x2`` on its card."""
    rows, c = (int(s) for s in x2.shape)
    index = device_index(x2.device)
    return norm_bwd_plan(rows, c, _sm_count(index), _norm_blocks_per_sm(
        index, _DTYPES[x2.dtype], pdtype))


def _masked(dy2, y2, act):
    dy = dy2.float()
    if act == "relu":
        dy = dy * (y2 > 0).float()
    return dy


def train_bwd_ref(x2, g, mean, var, y2, dy2, eps, act, with_res=False):
    """Plain training-mode backward (``train_bwd_xla``): ``(dx, dgamma,
    dbeta[, dres])``, the sums f32."""
    n = x2.shape[0]
    dy = _masked(dy2, y2, act)
    rstd = torch.rsqrt(var.float() + eps)
    xhat = (x2.float() - mean.float()[None, :]) * rstd[None, :]
    dg = (dy * xhat).sum(dim=0)
    db = dy.sum(dim=0)
    dx = (g.float() * rstd)[None, :] * (
        dy - db[None, :] / n - xhat * dg[None, :] / n)
    dx = dx.to(x2.dtype)
    if with_res:
        return dx, dg, db, dy.to(dy2.dtype)
    return dx, dg, db


def norm_bwd_ref(x2, g, mean, var, y2, dy2, eps, act, with_res=False):
    """Plain given-statistics backward (``norm_bwd_xla``)."""
    dy = _masked(dy2, y2, act)
    rstd = torch.rsqrt(var.float() + eps)
    xhat = (x2.float() - mean.float()[None, :]) * rstd[None, :]
    dg = (dy * xhat).sum(dim=0)
    db = dy.sum(dim=0)
    dx = (dy * (g.float() * rstd)[None, :]).to(x2.dtype)
    if with_res:
        return dx, dg, db, dy.to(dy2.dtype)
    return dx, dg, db


def _kernel(symbol):
    fn = _fns.get(symbol)
    if fn is None:
        from .cuda import build
        fn = build.function("fused_bn_bwd", symbol, _ARGTYPES[symbol])
        _fns[symbol] = fn
    return fn


def _launch(symbol, x2, g, mean, var, y2, dy2, eps, act, with_res):
    """Check the contract, allocate the outputs and scratch, launch."""
    relu = act == "relu"
    check_rows(symbol, x2, dy2, y2 if relu else None)
    rows, c = (int(s) for s in x2.shape)
    pdt = check_channels(symbol, c, x2.device, g)
    m32, v32 = stats_f32(mean), stats_f32(var)
    check_channels(symbol, c, x2.device, m32, v32)
    if symbol == "p1t_fused_bn_bwd_train":
        p = train_bwd_launch_plan(x2, pdt)
        tx, chunks, rpc = p.tx, p.chunks, p.rows_per_chunk
        counters, extra = (), (p.resident, p.smem_bytes)
    else:
        tx, chunks, rpc = norm_bwd_launch_plan(x2, pdt)
        counters = (tile_counters(x2.device,
                                  block_width(c)[2]).data_ptr(),)
        extra = ()
    dx = torch.empty_like(x2)
    dres = torch.empty_like(dy2) if with_res else None
    sums = torch.empty(2, c, dtype=torch.float32, device=x2.device)
    part = torch.empty(2, chunks, c, dtype=torch.float32, device=x2.device)
    ptrs = (x2.data_ptr(), g.data_ptr(), m32.data_ptr(), v32.data_ptr(),
            y2.data_ptr() if relu else 0, dy2.data_ptr(), dx.data_ptr(),
            0 if dres is None else dres.data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            *counters)
    fn = _kernel(symbol)
    with torch.cuda.device(x2.device):
        rc = fn(*ptrs, rows, c, tx, chunks, rpc, *extra, float(eps),
                int(relu), _DTYPES[x2.dtype], pdt,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"{symbol} launch failed: CUDA error {rc} "
            f"({build.error_string('fused_bn_bwd', rc)}) at "
            f"x={tuple(x2.shape)} {x2.dtype}")
    outs = (dx, sums[0], sums[1])
    return outs + (dres,) if with_res else outs


def train_bwd(x2, g, mean, var, y2, dy2, eps, act, with_res=False):
    """dx/dgamma/dbeta (+dresidual) of training-mode fused batch norm:
    the kernel when ``fused_bn_bwd`` resolves active for a CUDA tensor,
    else the plain version. ``y2`` is read only for ``act == "relu"``."""
    if x2.device.type == "cpu" or not flag_active("fused_bn_bwd",
                                                  x2.device):
        return train_bwd_ref(x2, g, mean, var, y2, dy2, float(eps), act,
                             with_res)
    outs = _launch("p1t_fused_bn_bwd_train", x2, g, mean, var, y2, dy2,
                   eps, act, with_res)
    train_bwd.launches += 1
    return outs


def norm_bwd(x2, g, mean, var, y2, dy2, eps, act, with_res=False):
    """dx/dgamma/dbeta (+dresidual) of given-statistics fused batch
    norm; routed as :func:`train_bwd`."""
    if x2.device.type == "cpu" or not flag_active("fused_bn_bwd",
                                                  x2.device):
        return norm_bwd_ref(x2, g, mean, var, y2, dy2, float(eps), act,
                            with_res)
    outs = _launch("p1t_fused_bn_bwd_norm", x2, g, mean, var, y2, dy2,
                   eps, act, with_res)
    norm_bwd.launches += 1
    return outs


train_bwd.launches = 0   # kernel launches; reset by chip_smoke.py
norm_bwd.launches = 0
