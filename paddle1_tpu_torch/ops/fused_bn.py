"""Fused batch norm, forward: the hand-written CUDA kernels and their
plain versions.

Port of ``paddle1_tpu/ops/pallas/fused_bn.py`` (``_bn_train_kernel``,
``_bn_norm_kernel``, ``_moments_kernel``, ``supported``, ``ACTS`` and the
five custom VJPs).
The kernels live in ``ops/cuda/fused_bn.cu``; the backward kernels in
``ops/cuda/fused_bn_bwd.cu`` (``ops/fused_bn_bwd.py``).

* :func:`fused_bn_train` — training mode over channels-last
  ``x2: [rows, C]``: ``(y, batch_mean, batch_var)`` with f32 statistics,
  ``y = act((x - mean) * rsqrt(var + eps) * gamma + beta [+ residual])``.
* :func:`fused_bn_norm` — the same normalize from GIVEN statistics (eval,
  ``use_global_stats``, and the cross-rank batch norm after its
  all-reduce); ``mean``/``var`` stay differentiable.
* :func:`local_moments` — per-channel f32 ``(sum, sum of squares)`` of
  ``x2``: the per-rank half of the cross-rank batch norm's statistics.

The first two are ``torch.autograd.Function``s whose backward is
``fused_bn_bwd.train_bwd`` / ``norm_bwd``; the moments' backward is the
closed form ``dx = ds + 2 x dss`` in plain PyTorch, as the JAX package
leaves it to XLA. A CUDA tensor launches the
kernel or raises (no fallback); a CPU tensor runs the plain version
(:func:`fused_bn_train_ref`, :func:`fused_bn_norm_ref`), which computes
what the kernel computes: f32 sums, ``var = max(E[x^2] - mean^2, 0)``
with the exact count as a host constant, f32 statistics, the cast at the
edge. Row tensors are f32, bf16 or f16, the affine parameters any of the
three (the Pallas kernels take any 16-bit storage type); every sum,
product and the normalization stay f32 up to the one cast at the store,
so f16's 65504 range bounds only what is stored.

The training forward is one cooperative launch of a persistent grid
(:func:`train_fwd_plan`): every CTA holds its chunk of rows of x in
shared memory across the grid barriers that hand the statistics over, so
where the chunk fits, x crosses device memory once. A launch the card
refuses (more CTAs than it holds at once, too much shared memory) raises
:class:`KernelLaunchError`; nothing falls back.

The local moments (and the given-statistics backward in
``fused_bn_bwd``) are one launch each: every CTA writes a partial row of
its chunk's sums, and the last CTAs to arrive sum them, counted in on
int32 tickets (:func:`tile_counters`): the last of each lane class of
chunks folds its class, the last class runs the shuffle tree;
:func:`tile_finalize_emulation` is that sum's order in plain torch.

``fused_bn_train.launches``, ``fused_bn_norm.launches`` and
``local_moments.launches`` count calls that launched the kernel: ONE per
call, and one CUDA launch each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError

__all__ = ["ACTS", "supported", "fused_bn_train", "fused_bn_norm",
           "local_moments", "fused_bn_train_ref", "fused_bn_norm_ref",
           "local_moments_ref", "TrainPlan", "train_fwd_plan",
           "train_fwd_launch_plan", "tile_counters",
           "tile_finalize_emulation"]

ACTS = ("identity", "relu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256          # fused_bn_common.cuh kThreads
_VEC = 8                # channels per thread
_ALIGN = 16             # bytes: one vector load
COUNTERS_PER_TILE = 33  # fused_bn_common.cuh kCountersPerTile: 32 lane
                        # classes of chunks and the tile
_fns = {}
_counters = {}          # (device, tiles) -> int32 ticket counters


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise InvalidArgumentError(
            f"fused_bn activation must be one of {ACTS}, got {act!r}")


def supported(shape, dtype=None) -> bool:
    """Channels-last ``[..., C]`` with at least 2 dims, at least one row,
    ``C % 8 == 0`` (one 8-channel vector per thread) and, when given, a
    dtype the kernels store (f32, bf16 or f16). The TPU's row-block gate
    (``_common.block_rows``, its VMEM ladder) does not apply: rows are a
    strided loop on the GPU."""
    if len(shape) < 2:
        return False
    c = int(shape[-1])
    rows = 1
    for s in shape[:-1]:
        rows *= int(s)
    if c <= 0 or c % _VEC or rows < 1:
        return False
    return dtype is None or dtype in _DTYPES


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    return torch.relu(y) if act == "relu" else y


# ---------------------------------------------------------------------------
# plain versions


def fused_bn_train_ref(x2, gamma, beta, epsilon, act="identity",
                       residual=None):
    """Plain version of the training kernel: ``(y, mean, var)``."""
    rows = int(x2.shape[0])
    inv = 1.0 / rows
    xf = x2.float()
    mean = xf.sum(dim=0) * inv
    var = torch.clamp((xf * xf).sum(dim=0) * inv - mean * mean, min=0.0)
    y = fused_bn_norm_ref(x2, mean, var, gamma, beta, epsilon, act,
                          residual)
    return y, mean, var


def local_moments_ref(x2):
    """Plain version of the moments kernel: per-channel f32 ``(sum,
    sum of squares)`` of ``x2: [rows, C]``."""
    xf = x2.float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def fused_bn_norm_ref(x2, mean, var, gamma, beta, epsilon, act="identity",
                      residual=None):
    """Plain version of the given-statistics kernel: the statistics in
    f32, ``y = act((x - mean) * rsqrt(var + eps) * gamma + beta [+ res])``
    in f32, cast to ``x2.dtype``."""
    y = (x2.float() - mean.float()) * torch.rsqrt(var.float() + epsilon)
    y = y * gamma.float() + beta.float()
    if residual is not None:
        y = y + residual.float()
    return _act(y, act).to(x2.dtype)


# ---------------------------------------------------------------------------
# the launch plan and the contract, shared with fused_bn_bwd


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_index(device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def block_width(c: int):
    """``(tx, ty, tiles)`` of the family's block for ``C`` channels: ``tx =
    min(C/8, 32)`` channel vectors wide, ``ty = 256 // tx`` rows tall,
    ``tiles`` channel tiles."""
    cv = c // _VEC
    tx = min(cv, 32)
    return tx, _THREADS // tx, -(-cv // tx)


def stats_plan(rows: int, c: int, sms: int):
    """Block and chunks of the reduction passes (statistics, moments,
    given-statistics backward) for ``[rows, C]`` on a card of ``sms`` SMs:
    ``(tx, chunks, rows_per_chunk)``. The rows are cut into ``chunks``
    chunks of consecutive rows, about 4 blocks per SM in all. A pure
    function of its arguments, so the sums' order depends on the shape and
    the card only."""
    tx, ty, tiles = block_width(c)
    row_groups = -(-rows // ty)
    chunks = max(1, min(row_groups, -(-4 * sms // tiles), 65535))
    rows_per_chunk = -(-rows // chunks)
    chunks = -(-rows // rows_per_chunk)
    return tx, chunks, rows_per_chunk


def plan(rows: int, c: int, device):
    """:func:`stats_plan` for ``[rows, C]`` on ``device``'s card."""
    return stats_plan(rows, c, _sm_count(device_index(device)))


def tile_counters(device, tiles: int) -> torch.Tensor:
    """The int32 ticket counters of the one-launch reduction passes (the
    local moments, the given-statistics backward), COUNTERS_PER_TILE per
    channel tile: 0, and left 0 by every launch (the last CTA to arrive on
    a counter sets it back). Allocated at the first call for ``tiles``
    tiles on ``device`` and kept, so a CUDA graph that captured a launch
    replays on the same memory; both kernels share them, so calls on one
    card must not run concurrently on two streams. A first call inside a
    CUDA-graph capture raises :class:`KernelLaunchError`."""
    key = (device, tiles)
    t = _counters.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise KernelLaunchError(
                f"the batch-norm reductions' first call at {tiles} channel "
                "tile(s) must run outside CUDA-graph capture (their ticket "
                "counters are allocated then)")
        t = torch.zeros(tiles * COUNTERS_PER_TILE, dtype=torch.int32,
                        device=device)
        _counters[key] = t
    return t


def tile_finalize_emulation(part: torch.Tensor) -> torch.Tensor:
    """The sum of a ``[chunks, C]`` f32 partial-row tensor into ``[C]``
    in the kernels' order (``fused_bn_common.cuh`` ``finish_tile``): the
    lane sum ``S_l`` adds rows ``l, l + 32, ...`` in turn from 0 (on the
    card the last CTA of that class of chunks, 4 channels a thread), then
    an xor tree over the 32 lane sums (offsets 16, 8, 4, 2, 1; 8 threads
    per 4 channels in the last class's CTA), lane 0's value out. Every
    channel gets the order of one warp per channel; f32 adds, no FMA, so
    plain torch on the CPU gives the card's bits."""
    chunks, c = part.shape
    lanes = torch.zeros(32, c, dtype=torch.float32, device=part.device)
    for k0 in range(0, chunks, 32):
        rows = part[k0:k0 + 32].float()
        lanes[:rows.shape[0]] += rows
    idx = torch.arange(32, device=part.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ o]
    return lanes[0]


def norm_plan(rows: int, c: int, sms: int, blocks_per_sm: int):
    """Block and grid of the normalize pass for ``[rows, C]`` on a card of
    ``sms`` SMs that holds ``blocks_per_sm`` of its CTAs at once (the
    occupancy API's answer): ``(tx, grid_y)``. The grid is one wave,
    ``tiles x grid_y <= sms * blocks_per_sm``, with no more row blocks than
    rows need; a CTA strides over rows. A pure function of its
    arguments."""
    tx, ty, tiles = block_width(c)
    wave = max(1, sms * blocks_per_sm // tiles)
    return tx, max(1, min(-(-rows // ty), wave, 65535))


def c_ints(fn, lib: str, n_out: int, *lead):
    """Call the C function ``fn`` with ``lead`` and ``n_out`` ``int*``
    outputs; return the outputs, raising on a CUDA error (``lib``: the
    library that names it)."""
    outs = [ctypes.c_int(0) for _ in range(n_out)]
    rc = fn(*lead, *(ctypes.byref(o) for o in outs))
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(f"{fn.__name__}: CUDA error {rc} "
                                f"({build.error_string(lib, rc)})")
    return [o.value for o in outs]


@functools.lru_cache(maxsize=None)
def _norm_blocks_per_sm(index: int, dtype: int, pdtype: int) -> int:
    with torch.cuda.device(index):
        blocks, = c_ints(_kernel("p1t_fused_bn_norm_occupancy"), "fused_bn",
                         1, dtype, pdtype)
    if blocks < 1:
        raise KernelLaunchError(
            f"p1t_fused_bn_norm_occupancy: {blocks} CTAs an SM")
    return blocks


def norm_launch_plan(x2, pdtype: int):
    """:func:`norm_plan` for ``x2`` on its card."""
    rows, c = (int(s) for s in x2.shape)
    index = device_index(x2.device)
    return norm_plan(rows, c, _sm_count(index),
                     _norm_blocks_per_sm(index, _DTYPES[x2.dtype], pdtype))


# The cooperative launches (the training forward here, the training
# backward in fused_bn_bwd): the CTAs each aims to put on one SM (each
# gets 1 / CTAS_PER_SM of the SM's shared memory), and the training
# forward's shared memory ahead of its resident rows (fused_bn.cu
# kFwdFixedSmem: column-sum scratch and four coefficient rows of the
# widest tile).
CTAS_PER_SM = 2
FWD_FIXED_SMEM = 256 * 8 * 4 + 4 * 256 * 4


class TrainPlan(NamedTuple):
    """Launch plan of a cooperative training kernel over ``[rows, C]``: a
    grid of ``tiles x chunks`` CTAs of ``tx x ty`` threads; CTA ``(t, k)``
    owns channel tile ``t`` of rows ``[k * rows_per_chunk, ...)``, keeps
    ``resident`` of them in ``smem_bytes`` of shared memory (the
    backward its first, the forward its last) and sums them in sub-chunks
    of ``sub_rows`` rows, ``sub_chunks`` partial rows in all."""
    tx: int
    ty: int
    tiles: int
    chunks: int
    rows_per_chunk: int
    resident: int
    smem_bytes: int
    sub_rows: int
    sub_chunks: int


def resident_plan(name: str, rows: int, c: int, tensors: int,
                  itemsize: int, fixed: int, sms: int, blocks_per_sm: int,
                  smem_per_cta: int, sub_rows=None) -> TrainPlan:
    """The persistent grid for ``[rows, C]`` of ``itemsize``-byte elements
    on a card of ``sms`` SMs that holds ``blocks_per_sm`` CTAs of
    ``smem_per_cta`` bytes of shared memory at once: as few chunks as the
    co-resident CTAs allow to cover the rows' sub-chunks of ``sub_rows``
    rows (default: one sub-chunk a chunk, as many chunks as the CTAs
    allow), and as many rows of each chunk resident as the shared memory
    holds after ``fixed`` bytes, a resident row being ``tensors`` row
    tiles. A pure function of its arguments, so the sums' order depends on
    the shape and the card only. Raises :class:`InvalidArgumentError` when
    one row of CTAs does not fit the card (over 8 * 32 * sms *
    blocks_per_sm channels)."""
    tx, ty, tiles = block_width(c)
    capacity = sms * blocks_per_sm
    if tiles > capacity:
        raise InvalidArgumentError(
            f"{name}: {c} channels need {tiles} co-resident CTAs, the card "
            f"holds {capacity} (outside the kernel's contract)")
    wave = min(capacity // tiles, 65535)
    if sub_rows is None:
        sub_rows = -(-rows // max(1, min(wave, -(-rows // ty))))
    sub_chunks = -(-rows // sub_rows)
    rows_per_chunk = -(-sub_chunks // wave) * sub_rows
    chunks = -(-rows // rows_per_chunk)
    row_bytes = tensors * tx * _VEC * itemsize
    fits = max(0, (smem_per_cta - fixed) // row_bytes)
    resident = min(rows_per_chunk, fits)
    return TrainPlan(tx, ty, tiles, chunks, rows_per_chunk, resident,
                     fixed + resident * row_bytes, sub_rows, sub_chunks)


def train_fwd_plan(rows: int, c: int, itemsize: int, sms: int,
                   blocks_per_sm: int, smem_per_cta: int) -> TrainPlan:
    """:func:`resident_plan` of the training forward: x's rows resident,
    summed in the chunks of :func:`stats_plan`, so that its statistics are
    the reduction passes' (the local moments'), bit for bit."""
    return resident_plan("fused_bn_train", rows, c, 1, itemsize,
                         FWD_FIXED_SMEM, sms, blocks_per_sm, smem_per_cta,
                         sub_rows=stats_plan(rows, c, sms)[2])


@functools.lru_cache(maxsize=None)
def cta_budget(index: int):
    """``(sms, smem_per_cta)`` of card ``index``: each of CTAS_PER_SM CTAs
    gets its share of the SM's shared memory, less what the card reserves
    a CTA, and no more than one CTA may opt in to."""
    with torch.cuda.device(index):
        sms, per_sm, optin, reserved = c_ints(
            _kernel("p1t_fused_bn_device"), "fused_bn", 4)
    return sms, min(optin, per_sm // CTAS_PER_SM - reserved)


def coop_limits(fn, lib: str, index: int, dtype: int, pdtype: int):
    """``(sms, blocks_per_sm, smem_per_cta)`` of a cooperative kernel on
    card ``index``, its occupancy function ``fn`` asked how many CTAs of
    the budget's shared memory one SM holds."""
    sms, budget = cta_budget(index)
    with torch.cuda.device(index):
        blocks, = c_ints(fn, lib, 1, dtype, pdtype, budget)
    if blocks < 1:
        raise KernelLaunchError(
            f"{fn.__name__}: no CTA with {budget} bytes of shared memory "
            "fits an SM")
    return sms, blocks, budget


@functools.lru_cache(maxsize=None)
def _train_limits(index: int, dtype: int, pdtype: int):
    """:func:`coop_limits` of the training forward."""
    return coop_limits(_kernel("p1t_fused_bn_train_fwd_occupancy"),
                       "fused_bn", index, dtype, pdtype)


def train_fwd_launch_plan(x2, pdtype: int) -> TrainPlan:
    """:func:`train_fwd_plan` for ``x2`` on its card."""
    rows, c = (int(s) for s in x2.shape)
    return train_fwd_plan(rows, c, x2.element_size(), *_train_limits(
        device_index(x2.device), _DTYPES[x2.dtype], pdtype))


def check_rows(name, x2, *others):
    """The kernels' contract on the row tensors: ``x2`` a 2-D ``[rows, C]``
    CUDA tensor in f32, bf16 or f16 with ``C % 8 == 0``, contiguous and 16-byte
    aligned; each of ``others`` (None skipped) the same shape, dtype and
    device, contiguous and aligned. Never copies: an input outside the
    contract raises."""
    if x2.dim() != 2 or not supported(x2.shape, x2.dtype):
        raise InvalidArgumentError(
            f"{name}: x {tuple(x2.shape)} {x2.dtype} is outside the "
            "kernel's contract (see supported(): [rows, C], C % 8 == 0, "
            "f32, bf16 or f16)")
    for t in (x2,) + others:
        if t is None:
            continue
        if t.shape != x2.shape or t.dtype != x2.dtype or \
                t.device != x2.device:
            raise InvalidArgumentError(
                f"{name}: a row tensor {tuple(t.shape)} {t.dtype} on "
                f"{t.device} does not match x {tuple(x2.shape)} "
                f"{x2.dtype} on {x2.device} (outside the kernel's "
                "contract)")
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise InvalidArgumentError(
                f"{name}: a row tensor {tuple(t.shape)} is not contiguous "
                "channels-last [rows, C] memory with 16-byte alignment "
                "(outside the kernel's contract; the caller's layout, "
                "e.g. torch.channels_last, must give a free view)")


def check_channels(name, c, device, *vs):
    """``gamma``/``beta``: ``[C]`` contiguous vectors of ONE dtype in
    f32, bf16 or f16 on ``device``; returns that dtype's code."""
    dt = vs[0].dtype
    for v in vs:
        if tuple(v.shape) != (c,) or v.dtype != dt or dt not in _DTYPES \
                or v.device != device or not v.is_contiguous():
            raise InvalidArgumentError(
                f"{name}: gamma/beta must be contiguous [{c}] vectors of "
                f"one dtype (f32, bf16 or f16) on {device}, got "
                f"{tuple(v.shape)} {v.dtype} on {v.device} (outside the "
                "kernel's contract)")
    return _DTYPES[dt]


def stats_f32(v: torch.Tensor) -> torch.Tensor:
    """Given statistics as the kernels read them: f32 and contiguous (the
    JAX kernels cast ``mean``/``var`` to f32 the same way; a [C] vector)."""
    return v.detach().to(torch.float32).contiguous()


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = {
    # x, g, b, res, y, mean, var, ps, pss; rows; c, tx, chunks;
    # rows_per_chunk, sub_rows; sub_chunks, resident, smem_bytes; eps;
    # relu, dtype, pdtype; stream
    "p1t_fused_bn_train_fwd": [_P] * 9 + [_L, _I, _I, _I, _L, _L, _I, _I,
                                          _I, _F, _I, _I, _I, _P],
    # x, mean, var, g, b, res, y; rows; c, tx, grid_y; eps; relu, dtype,
    # pdtype; stream
    "p1t_fused_bn_norm_fwd": [_P] * 7 + [_L, _I, _I, _I, _F, _I, _I, _I,
                                         _P],
    # x, s, ss, ps, pss, counters; rows; c, tx, chunks; rows_per_chunk;
    # dtype; stream
    "p1t_fused_bn_moments": [_P] * 6 + [_L, _I, _I, _I, _L, _I, _P],
    # dtype, pdtype, &blocks
    "p1t_fused_bn_norm_occupancy": [_I, _I, _P],
    # dtype, pdtype, smem_bytes, &blocks
    "p1t_fused_bn_train_fwd_occupancy": [_I, _I, _I, _P],
    # &sms, &smem_per_sm, &smem_optin, &reserved
    "p1t_fused_bn_device": [_P] * 4,
}


def _kernel(symbol):
    fn = _fns.get(symbol)
    if fn is None:
        from .cuda import build
        fn = build.function("fused_bn", symbol, _ARGTYPES[symbol])
        _fns[symbol] = fn
    return fn


def _raise(symbol, rc, x2):
    from .cuda import build
    raise KernelLaunchError(
        f"{symbol} launch failed: CUDA error {rc} "
        f"({build.error_string('fused_bn', rc)}) at x={tuple(x2.shape)} "
        f"{x2.dtype}")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# launch wrappers (no autograd)


def _train_fwd(x2, g, b, res, eps, act):
    if x2.device.type == "cpu":
        return fused_bn_train_ref(x2, g, b, eps, act, res)
    check_rows("fused_bn_train", x2, res)
    rows, c = (int(s) for s in x2.shape)
    pdt = check_channels("fused_bn_train", c, x2.device, g, b)
    p = train_fwd_launch_plan(x2, pdt)
    y = torch.empty_like(x2)
    mean = torch.empty(c, dtype=torch.float32, device=x2.device)
    var = torch.empty_like(mean)
    part = torch.empty(2, p.sub_chunks, c, dtype=torch.float32,
                       device=x2.device)
    fn = _kernel("p1t_fused_bn_train_fwd")
    with torch.cuda.device(x2.device):
        rc = fn(x2.data_ptr(), g.data_ptr(), b.data_ptr(), _ptr(res),
                y.data_ptr(), mean.data_ptr(), var.data_ptr(),
                part[0].data_ptr(), part[1].data_ptr(), rows, c, p.tx,
                p.chunks, p.rows_per_chunk, p.sub_rows, p.sub_chunks,
                p.resident, p.smem_bytes, float(eps), int(act == "relu"),
                _DTYPES[x2.dtype], pdt,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        _raise("p1t_fused_bn_train_fwd", rc, x2)
    fused_bn_train.launches += 1
    return y, mean, var


def _norm_fwd(x2, m, v, g, b, res, eps, act):
    if x2.device.type == "cpu":
        return fused_bn_norm_ref(x2, m, v, g, b, eps, act, res)
    check_rows("fused_bn_norm", x2, res)
    rows, c = (int(s) for s in x2.shape)
    pdt = check_channels("fused_bn_norm", c, x2.device, g, b)
    m32, v32 = stats_f32(m), stats_f32(v)
    check_channels("fused_bn_norm", c, x2.device, m32, v32)
    tx, grid_y = norm_launch_plan(x2, pdt)
    y = torch.empty_like(x2)
    fn = _kernel("p1t_fused_bn_norm_fwd")
    with torch.cuda.device(x2.device):
        rc = fn(x2.data_ptr(), m32.data_ptr(), v32.data_ptr(), g.data_ptr(),
                b.data_ptr(), _ptr(res), y.data_ptr(), rows, c, tx, grid_y,
                float(eps), int(act == "relu"), _DTYPES[x2.dtype], pdt,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        _raise("p1t_fused_bn_norm_fwd", rc, x2)
    fused_bn_norm.launches += 1
    return y


def _moments_fwd(x2):
    if x2.device.type == "cpu":
        return local_moments_ref(x2)
    check_rows("local_moments", x2)
    rows, c = (int(s) for s in x2.shape)
    tx, chunks, rpc = plan(rows, c, x2.device)
    counters = tile_counters(x2.device, block_width(c)[2])
    out = torch.empty(2, c, dtype=torch.float32, device=x2.device)
    part = torch.empty(2, chunks, c, dtype=torch.float32, device=x2.device)
    fn = _kernel("p1t_fused_bn_moments")
    with torch.cuda.device(x2.device):
        rc = fn(x2.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                part[0].data_ptr(), part[1].data_ptr(), counters.data_ptr(),
                rows, c, tx, chunks, rpc, _DTYPES[x2.dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        _raise("p1t_fused_bn_moments", rc, x2)
    local_moments.launches += 1
    return out[0], out[1]


# ---------------------------------------------------------------------------
# differentiable entries (the four custom VJPs of the JAX package, with
# the residual optional in one Function each)


def _stat_cotangent_terms(x2, mean, dmean, dvar, inv_count):
    """Cotangents flowing INTO the batch-stat outputs, folded back into
    dx: mean = sum(x)/n, var = sum(x^2)/n - mean^2. Running-stat
    consumers detach the statistics, so on the training path autograd
    hands None for both and this is skipped."""
    xf = x2.float()
    extra = torch.zeros_like(xf)
    if dmean is not None:
        extra = extra + dmean.float()[None, :]
    if dvar is not None:
        extra = extra + 2.0 * dvar.float()[None, :] * (xf - mean[None, :])
    return extra * inv_count


def _norm_stat_grads(g, var, dg, db, eps):
    """Channel-sized cotangents of the given statistics: y depends on
    mean only through the shift and on var only through rstd."""
    gf = g.float()
    rstd = torch.rsqrt(var.float() + eps)
    dm = -gf * rstd * db
    dv = -0.5 * gf * rstd * rstd * rstd * (dg / rstd)
    return dm, dv


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, g, b, res, eps, act):
        y, mean, var = _train_fwd(x2, g, b, res, eps, act)
        # y feeds only the relu mask: identity never reads it
        ctx.save_for_backward(x2, g, mean, var,
                              y if act == "relu" else None)
        ctx.eps, ctx.act = eps, act
        ctx.res_dtype = None if res is None else res.dtype
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        from .fused_bn_bwd import train_bwd
        x2, g, mean, var, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x2)
        with_res = ctx.res_dtype is not None
        outs = train_bwd(x2, g, mean, var, y, dy, ctx.eps, ctx.act,
                         with_res=with_res)
        dx, dg, db = outs[:3]
        if dmean is not None or dvar is not None:
            extra = _stat_cotangent_terms(x2, mean, dmean, dvar,
                                          1.0 / x2.shape[0])
            dx = (dx.float() + extra).to(x2.dtype)
        dres = outs[3].to(ctx.res_dtype) if with_res else None
        return dx, dg.to(g.dtype), db.to(g.dtype), dres, None, None


class _BNNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, m, v, g, b, res, eps, act):
        y = _norm_fwd(x2, m, v, g, b, res, eps, act)
        ctx.save_for_backward(x2, m, v, g, y if act == "relu" else None)
        ctx.eps, ctx.act = eps, act
        ctx.res_dtype = None if res is None else res.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        from .fused_bn_bwd import norm_bwd
        x2, m, v, g, y = ctx.saved_tensors
        with_res = ctx.res_dtype is not None
        outs = norm_bwd(x2, g, m, v, y, dy, ctx.eps, ctx.act,
                        with_res=with_res)
        dx, dg, db = outs[:3]
        dm = dv = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dm, dv = _norm_stat_grads(g, v, dg, db, ctx.eps)
            dm, dv = dm.to(m.dtype), dv.to(v.dtype)
        dres = outs[3].to(ctx.res_dtype) if with_res else None
        return (dx, dm, dv, dg.to(g.dtype), db.to(g.dtype), dres, None,
                None)


class _LocalMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2):
        ctx.save_for_backward(x2)
        return _moments_fwd(x2)

    @staticmethod
    def backward(ctx, ds, dss):
        # the JAX rule (_lm_bwd_rule): dx = ds + 2 x dss in f32, cast to
        # x.dtype; plain PyTorch, as the JAX package leaves it to XLA
        x2, = ctx.saved_tensors
        dx = ds.float()[None, :] + 2.0 * x2.float() * dss.float()[None, :]
        return dx.to(x2.dtype)


def fused_bn_train(x2, gamma, beta, epsilon, act="identity", residual=None):
    """Training-mode fused batch norm over channels-last ``x2: [rows, C]``
    (``residual`` the same shape, or None). Returns ``(y, batch_mean,
    batch_var)``, the statistics f32 ``[C]``; differentiable in ``x2``,
    ``gamma``, ``beta``, ``residual`` and through the statistics."""
    _check_act(act)
    return _BNTrain.apply(x2, gamma, beta, residual, float(epsilon), act)


def fused_bn_norm(x2, mean, var, gamma, beta, epsilon, act="identity",
                  residual=None):
    """Normalize ``x2: [rows, C]`` with GIVEN per-channel statistics —
    eval mode and ``use_global_stats``. ``mean``/``var`` stay
    differentiable."""
    _check_act(act)
    return _BNNorm.apply(x2, mean, var, gamma, beta, residual,
                         float(epsilon), act)


def local_moments(x2):
    """One f32 pass over ``x2: [rows, C]`` returning per-channel ``(sum,
    sum_of_squares)``, each f32 ``[C]`` — the per-rank half of the
    cross-rank batch norm's statistics; differentiable in ``x2``."""
    return _LocalMoments.apply(x2)


fused_bn_train.launches = 0   # kernel launches; reset by chip_smoke.py
fused_bn_norm.launches = 0
local_moments.launches = 0
