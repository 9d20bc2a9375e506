"""Row softmax: the hand-written CUDA kernel and its plain version.

Port of ``paddle1_tpu/ops/pallas/softmax.py`` (``_softmax_kernel``). The
kernel lives in ``ops/cuda/softmax.cu``; :func:`softmax_ref` is the plain
PyTorch version of the same function, used by the CPU tests and held
against the kernel by ``chip_smoke.py`` on the card.

:func:`softmax_fwd` launches the kernel for a CUDA tensor and runs the
plain version only for a CPU tensor. There is no fallback: a build or
launch failure, or a CUDA tensor outside the kernel's contract, raises.
:func:`fused_softmax` is the differentiable entry
(``torch.autograd.Function``): forward through :func:`softmax_fwd`,
backward by :func:`softmax_bwd_ref`, the closed form
``dx = p * (dy - sum(dy * p))`` in f32 of the JAX package's
``_sm_vjp_bwd``, which the JAX package computes outside Pallas too (so
there is no backward kernel to port).

:func:`plan` is the kernel's partition of a row width into its three
paths (a lane group a row, a block a row held on chip, a block a row in
two passes); :func:`row_split` cuts a row into its scalar head, 16-byte
body and scalar tail; :func:`softmax_emulation` walks both on CPU tensors
in the kernel's own reduction order (the counterpart of Pallas'
interpret mode for this kernel).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError

__all__ = ["fused_softmax", "softmax_fwd", "softmax_ref", "softmax_bwd_ref",
           "supported", "plan", "row_split", "softmax_emulation", "Plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT_MAX = 2 ** 31 - 1
_fn = None

# the kernel's settings (ops/cuda/softmax.cu's header; chosen by
# tools/torch_softmax_bench.py --sweep, PERF.md)
VEC_BYTES = 16
NARROW_MAX = 1024          # widest row of the lane-group path
NARROW_THREADS = 256
NARROW_BLOCKS_PER_SM = 64
FILL_LANES = 32768         # lanes a launch of narrow rows should reach
SCALAR_MAX = 64            # widest row taken an element a lane, when few
WIDE_MAX = 32768           # widest row held on chip: 1024 threads x 32
WIDE_BLOCKS_PER_SM = 2
TWO_PASS_THREADS = 512
BULK_PIECE = 16384         # bytes of one bulk copy
RING_BYTES = 232448 - 1024  # a block's shared memory less its scratch
_PATHS = {"narrow": 0, "wide": 1, "two_pass": 2}


class Plan(NamedTuple):
    """How the kernel takes rows of one width: ``path``; ``group`` lanes
    a row and ``chunks`` body pieces a lane (narrow) or a thread (wide),
    each piece ``vec`` elements (16 bytes, or 1); ``threads`` a block;
    and on the wide path ``nbuf`` row buffers of ``buf_bytes`` each."""
    path: str
    group: int
    chunks: int
    threads: int
    vec: int
    nbuf: int = 0
    buf_bytes: int = 0


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(rows: int, h: int, item: int) -> Plan:
    """The kernel's plan for ``rows`` rows of ``h`` elements of ``item``
    bytes. Narrow rows: G lanes a row, the smallest power of two that
    covers the row's whole 16-byte vectors (at most 32), and as many
    vectors a lane as cover the row. When ``rows * G`` lanes fall short
    of ``FILL_LANES``, wider groups, so that a few rows still spread over
    many lanes; a row of at most ``SCALAR_MAX`` elements that still falls
    short goes an element a lane over a whole warp (a launch that short
    is all latency)."""
    vec = VEC_BYTES // item
    full = h // vec                       # whole vectors of an aligned row
    if h <= NARROW_MAX:
        g = min(32, _pow2_at_least(max(1, full)))
        while rows * g < FILL_LANES and g < 32:
            g *= 2
        if rows * g < FILL_LANES and h <= SCALAR_MAX:
            return Plan("narrow", 32, _ceil(h, 32), NARROW_THREADS, 1)
        return Plan("narrow", g, max(1, _ceil(full, g)), NARROW_THREADS, vec)
    if h <= WIDE_MAX:
        c = 1
        while _ceil(full, c) > 1024:
            c *= 2
        threads = _ceil(_ceil(full, c), 32) * 32
        buf = _ceil(h * item, 128) * 128
        return Plan("wide", 1, c, threads, vec,
                    2 if 2 * buf <= RING_BYTES else 1, buf)
    return Plan("two_pass", 1, 1, TWO_PASS_THREADS, vec)


def row_split(addr: int, h: int, item: int):
    """``(head, body, tail)`` of a row of ``h`` elements at byte address
    ``addr``: the scalar elements before the first 16-byte boundary, the
    whole 16-byte vectors after it, and the scalar elements left over."""
    vec = VEC_BYTES // item
    head = min(h, (-addr % VEC_BYTES) // item)
    body = (h - head) // vec
    return head, body, h - head - body * vec


def supported(shape, axis: int = -1) -> bool:
    """A softmax over the last axis of at least a non-empty [rows, h]
    tensor: the JAX package's semantic gate, on shape and axis alone as
    there. The kernel's own limit: rows and h within a 32-bit int (its
    grid and in-row index; any width works, a row wider than the on-chip
    limit takes the kernel's two-pass path). The TPU's layout gates
    (h % 128, the VMEM row-block ladder) have no counterpart. The dtype
    is not part of the gate: the kernel takes f32, bf16 and f16, and
    :func:`softmax_fwd` raises on any other dtype of a CUDA tensor."""
    nd = len(shape)
    if nd < 2 or axis not in (-1, nd - 1):
        return False
    rows = 1
    for s in shape[:-1]:
        rows *= int(s)
    h = int(shape[-1])
    return 0 < h <= _INT_MAX and 0 < rows <= _INT_MAX


def softmax_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version over the last axis: in f32, max, ``exp(x - max)``,
    sum and divide, cast to ``x.dtype`` at the edge."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_bwd_ref(p: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Backward over the last axis from the forward's output ``p``:
    ``dx = p * (dy - sum(dy * p))`` in f32, cast to ``p.dtype``."""
    pf, dyf = p.float(), dy.float()
    dx = pf * (dyf - (dyf * pf).sum(dim=-1, keepdim=True))
    return dx.to(p.dtype)


def out_like(x2: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``x2``'s shape and dtype whose address is the
    same modulo 16 bytes, so that a row's 16-byte vectors of x and y fall
    on the same elements."""
    off = x2.data_ptr() % VEC_BYTES // x2.element_size()
    if off == 0:
        return torch.empty_like(x2)
    buf = torch.empty(x2.nelement() + VEC_BYTES, dtype=x2.dtype,
                      device=x2.device)
    shift = (off - buf.data_ptr() % VEC_BYTES // x2.element_size()) % (
        VEC_BYTES // x2.element_size())
    return buf[shift:shift + x2.nelement()].view(x2.shape)


def _pieces(p: Plan, head: int, body: int, tail: int, vec: int):
    """Per lane (narrow) or thread (wide, two-pass), the row's pieces in
    the order it sums them, as element indices [units, pieces, vec] (-1
    where a piece is short or absent, which adds nothing to a sum): its
    head element(s) first (lane u: u, u + G, ...; thread u: u), then its
    body vectors (u, u + n, ...), then its tail element(s) likewise."""
    if p.path == "narrow":
        n, ns, nv = p.group, _ceil(vec - 1, p.group), p.chunks
    else:
        n, ns = p.threads, 1
        nv = p.chunks if p.path == "wide" else _ceil(body, p.threads)
    u = torch.arange(n)[:, None]
    e = u + torch.arange(ns) * n                           # [n, ns]
    j = u + torch.arange(nv) * n                           # [n, nv]
    lane = torch.arange(vec)
    pad = torch.full((n, ns, vec - 1), -1)
    t0 = head + body * vec
    return torch.cat([
        torch.cat([torch.where(e < head, e, -1)[..., None], pad], 2),
        torch.where((j < body)[..., None], head + j[..., None] * vec + lane,
                    -1),
        torch.cat([torch.where(e < tail, t0 + e, -1)[..., None], pad], 2)],
        1)


def _butterfly(vals, op, width: int):
    """Every lane's value after ``for o = width/2 .. 1: v = op(v,
    v[lane ^ o])`` over groups of ``width`` lanes (``vals``: tuples of
    [lanes] tensors)."""
    idx = torch.arange(vals[0].numel())
    o = width // 2
    while o:
        vals = op(vals, tuple(v[idx ^ o] for v in vals))
        o //= 2
    return vals


def _combine(a, b):
    """The two-pass path's merge of (max, sum) pairs; a zero sum adds
    nothing."""
    (m, s), (m2, s2) = a, b
    mm = torch.maximum(m, m2)
    zero = torch.zeros_like(s)
    return mm, (torch.where(s == 0, zero, s * torch.exp(m - mm)) +
                torch.where(s2 == 0, zero, s2 * torch.exp(m2 - mm)))


def softmax_emulation(x: torch.Tensor):
    """The kernel on a CPU tensor ``x`` [rows, h] (f32, bf16 or f16) as
    its partition and reduction order take it, from ``x``'s own address:
    each row's head, body and tail (:func:`row_split`); its pieces per
    lane or thread (:func:`plan`); per piece in order, ``exp(x - max)``
    summed in f32 (the two-pass path: an online (max, sum) a piece); the
    shuffle trees over the lane group, or over each warp and then the
    warps' partials. Returns ``(y, plan, hits, vectors, copies)``: y in
    x's dtype, how often each element was taken (int32, x's shape), the
    byte address of every 16-byte vector load of x and store of y, and the
    wide path's bulk copies ``(global address, offset in the row's
    buffer, bytes)``."""
    rows, h = x.shape
    item = x.element_size()
    p = plan(rows, h, item)
    y = out_like(x)
    xf = x.float()
    hits = torch.zeros(rows, h, dtype=torch.int32)
    vectors, copies = [], []
    inf = float("inf")
    for r in range(rows):
        xa, ya = x.data_ptr() + r * h * item, y.data_ptr() + r * h * item
        head, body, tail = (row_split(xa, h, item) if p.vec > 1 else
                            (0, h, 0))      # an element a piece: no head
        idx = _pieces(p, head, body, tail, p.vec)
        live = idx >= 0
        hits[r] += torch.bincount(idx[live], minlength=h).int()
        if p.vec > 1:                               # 16-byte vectors
            starts = idx[:, :, 0][live.all(dim=2)].tolist()
            vectors += [a + e * item for e in starts for a in (xa, ya)]
        if p.path == "wide":
            copies += [(xa + head * item + o, o,
                        min(BULK_PIECE, body * VEC_BYTES - o))
                       for o in range(0, body * VEC_BYTES, BULK_PIECE)]
        row = torch.cat([xf[r], torch.tensor([-inf])])
        v = row[idx]                        # idx -1 reads the -inf pad
        n, width = idx.shape[:2]
        if p.path == "two_pass":
            m = torch.full((n,), -inf)
            s = torch.zeros(n)
            for k in range(width):
                vm = v[:, k].amax(dim=1)
                up = vm > m
                s = torch.where(up, s * torch.exp(m - vm), s)
                m = torch.where(up, vm, m)
                for i in range(p.vec):
                    a = v[:, k, i]
                    add = torch.exp(a - m)
                    s = s + torch.where(live[:, k, i] & (a != -inf), add,
                                        torch.zeros_like(add))
            pair = _reduce(p, (m, s), _combine, (-inf, 0.0))
            mx, tot = pair
        else:
            mx = xf[r].amax()
            e = torch.where(live, torch.exp(v - mx), torch.zeros_like(v))
            s = torch.zeros(n)
            for k in range(width):
                for i in range(p.vec):
                    s = s + e[:, k, i]
            tot, = _reduce(p, (s,), lambda a, b: (a[0] + b[0],), (0.0,))
        y[r] = (torch.exp(xf[r] - mx) / tot).to(x.dtype)
    return y, p, hits, vectors, copies


def _reduce(p: Plan, vals, op, fill):
    """The kernel's reduction of per-unit values: a butterfly over the
    lane group (narrow), else over each warp, then over the warps'
    partials (lane l of every warp reads warp l's, ``fill`` past the
    last warp). Returns the values every unit ends with (unit 0's)."""
    if p.path == "narrow":
        out = _butterfly(vals, op, p.group)
        return tuple(v[0] for v in out)
    out = _butterfly(vals, op, 32)
    part = [v[::32] for v in out]           # lane 0 of each warp
    lanes = tuple(torch.cat([pv, torch.full((32 - pv.numel(),), f)])
                  for pv, f in zip(part, fill))
    return tuple(v[0] for v in _butterfly(lanes, op, 32))


ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 +
            [ctypes.c_void_p])


def _kernel():
    global _fn
    if _fn is None:
        from .cuda import build
        _fn = build.function("softmax", "p1t_softmax_fwd", ARGTYPES)
    return _fn


def softmax_fwd(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of ``x`` [..., h]. CUDA tensors launch
    the kernel; CPU tensors run :func:`softmax_ref`. On any other device,
    or outside the kernel's contract (:func:`supported`, and a dtype of
    f32, bf16 or f16), raises InvalidArgumentError."""
    if x.device.type == "cpu":
        return softmax_ref(x)
    if not supported(x.shape, -1) or x.dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"fused_softmax: shape {tuple(x.shape)} dtype {x.dtype} is "
            "outside the kernel's contract (see supported())")
    if x.device.type != "cuda":
        raise InvalidArgumentError(f"fused_softmax: unsupported device "
                                   f"{x.device}")
    h = int(x.shape[-1])
    x2 = x.reshape(-1, h).contiguous()
    y = out_like(x2)
    p = plan(x2.shape[0], h, x2.element_size())
    bps = NARROW_BLOCKS_PER_SM if p.path == "narrow" else WIDE_BLOCKS_PER_SM
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(x2.data_ptr(), y.data_ptr(), x2.shape[0], h,
                _DTYPES[x.dtype], _PATHS[p.path], p.vec, p.group, p.chunks,
                p.threads, p.nbuf, p.buf_bytes, bps,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"softmax kernel launch failed: CUDA error {rc} "
            f"({build.error_string('softmax', rc)}) at rows={x2.shape[0]} "
            f"h={h} plan={p}")
    fused_softmax.launches += 1
    return y.view(x.shape)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        p = softmax_fwd(x)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, dy):
        p, = ctx.saved_tensors
        return softmax_bwd_ref(p, dy)


def fused_softmax(x: torch.Tensor) -> torch.Tensor:
    """Differentiable softmax over the last axis of ``x`` [..., h]: the
    kernel (CUDA) or the plain version (CPU) forward, the closed-form
    backward in f32."""
    return _Softmax.apply(x)


fused_softmax.launches = 0  # kernel launches; reset by chip_smoke.py
