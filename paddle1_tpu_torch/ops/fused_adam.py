"""Fused Adam/AdamW update: the hand-written CUDA kernel and its plain
version.

Port of ``paddle1_tpu/ops/pallas/fused_adam.py`` (``_adam_kernel``). Per
element, in f32::

    m1 = beta1 * m1 + (1 - beta1) * g
    m2 = beta2 * m2 + (1 - beta2) * g * g
    lr_t = lr * scale
    p  = p * (1 - lr_t * decay) - lr_t * (m1 / bc1) / (sqrt(m2 / bc2) + eps)

p keeps its dtype (g takes p's), m1/m2 are f32. ``lr``, ``bc1`` and
``bc2`` arrive as a device array ``[lr, bc1, bc2]``, so the step count is
never baked in; ``decay`` and the learning-rate ``scale`` (the
parameter's ``ParamAttr(learning_rate=...)``, which scales the decoupled
decay too) are per tensor, one ``(decay, scale)`` row each in one f32
table. A scale of 1 gives the update without it bit for bit.

* :func:`fused_adam_ref` — the plain PyTorch version, one tensor.
* :func:`fused_adam_` — updates a whole list of tensors IN PLACE: one
  launch of ``ops/cuda/fused_adam.cu`` for CUDA tensors (a device table
  of pointers, sizes and partitions, cached while the pointers stay the
  same), the plain version per tensor for CPU tensors. Unlike the JAX
  package, which skips tensors under 8192 elements (a TPU tiling detail),
  every tensor goes through the kernel on the card.
* :func:`plan_rows`, :func:`chunk_ranges` — the kernel's partition: each
  tensor's scalar head, 16-byte vector body and scalar tail, and the
  element ranges of each chunk; :func:`fused_adam_emulation` walks it as
  the kernel's persistent grid does, on CPU tensors (the counterpart of
  Pallas' interpret mode for this kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError

__all__ = ["fused_adam_", "fused_adam_ref", "fused_adam_emulation",
           "plan_rows", "chunk_ranges", "CHUNK", "CTAS_PER_SM"]

# the launch's settings (ops/cuda/fused_adam.cu's header; chosen by
# tools/torch_adam_bench.py --sweep, PERF.md): elements a chunk (a multiple
# of 8) and persistent CTAs an SM
CHUNK = 8192
CTAS_PER_SM = 4
VEC_BYTES = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_tables: dict = {}  # pointer signature -> (table, coefficients, n_chunks)


def fused_adam_ref(p, g, m1, m2, lr, bc1, bc2, decay, beta1: float,
                   beta2: float, eps: float, scale: float = 1.0):
    """Plain version: returns ``(new_p, new_m1, new_m2)``; new_p in p's
    dtype. ``lr``/``bc1``/``bc2``/``decay``: floats or 0-d tensors;
    ``scale``: the tensor's learning-rate factor (a float)."""
    if scale != 1.0:
        lr = lr * scale    # rounded in lr's dtype (f32 on the device)
    gf = g.float()
    a = beta1 * m1 + (1.0 - beta1) * gf
    b = beta2 * m2 + (1.0 - beta2) * gf * gf
    upd = (a / bc1) / (torch.sqrt(b / bc2) + eps)
    pf = p.float() * (1.0 - lr * decay) - lr * upd
    return pf.to(p.dtype), a, b


ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_longlong] +
            [ctypes.c_float] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _kernel():
    global _fn
    if _fn is None:
        from .cuda import build
        _fn = build.function("fused_adam", "p1t_fused_adam", ARGTYPES)
    return _fn


def plan_rows(ptrs, item: int, chunk: int = CHUNK):
    """The kernel's table rows ``[p, g, m1, m2, n, first chunk, head,
    body]`` for ``ptrs``, a list of ``(p, g, m1, m2, n)`` (addresses and
    element count) with p and g of ``item`` bytes an element and the
    moments f32. ``head`` is the count of leading elements before all four
    streams are 16-byte aligned together (0 and no body when they cannot
    be), ``body`` the whole vectors of ``16 / item`` elements after it;
    chunk k of a tensor starts at ``head + k * chunk`` (chunk 0 at 0)."""
    vec = VEC_BYTES // item
    rows, first = [], 0
    for pp, gp, ap, bp, n in ptrs:
        head = (-pp % VEC_BYTES) // item
        if all((x + head * size) % VEC_BYTES == 0 for x, size in
               ((pp, item), (gp, item), (ap, 4), (bp, 4))):
            head = min(head, n)
            body = (n - head) // vec * vec
        else:
            head = body = 0
        rows.append([pp, gp, ap, bp, n, first, head, body])
        first += max(1, -(-(n - head) // chunk))
    return rows, first


def chunk_ranges(row, k: int, last: bool, chunk: int = CHUNK):
    """Chunk ``k`` of ``row``'s tensor as the kernel cuts it: ``(cs, vs,
    ve, ce)``, the scalar elements ``[cs, vs)`` and ``[ve, ce)`` and the
    vector body ``[vs, ve)``; ``last``: whether it is the tensor's last
    chunk (which runs to its end)."""
    n, head, body = row[4], row[6], row[7]
    cs = 0 if k == 0 else head + k * chunk
    ce = n if last else head + (k + 1) * chunk
    vs = max(cs, head)
    ve = max(vs, min(ce, head + body))
    return cs, vs, ve, ce


def _table(params, grads, m1s, m2s, decays, scales, device):
    key = (device, tuple((p.data_ptr(), g.data_ptr(), a.data_ptr(),
                          b.data_ptr(), p.nelement())
                         for p, g, a, b in zip(params, grads, m1s, m2s)),
           tuple((float(d), float(s)) for d, s in zip(decays, scales)),
           params[0].element_size(), CHUNK)
    hit = _tables.get(key)
    if hit is None:
        rows, n_chunks = plan_rows(key[1], key[3], CHUNK)
        table = torch.tensor(rows, dtype=torch.int64).to(device)
        dec = torch.tensor(key[2], dtype=torch.float32).reshape(
            -1, 2).to(device)
        if len(_tables) >= 8:
            _tables.clear()
        hit = _tables[key] = (table, dec, n_chunks)
    return hit


def fused_adam_emulation(params, grads, m1s, m2s, scalars, decays,
                         beta1: float, beta2: float, eps: float,
                         scales: Optional[Sequence[float]] = None,
                         chunk: int = CHUNK, grid: int = 132 * CTAS_PER_SM):
    """The kernel's partition on CPU tensors, IN PLACE: the table of
    :func:`plan_rows` from the tensors' own addresses, walked as the
    persistent grid of ``grid`` CTAs walks it (CTA b takes chunks b, b +
    grid, ..., finding each chunk's tensor by stepping forward), each
    chunk's scalar ranges an element at a time and its body a 16-byte
    vector at a time, each piece through :func:`fused_adam_ref`. Returns
    ``(hits, vectors)``: per tensor, how often each element was updated
    (int32, the tensor's shape), and every vector's ``(tensor, start
    element, byte addresses of p, g, m1, m2)``."""
    n = len(params)
    scales = [1.0] * n if scales is None else scales
    item = params[0].element_size()
    vec = VEC_BYTES // item
    rows, n_chunks = plan_rows(
        [(p.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(),
          p.nelement()) for p, g, a, b in zip(params, grads, m1s, m2s)],
        item, chunk)
    flat = [[t.view(-1) for t in ts] for ts in zip(params, grads, m1s, m2s)]
    hits = [torch.zeros(p.nelement(), dtype=torch.int32) for p in params]
    vectors = []
    lr, bc1, bc2 = (scalars[i] for i in range(3))

    def run(t, lo, hi):
        p, g, a, b = (x[lo:hi] for x in flat[t])
        new_p, new_a, new_b = fused_adam_ref(p, g, a, b, lr, bc1, bc2,
                                             float(decays[t]), beta1, beta2,
                                             eps, float(scales[t]))
        p.copy_(new_p)
        a.copy_(new_a)
        b.copy_(new_b)
        hits[t][lo:hi] += 1

    firsts = [r[5] for r in rows]
    for blk in range(min(grid, n_chunks)):
        t = 0
        for k in range(blk, n_chunks, grid):
            while t + 1 < n and firsts[t + 1] <= k:
                t += 1
            last = k + 1 == (firsts[t + 1] if t + 1 < n else n_chunks)
            cs, vs, ve, ce = chunk_ranges(rows[t], k - firsts[t], last, chunk)
            for i in list(range(cs, vs)) + list(range(ve, ce)):
                run(t, i, i + 1)
            for j in range(vs, ve, vec):
                run(t, j, j + vec)
                vectors.append((t, j, rows[t][0] + j * item,
                                rows[t][1] + j * item, rows[t][2] + 4 * j,
                                rows[t][3] + 4 * j))
    return [h.view(p.shape) for h, p in zip(hits, params)], vectors


def fused_adam_(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor],
                m1s: Sequence[torch.Tensor], m2s: Sequence[torch.Tensor],
                scalars: torch.Tensor, decays: Sequence[float],
                beta1: float, beta2: float, eps: float,
                scales: Optional[Sequence[float]] = None) -> None:
    """Update every ``params[i]``, ``m1s[i]``, ``m2s[i]`` in place from
    ``grads[i]``. ``scalars``: f32 ``[3]`` = lr, bc1, bc2 on the params'
    device; ``decays[i]`` and ``scales[i]`` (learning-rate factors, None:
    all 1) per tensor. CUDA tensors: one kernel launch for the whole list
    (all p in one dtype, f32 or bf16; g in p's dtype; m1/m2 f32; all
    contiguous). CPU tensors: the plain version per tensor."""
    n = len(params)
    if scales is None:
        scales = [1.0] * n
    if not (len(grads) == len(m1s) == len(m2s) == len(decays) ==
            len(scales) == n):
        raise InvalidArgumentError("fused_adam_: list lengths differ")
    if n == 0:
        return
    dev = params[0].device
    if dev.type == "cpu":
        lr, bc1, bc2 = (scalars[i] for i in range(3))
        for p, g, a, b, d, sc in zip(params, grads, m1s, m2s, decays,
                                     scales):
            new_p, new_a, new_b = fused_adam_ref(p, g, a, b, lr, bc1, bc2,
                                                 float(d), beta1, beta2, eps,
                                                 float(sc))
            p.copy_(new_p)
            a.copy_(new_a)
            b.copy_(new_b)
        return
    dtype = params[0].dtype
    if dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"fused_adam_: parameter dtype {dtype} is outside the kernel's "
            "contract (float32 or bfloat16)")
    for p, g, a, b in zip(params, grads, m1s, m2s):
        ok = (p.dtype == dtype and g.dtype == dtype and
              a.dtype == torch.float32 and b.dtype == torch.float32 and
              all(t.device == dev and t.is_contiguous() and
                  t.nelement() == p.nelement() for t in (p, g, a, b)))
        if not ok:
            raise InvalidArgumentError(
                f"fused_adam_: every p/g must be contiguous {dtype} and "
                f"m1/m2 contiguous float32 of p's size on {dev}; got p "
                f"{tuple(p.shape)} {p.dtype} g {g.dtype} m1 {a.dtype} "
                f"m2 {b.dtype}")
    if tuple(scalars.shape) != (3,) or scalars.dtype != torch.float32 or \
            scalars.device != dev:
        raise InvalidArgumentError(
            f"fused_adam_: scalars must be f32 [3] on {dev}")
    if dev.type != "cuda":
        raise InvalidArgumentError(f"fused_adam_: unsupported device {dev}")
    table, dec, n_chunks = _table(params, grads, m1s, m2s, decays, scales,
                                  dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), dec.data_ptr(), scalars.data_ptr(), n,
                n_chunks, CHUNK, float(beta1), float(beta2),
                float(1.0 - beta1), float(1.0 - beta2), float(eps),
                _DTYPES[dtype], CTAS_PER_SM,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"fused_adam kernel launch failed: CUDA error {rc} "
            f"({build.error_string('fused_adam', rc)}) over {n} tensors, "
            f"{n_chunks} chunks")
    fused_adam_.launches += 1


fused_adam_.launches = 0  # kernel launches; reset by chip_smoke.py
