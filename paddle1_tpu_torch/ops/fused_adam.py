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
  of pointers and sizes, cached while the pointers stay the same), the
  plain version per tensor for CPU tensors. Unlike the JAX package, which
  skips tensors under 8192 elements (a TPU tiling detail), every tensor
  goes through the kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError

__all__ = ["fused_adam_", "fused_adam_ref", "CHUNK"]

CHUNK = 16384  # elements per CTA
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


def _kernel():
    global _fn
    if _fn is None:
        from .cuda import build
        _fn = build.function(
            "fused_adam", "p1t_fused_adam",
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_longlong] +
            [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    return _fn


def _table(params, grads, m1s, m2s, decays, scales, device):
    key = (device, tuple((p.data_ptr(), g.data_ptr(), a.data_ptr(),
                          b.data_ptr(), p.nelement())
                         for p, g, a, b in zip(params, grads, m1s, m2s)),
           tuple((float(d), float(s)) for d, s in zip(decays, scales)))
    hit = _tables.get(key)
    if hit is None:
        rows, first = [], 0
        for (pp, gp, ap, bp, n) in key[1]:
            rows.append([pp, gp, ap, bp, n, first])
            first += -(-n // CHUNK)
        table = torch.tensor(rows, dtype=torch.int64).to(device)
        dec = torch.tensor(key[2], dtype=torch.float32).reshape(
            -1, 2).to(device)
        if len(_tables) >= 8:
            _tables.clear()
        hit = _tables[key] = (table, dec, first)
    return hit


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
                _DTYPES[dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"fused_adam kernel launch failed: CUDA error {rc} "
            f"({build.error_string('fused_adam', rc)}) over {n} tensors, "
            f"{n_chunks} chunks")
    fused_adam_.launches += 1


fused_adam_.launches = 0  # kernel launches; reset by chip_smoke.py
