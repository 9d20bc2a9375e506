"""Paged decode attention: the hand-written CUDA kernel and its plain version.

Port of ``paddle1_tpu/ops/pallas/paged_attention.py`` (``_kernel``).
K/V live in per-layer global pools of fixed-size pages,
``[pages, page_size, heads, dim]``, and a ``[slots, max_pages_per_slot]``
int32 page table maps each decode slot's logical positions onto pool
pages. Query row ``i`` of slot ``s`` attends key positions
``<= base[s] + i`` (``base`` = the slot's length before this window).

* :func:`paged_attention_ref` — the plain PyTorch version: gathers each
  slot's ``[capacity, heads, dim]`` K/V through the table, then a masked
  softmax. CPU tests use it; ``chip_smoke.py`` holds the kernel to it.
* :func:`paged_attention` — launches ``ops/cuda/paged_attention.cu`` for
  CUDA tensors (one CTA per (slot, head), walking only the live pages),
  and runs the plain version only for CPU tensors. No fallback: inputs
  outside the kernel's contract, a build failure or a launch failure
  raise.

The pools may be stored in another dtype than q (a bf16 cache under an
f32 model); q, K and V are each read as f32 and the output takes q's
dtype, as in the Pallas body.

A row with no visible key gives 0 from the kernel and a uniform average
from the plain version; ``base >= 0`` keeps key 0 visible to every live
row, so the two agree wherever the engine reads the result.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError

__all__ = ["paged_attention", "paged_attention_ref", "supported",
           "smem_bytes"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_fn = None


def smem_bytes(w: int, d: int, ps: int) -> int:
    """Shared memory one CTA needs: the scaled query [W, D], and for each
    of its 4 warps one K and one V page [ps, D + 1], scores [W, ps], the
    accumulator [W, D] and the two [W] softmax vectors, all f32. Mirrors
    ``p1t_paged_attention_smem_bytes`` in the CUDA source."""
    per_warp = 2 * ps * (d + 1) + w * ps + w * d + 2 * w
    return 4 * (w * d + 4 * per_warp)


def supported(q_shape, kp_shape, dtype=torch.float32,
              kv_dtype=None) -> bool:
    """``q``: [slots, window, heads, dim] in ``dtype``; ``kp``: [pages,
    page_size, heads, dim] in ``kv_dtype`` (default: ``dtype``). The GPU
    gate is the CTA's shared-memory budget (the TPU gate was its (8, 128)
    tiling: ps % 8, d % 8, d <= 256, W <= 64)."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    if len(q_shape) != 4 or len(kp_shape) != 4 or dtype not in _DTYPES \
            or kv_dtype not in _DTYPES:
        return False
    _, w, h, d = (int(v) for v in q_shape)
    _, ps, hk, dk = (int(v) for v in kp_shape)
    if min(w, h, d, ps) < 1 or (h, d) != (hk, dk):
        return False
    return smem_bytes(w, d, ps) <= _SMEM_LIMIT


def paged_attention_ref(q, kp, vp, table, base,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version. q: [S, W, H, D]; kp/vp: [P, ps, H, D]; table:
    [S, mpps] int; base: [S] int (slot length before this window).
    Returns [S, W, H, D] in q's dtype."""
    s_, w, h, d = q.shape
    ps = kp.shape[1]
    mpps = table.shape[1]
    cap = mpps * ps
    sc = float(scale) if scale is not None else float(1.0 / (d ** 0.5))
    flat = table.long().reshape(-1)
    k = kp.index_select(0, flat).reshape(s_, cap, h, d)
    v = vp.index_select(0, flat).reshape(s_, cap, h, d)
    logits = torch.einsum("swhd,skhd->shwk", q.float(), k.float()) * sc
    kpos = torch.arange(cap, device=q.device)
    qpos = base.long()[:, None] + torch.arange(w, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [S, W, cap]
    logits = torch.where(mask[:, None], logits,
                         torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("shwk,skhd->swhd", p, v.float())
    return out.to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        from .cuda import build
        _fn = build.function(
            "paged_attention", "p1t_paged_attention",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 +
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fn


def paged_attention(q, kp, vp, table, base,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Same contract as :func:`paged_attention_ref`. CUDA tensors launch
    the kernel; CPU tensors run the plain version. Anything else, or
    inputs outside the kernel's contract, raise InvalidArgumentError."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, kp, vp, table, base, scale)
    if not supported(q.shape, kp.shape, q.dtype, kp.dtype):
        raise InvalidArgumentError(
            f"paged_attention: q {tuple(q.shape)} {q.dtype} / pool "
            f"{tuple(kp.shape)} {kp.dtype} is outside the kernel's contract "
            "(see supported())")
    s_, w, h, d = (int(v) for v in q.shape)
    n_pages, ps = int(kp.shape[0]), int(kp.shape[1])
    for name, t in (("k_pool", kp), ("v_pool", vp)):
        if t.device != q.device or t.dtype != kp.dtype or \
                tuple(t.shape) != tuple(kp.shape) or not t.is_contiguous():
            raise InvalidArgumentError(
                f"paged_attention: {name} must be a contiguous "
                f"{tuple(kp.shape)} {kp.dtype} pool on {q.device}")
    if table.dim() != 2 or table.shape[0] != s_ or base.shape != (s_,):
        raise InvalidArgumentError(
            f"paged_attention: table must be [{s_}, mpps] and base "
            f"[{s_}], got {tuple(table.shape)} / {tuple(base.shape)}")
    if table.device != q.device or base.device != q.device:
        raise InvalidArgumentError("paged_attention: table/base must lie "
                                   f"on {q.device}")
    if q.device.type != "cuda":
        raise InvalidArgumentError(f"paged_attention: unsupported device "
                                   f"{q.device}")
    qc = q.contiguous()
    tb = table.to(torch.int32).contiguous()
    bs = base.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    sc = float(scale) if scale is not None else float(1.0 / (d ** 0.5))
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), tb.data_ptr(),
                bs.data_ptr(), out.data_ptr(), s_, w, h, d, ps,
                int(tb.shape[1]), n_pages, sc, _DTYPES[q.dtype],
                _DTYPES[kp.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"paged_attention kernel launch failed: CUDA error {rc} "
            f"({build.error_string('paged_attention', rc)}) at "
            f"q={tuple(q.shape)} "
            f"pool={tuple(kp.shape)} mpps={int(tb.shape[1])}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0  # kernel launches; reset by chip_smoke.py
