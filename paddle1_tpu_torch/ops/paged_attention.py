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
  CUDA tensors (flash-decoding: each (slot, head)'s live pages cut into
  splits of :data:`SPLIT_PAGES` pages, one CTA each, merged in split
  order by the last CTA to finish), and runs the plain version only for
  CPU tensors. No fallback: inputs outside the kernel's contract, a build
  failure or a launch failure raise.
* :func:`paged_attention_split_emulation` — the kernel's split-and-merge
  arithmetic in plain PyTorch, for the CPU tests that hold it to the JAX
  kernel; nothing else calls it.

q and the pools are each f32, bf16 or f16, in any pairing (a bf16 or f16
cache under an f32 model, an f16 model over an f16 pool); q, K and V are
each read as f32, the scores and the softmax stay f32, and the output
takes q's dtype, as in the Pallas body.

A row with no visible key gives 0 from the kernel and a uniform average
from the plain version; ``base >= 0`` keeps key 0 visible to every live
row, so the two agree wherever the engine reads the result.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError

__all__ = ["paged_attention", "paged_attention_ref",
           "paged_attention_split_emulation", "supported", "smem_bytes",
           "SPLIT_PAGES"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
SPLIT_PAGES = 4       # pages one CTA walks (paged_attention.cu kSplitPages)
_fn = None
_scratch = {}         # (device, S * H, splits, W, D) -> partials, counters


def smem_bytes(w: int, d: int, ps: int, kv_itemsize: int = 4) -> int:
    """Shared memory one CTA needs: one split's K and V rows
    ``[SPLIT_PAGES * ps, D]`` in the pools' type, then the scaled query
    ``[W, D]``, the scores ``[W, SPLIT_PAGES * ps]`` and the softmax's m
    and l ``[W]`` in f32. Mirrors ``smem_bytes`` in the CUDA source."""
    keys = SPLIT_PAGES * ps
    return 2 * keys * d * kv_itemsize + 4 * (w * d + w * keys + 2 * w)


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
    itemsize = torch.empty((), dtype=kv_dtype).element_size()
    return smem_bytes(w, d, ps, itemsize) <= _SMEM_LIMIT


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


def paged_attention_split_emulation(q, kp, vp, table, base,
                                    scale: Optional[float] = None,
                                    split_pages: int = SPLIT_PAGES):
    """The kernel's arithmetic in plain PyTorch (f32), for tests: the
    scaled query's scores over each split of ``split_pages`` live pages
    (out-of-range page ids read page 0), the split's own softmax
    ``(m, l = sum exp(s - m), acc = exp(s - m) V)``, then the merge in
    split order: ``M = max m``, ``out = sum acc e / sum l e`` with ``e =
    exp(m - M)``, and 0 for a row that sees no key. Same contract as
    :func:`paged_attention_ref` otherwise."""
    s_, w, h, d = q.shape
    n_pool, ps = kp.shape[0], kp.shape[1]
    mpps = table.shape[1]
    n_splits = -(-mpps // split_pages)
    cap = n_splits * split_pages * ps
    sc = float(scale) if scale is not None else float(1.0 / (d ** 0.5))
    ids = torch.zeros(s_, n_splits * split_pages, dtype=torch.long)
    ids[:, :mpps] = table.long().cpu()
    ids = torch.where((ids >= 0) & (ids < n_pool), ids, 0).to(q.device)
    k = kp.index_select(0, ids.reshape(-1)).reshape(s_, cap, h, d).float()
    v = vp.index_select(0, ids.reshape(-1)).reshape(s_, cap, h, d).float()
    scores = torch.einsum("swhd,skhd->shwk", q.float() * sc, k)
    kpos = torch.arange(cap, device=q.device)
    qpos = base.long()[:, None] + torch.arange(w, device=q.device)
    live = torch.clamp(qpos[:, -1:] + 1, min=0)                 # [S, 1]
    n_pages = torch.clamp(-(-live // ps), max=mpps)
    seen = (kpos[None, None, :] <= qpos[:, :, None]) & \
        (kpos[None, None, :] < n_pages[:, :, None] * ps)      # [S, W, cap]
    scores = torch.where(seen[:, None], scores,
                         torch.full((), float("-inf"), device=q.device))
    scores = scores.reshape(s_, h, w, n_splits, split_pages * ps)
    m = scores.amax(dim=-1)                                   # [S, H, W, n]
    p = torch.where(torch.isinf(scores), torch.zeros((), device=q.device),
                    torch.exp(scores - m[..., None]))
    l_ = p.sum(dim=-1)
    acc = torch.einsum("shwnk,snkhd->shwnd", p,
                       v.reshape(s_, n_splits, split_pages * ps, h, d))
    mx = m.amax(dim=-1, keepdim=True)
    e = torch.where(torch.isinf(m), torch.zeros((), device=q.device),
                    torch.exp(m - torch.where(torch.isinf(mx),
                                              torch.zeros_like(mx), mx)))
    num = (acc * e[..., None]).sum(dim=3)                     # [S, H, W, D]
    den = (l_ * e).sum(dim=-1)
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None],
                      torch.zeros((), device=q.device))
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        from .cuda import build
        _fn = build.function(
            "paged_attention", "p1t_paged_attention",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 +
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fn


def _split_scratch(device, sh: int, n_splits: int, w: int, d: int):
    """The kernel's f32 partials and its int32 counters (0, and left 0 by
    every launch) for one shape on one card, allocated at the shape's
    first call and kept: a CUDA graph that captured a launch replays on
    the same memory. Calls of one shape on one card share them, so they
    must not run concurrently on two streams."""
    key = (device, sh, n_splits, w, d)
    t = _scratch.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise KernelLaunchError(
                "paged_attention: the first call at q window "
                f"{w} x dim {d} must run outside CUDA-graph capture (its "
                "partials and counters are allocated then)")
        t = (torch.empty(sh * n_splits * w * d, dtype=torch.float32,
                         device=device),
             torch.empty(sh * n_splits * 2 * w, dtype=torch.float32,
                         device=device),
             torch.zeros(sh, dtype=torch.int32, device=device))
        _scratch[key] = t
    return t


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
    mpps = int(tb.shape[1])
    out = torch.empty_like(qc)
    part_acc, part_ml, counters = _split_scratch(
        q.device, s_ * h, -(-mpps // SPLIT_PAGES), w, d)
    sc = float(scale) if scale is not None else float(1.0 / (d ** 0.5))
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), tb.data_ptr(),
                bs.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                part_ml.data_ptr(), counters.data_ptr(), s_, w, h, d, ps,
                mpps, n_pages, sc, _DTYPES[q.dtype], _DTYPES[kp.dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"paged_attention kernel launch failed: CUDA error {rc} "
            f"({build.error_string('paged_attention', rc)}) at "
            f"q={tuple(q.shape)} "
            f"pool={tuple(kp.shape)} mpps={mpps}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0  # kernel launches; reset by chip_smoke.py
