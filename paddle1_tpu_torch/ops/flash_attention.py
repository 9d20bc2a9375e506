"""Flash-attention forward: the hand-written CUDA kernel, its plain
version and the autograd function over both passes.

Port of ``paddle1_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel``
via ``_flash_fwd``, the ``custom_vjp`` pair and ``_bwd_xla``). Layout
``[B, N, H, D]`` (Paddle's); the per-row log-sum-exp is f32 ``[B, H, Nq]``.
Causal masking is bottom-right aligned (query i sees keys
``j <= i + Nk - Nq``); ``padding_mask`` is an optional ``[B, Nk]``
keep-mask. A row that sees no key gives O = 0 and LSE = -1e30.

* :func:`flash_attention_ref` / :func:`flash_bwd_ref` — the plain
  PyTorch versions (``_flash_fwd``'s contract and ``_bwd_xla``, with the
  sentinel LSE remapped to +inf so such rows get zero gradient).
* :func:`flash_fwd` — launches ``ops/cuda/flash_attention.cu`` for CUDA
  tensors and runs the plain version only for CPU tensors; no fallback.
* :func:`flash_fwd_tc_emulation` — the 16-bit tensor-core kernel's
  arithmetic in plain PyTorch (64-key tiles, the online softmax, P split
  into hi + lo in the 16-bit type, f32 accumulation), bf16 or f16, for
  the CPU tests only.
* :func:`flash_attention` — the differentiable entry
  (``torch.autograd.Function``): forward through :func:`flash_fwd`,
  backward through the kernels of ``flash_attention_bwd`` under the
  ``flash_backward`` flag, else :func:`flash_bwd_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError
from ..core.flags import flag_active

__all__ = ["flash_attention", "flash_attention_ref", "flash_bwd_ref",
           "flash_fwd", "flash_fwd_tc_emulation", "supported"]

BLOCK = 128
_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TC_TILE = 64   # keys of a tile (forward, dQ), queries of a tile (dK/dV)
_fn = None


def supported(q_shape, k_shape, causal: bool = False) -> bool:
    """The JAX package's semantic gates: 4-D shapes, ``N % 128 == 0`` for
    queries and keys (the kernels tile by 64 or 32 rows and handle no
    ragged tail), no causal ``nq > nk`` (leading queries would see no
    key), ``d % 8 == 0`` and ``d <= 256``. The TPU's VMEM gate is
    dropped: a CTA holds one query tile and one key tile, whatever N."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    _, nq, _, d = (int(s) for s in q_shape)
    nk = int(k_shape[1])
    if nq % BLOCK or nk % BLOCK or nq < 1 or nk < 1:
        return False
    if causal and nq > nk:
        return False
    return d % 8 == 0 and 0 < d <= 256


def _scores(q, k, scale, causal, padding_mask):
    """f32 [B, H, Nq, Nk] scores with masked entries at -1e30."""
    qh = q.transpose(1, 2).float() * scale
    kh = k.transpose(1, 2).float()
    s = torch.matmul(qh, kh.transpose(-1, -2))
    nq, nk = s.shape[-2], s.shape[-1]
    if padding_mask is not None:
        keep = padding_mask.to(torch.bool)[:, None, None, :]
        s = s.masked_fill(~keep, _NEG_INF)
    if causal:
        vis = torch.ones(nq, nk, dtype=torch.bool,
                         device=s.device).tril(nk - nq)
        s = s.masked_fill(~vis, _NEG_INF)
    return s


def flash_attention_ref(q, k, v, scale: float, causal: bool = False,
                        padding_mask=None):
    """Plain version of the forward: returns ``(out, lse)``, out in q's
    dtype, lse f32 ``[B, H, Nq]``; rows with no visible key give 0 and
    -1e30."""
    s = _scores(q, k, scale, causal, padding_mask)
    m = s.amax(dim=-1)
    visible = m > _NEG_INF * 0.5
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.matmul(p, v.transpose(1, 2).float())
    out = torch.where(visible[..., None], acc / l_safe[..., None],
                      torch.zeros((), device=q.device))
    lse = torch.where(visible, m + torch.log(l_safe),
                      torch.full((), _NEG_INF, device=q.device))
    return out.transpose(1, 2).to(q.dtype), lse


def flash_bwd_ref(q, k, v, out, lse, dout, scale: float,
                  causal: bool = False, padding_mask=None):
    """Plain version of the backward (``_bwd_xla``): ``(dq, dk, dv)`` in
    the inputs' dtypes, recomputing P from the LSE; a sentinel LSE becomes
    +inf so fully masked rows contribute nothing."""
    s = _scores(q, k, scale, causal, padding_mask)
    lse = torch.where(lse > _NEG_INF * 0.1, lse.float(),
                      torch.full((), float("inf"), device=lse.device))
    p = torch.exp(s - lse[..., None])                   # [B,H,Nq,Nk]
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    doh = dout.transpose(1, 2).float()
    oh = out.transpose(1, 2).float()
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    back = lambda t, like: t.transpose(1, 2).to(like.dtype)  # noqa: E731
    return back(dq, q), back(dk, k), back(dv, v)


def split16(x, dtype=torch.bfloat16):
    """``x`` (f32) as ``hi + lo`` in the 16-bit ``dtype``, both returned in
    f32: what the tensor-core kernels feed the product in place of an f32
    operand."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _heads(*ts, dtype=torch.bfloat16):
    """16-bit operands, as the tensor cores read them, in f32
    [B, H, N, D]."""
    return [t.to(dtype).float().transpose(1, 2) for t in ts]


def _visible(b, nq, k0, nk_tile, nk, causal, padding_mask, device):
    """[B, 1, Nq, tile] bool: (query, key) pairs of keys [k0, k0 + tile)
    that the masks leave visible."""
    vis = torch.ones(b, 1, nq, nk_tile, dtype=torch.bool, device=device)
    if padding_mask is not None:
        vis = vis & padding_mask.to(torch.bool)[:, None, None,
                                                k0:k0 + nk_tile]
    if causal:
        qi = torch.arange(nq, device=device)[:, None]
        kj = torch.arange(k0, k0 + nk_tile, device=device)[None, :]
        vis = vis & (kj <= qi + nk - nq)
    return vis


def flash_fwd_tc_emulation(q, k, v, scale: float, causal: bool = False,
                           padding_mask=None, dtype=torch.bfloat16):
    """The tensor-core forward's numerics in ``dtype`` (bf16 or f16) in
    plain PyTorch (CPU tests only): operands rounded to ``dtype``, S = Q K^T
    exact products summed in f32, the online softmax over 64-key tiles
    (the raw-score max, p = exp((s - m) scale)), O += P_hi V + P_lo V in
    f32. Returns ``(out, lse)`` in f32, before the kernel's store rounds
    ``out`` to ``dtype``; rows with no visible key give 0 and -1e30."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    qh, kh, vh = _heads(q, k, v, dtype=dtype)
    m = torch.full((b, h, nq), float("-inf"), device=q.device)
    l = torch.zeros(b, h, nq, device=q.device)
    acc = torch.zeros(b, h, nq, d, device=q.device)
    for k0 in range(0, nk, TC_TILE):
        s = torch.matmul(qh, kh[:, :, k0:k0 + TC_TILE].transpose(-1, -2))
        vis = _visible(b, nq, k0, s.shape[-1], nk, causal, padding_mask,
                       q.device)
        s = s.masked_fill(~vis, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                         m_new)
        alpha = torch.where(m_new == float("-inf"), torch.ones_like(m),
                            torch.exp((m - mu) * scale))
        p = torch.exp((s - mu[..., None]) * scale)
        hi, lo = split16(p, dtype)
        vt = vh[:, :, k0:k0 + TC_TILE]
        acc = acc * alpha[..., None] + (torch.matmul(hi, vt) +
                                        torch.matmul(lo, vt))
        l = l * alpha + p.sum(-1)
        m = m_new
    seen = l > 0
    l_safe = torch.where(seen, l, torch.ones_like(l))
    out = torch.where(seen[..., None], acc / l_safe[..., None],
                      torch.zeros((), device=q.device))
    lse = torch.where(seen, m * scale + torch.log(l_safe),
                      torch.full((), _NEG_INF, device=q.device))
    return out.transpose(1, 2), lse


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start (the 16-bit kernels copy
    rows, the keep-mask, LSE and delta with 16-byte ``cp.async``); a view
    that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(name, q, k, v, causal, padding_mask):
    """Validate CUDA inputs against the kernels' contract; return the
    contiguous, 16-byte aligned tensors and the keep-mask as bytes (or
    None)."""
    if not supported(q.shape, k.shape, causal) or q.dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
            f"causal={causal} is outside the kernel's contract (see "
            "supported())")
    b, _, h, d = q.shape
    nk = k.shape[1]
    for t_name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or \
                tuple(t.shape) != (b, nk, h, d):
            raise InvalidArgumentError(
                f"{name}: {t_name} must be [{b}, {nk}, {h}, {d}] {q.dtype} "
                f"on {q.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    keep = None
    if padding_mask is not None:
        if tuple(padding_mask.shape) != (b, nk) or \
                padding_mask.device != q.device:
            raise InvalidArgumentError(
                f"{name}: padding_mask must be [{b}, {nk}] on {q.device}, "
                f"got {tuple(padding_mask.shape)} on "
                f"{padding_mask.device}")
        keep = _aligned(padding_mask.to(torch.bool))
    if q.device.type != "cuda":
        raise InvalidArgumentError(f"{name}: unsupported device {q.device}")
    return _aligned(q), _aligned(k), _aligned(v), keep


def _kernel():
    global _fn
    if _fn is None:
        from .cuda import build
        _fn = build.function(
            "flash_attention", "p1t_flash_fwd",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fn


def flash_fwd(q, k, v, scale: float, causal: bool = False,
              padding_mask=None):
    """Same contract as :func:`flash_attention_ref`. CUDA tensors launch
    the kernel; CPU tensors run the plain version. Anything else, or
    inputs outside the kernel's contract, raise InvalidArgumentError."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale, causal, padding_mask)
    q, k, v, keep = _check("flash_fwd", q, k, v, causal, padding_mask)
    b, nq, h, d = (int(s) for s in q.shape)
    nk = int(k.shape[1])
    out = torch.empty_like(q)
    lse = torch.empty(b, h, nq, dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                keep.data_ptr() if keep is not None else None,
                out.data_ptr(), lse.data_ptr(), b, h, nq, nk, d,
                float(scale), int(bool(causal)), _DTYPES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"flash_attention kernel launch failed: CUDA error {rc} "
            f"({build.error_string('flash_attention', rc)}) at "
            f"q={tuple(q.shape)} k={tuple(k.shape)}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0  # kernel launches; reset by chip_smoke.py


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, padding_mask, scale, causal):
        out, lse = flash_fwd(q, k, v, scale, causal, padding_mask)
        ctx.save_for_backward(q, k, v, out, lse, padding_mask)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, padding_mask = ctx.saved_tensors
        args = (q, k, v, out, lse, dout.contiguous(), ctx.scale, ctx.causal,
                padding_mask)
        if flag_active("flash_backward", q.device):
            from .flash_attention_bwd import flash_attention_bwd
            dq, dk, dv = flash_attention_bwd(*args)
        else:
            dq, dk, dv = flash_bwd_ref(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, padding_mask=None):
    """Fused attention, differentiable in q, k and v. ``padding_mask``:
    optional ``[B, Nk]`` keep-mask (bool or 0/1); padded keys are
    excluded from the softmax."""
    d = q.shape[-1]
    s = float(scale) if scale is not None else float(1.0 / (d ** 0.5))
    return _FlashAttention.apply(q, k, v, padding_mask, s, bool(causal))
