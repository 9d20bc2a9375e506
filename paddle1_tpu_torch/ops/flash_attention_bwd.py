"""Flash-attention backward: the two hand-written CUDA passes.

Port of ``paddle1_tpu/ops/pallas/flash_attention_bwd.py`` (``_dkv_kernel``
and ``_dq_kernel``, the FlashAttention-2 split), in
``ops/cuda/flash_attention_bwd.cu``:

* :func:`flash_bwd_dkv` — dK and dV, one CTA per (batch*head, key tile),
  walking the query tiles (under causal masking from the first that can
  see the key tile);
* :func:`flash_bwd_dq` — dQ, one CTA per (batch*head, query tile),
  walking the key tiles.

Both take the forward's LSE and ``delta = rowsum(dout * out)``, which
:func:`flash_attention_bwd` computes with PyTorch ops, as the JAX package
computes it outside Pallas. The kernels remap the sentinel LSE to +inf.
The plain version is ``flash_attention.flash_bwd_ref``; CPU tensors run
it, CUDA tensors launch the kernels or raise.
:func:`flash_bwd_dkv_tc_emulation` and :func:`flash_bwd_dq_tc_emulation`
are the 16-bit (bf16, f16) tensor-core passes' arithmetic in plain
PyTorch, for the CPU tests only.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.errors import KernelLaunchError
from .flash_attention import (_DTYPES, _NEG_INF, TC_TILE, _aligned, _check,
                              _heads, _visible, flash_bwd_ref, split16,
                              supported)

__all__ = ["flash_attention_bwd", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_bwd_dkv_tc_emulation", "flash_bwd_dq_tc_emulation",
           "supported"]

_fns = {}


def _kernel(symbol):
    fn = _fns.get(symbol)
    if fn is None:
        from .cuda import build
        n_ptr = 9 if symbol == "p1t_flash_bwd_dkv" else 8
        fn = build.function(
            "flash_attention_bwd", symbol,
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 +
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        _fns[symbol] = fn
    return fn


def _launch(symbol, ptrs, q, k, scale, causal):
    b, nq, h, d = (int(s) for s in q.shape)
    fn = _kernel(symbol)
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, b, h, nq, int(k.shape[1]), d, float(scale),
                int(bool(causal)), _DTYPES[q.dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"{symbol} launch failed: CUDA error {rc} "
            f"({build.error_string('flash_attention_bwd', rc)}) at "
            f"q={tuple(q.shape)} k={tuple(k.shape)}")


def _rows(lse, delta, q):
    """lse and delta as contiguous f32 [B, H, Nq] on q's device."""
    b, nq, h, _ = q.shape
    out = []
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, nq) or t.device != q.device:
            from ..core.errors import InvalidArgumentError
            raise InvalidArgumentError(
                f"flash backward: {name} must be [{b}, {h}, {nq}] on "
                f"{q.device}, got {tuple(t.shape)} on {t.device}")
        out.append(_aligned(t.float()))
    return out


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal=False,
                  padding_mask=None):
    """(dk, dv) from the kernel; CUDA tensors only (inputs outside the
    kernel's contract raise InvalidArgumentError)."""
    q, k, v, keep = _check("flash_bwd_dkv", q, k, v, causal, padding_mask)
    dout = _aligned(dout.to(q.dtype))
    lse, delta = _rows(lse, delta, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("p1t_flash_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             keep.data_ptr() if keep is not None else None,
             dk.data_ptr(), dv.data_ptr()), q, k, scale, causal)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal=False,
                 padding_mask=None):
    """dq from the kernel; CUDA tensors only."""
    q, k, v, keep = _check("flash_bwd_dq", q, k, v, causal, padding_mask)
    dout = _aligned(dout.to(q.dtype))
    lse, delta = _rows(lse, delta, q)
    dq = torch.empty_like(q)
    _launch("p1t_flash_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             keep.data_ptr() if keep is not None else None,
             dq.data_ptr()), q, k, scale, causal)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv_tc_emulation(q, k, v, dout, lse, delta, scale,
                               causal=False, padding_mask=None,
                               dtype=torch.bfloat16):
    """The tensor-core dK/dV pass's numerics in ``dtype`` (bf16 or f16) in
    plain PyTorch (CPU tests only): operands rounded to ``dtype``; per
    64-query tile, S^T and dP^T as exact products summed in f32, P^T =
    exp(S^T scale - lse) masked (a sentinel LSE gives 0), dS^T / scale =
    P^T (dP^T - delta), then dV += P^T_hi dO + P^T_lo dO and dK +=
    (dS^T / scale)_hi Q + (dS^T / scale)_lo Q in f32, dK times scale at
    the end. Returns ``(dk, dv)`` in f32 ``[B, Nk, H, D]``, before the
    kernel's store rounds them to ``dtype``."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    qh, kh, vh, doh = _heads(q, k, v, dout, dtype=dtype)
    lse = torch.where(lse > _NEG_INF * 0.1, lse.float(),
                      torch.full((), float("inf"), device=lse.device))
    dk = torch.zeros(b, h, nk, d, device=q.device)
    dv = torch.zeros(b, h, nk, d, device=q.device)
    for q0 in range(0, nq, TC_TILE):
        rows = slice(q0, q0 + TC_TILE)
        st = torch.matmul(kh, qh[:, :, rows].transpose(-1, -2))
        dpt = torch.matmul(vh, doh[:, :, rows].transpose(-1, -2))
        vis = _visible(b, nq, 0, nk, nk, causal, padding_mask,
                       q.device)[:, :, rows].transpose(-1, -2)
        pt = torch.where(vis, torch.exp(st * scale - lse[:, :, None, rows]),
                         torch.zeros((), device=q.device))
        dst = pt * (dpt - delta[:, :, None, rows].float())
        for acc, left, right in ((dv, pt, doh), (dk, dst, qh)):
            hi, lo = split16(left, dtype)
            acc += torch.matmul(hi, right[:, :, rows]) + \
                torch.matmul(lo, right[:, :, rows])
    return (dk * scale).transpose(1, 2), dv.transpose(1, 2)


def flash_bwd_dq_tc_emulation(q, k, v, dout, lse, delta, scale,
                              causal=False, padding_mask=None,
                              dtype=torch.bfloat16):
    """The tensor-core dQ pass's numerics in ``dtype`` (bf16 or f16) in
    plain PyTorch (CPU tests only), the mirror of
    :func:`flash_bwd_dkv_tc_emulation`: operands rounded to ``dtype``; per
    64-key tile, S and dP as exact products summed in f32, P = exp(S scale
    - lse) masked (a sentinel LSE gives 0), dS / scale = P (dP - delta),
    then dQ += (dS / scale)_hi K + (dS / scale)_lo K in f32, dQ times scale
    at the end. Returns dq in f32 ``[B, Nq, H, D]``, before the kernel's
    store rounds it to ``dtype``."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    qh, kh, vh, doh = _heads(q, k, v, dout, dtype=dtype)
    lse = torch.where(lse > _NEG_INF * 0.1, lse.float(),
                      torch.full((), float("inf"), device=lse.device))
    dq = torch.zeros(b, h, nq, d, device=q.device)
    for k0 in range(0, nk, TC_TILE):
        keys = slice(k0, k0 + TC_TILE)
        s = torch.matmul(qh, kh[:, :, keys].transpose(-1, -2))
        dp = torch.matmul(doh, vh[:, :, keys].transpose(-1, -2))
        vis = _visible(b, nq, k0, s.shape[-1], nk, causal, padding_mask,
                       q.device)
        p = torch.where(vis, torch.exp(s * scale - lse[..., None]),
                        torch.zeros((), device=q.device))
        hi, lo = split16(p * (dp - delta[..., None].float()), dtype)
        kt = kh[:, :, keys]
        dq += torch.matmul(hi, kt) + torch.matmul(lo, kt)
    return (dq * scale).transpose(1, 2)


flash_bwd_dkv.launches = 0  # kernel launches; reset by chip_smoke.py
flash_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, scale, causal=False,
                        padding_mask=None):
    """``(dq, dk, dv)`` in the ``[B, N, H, D]`` layout, drop-in for
    :func:`flash_bwd_ref`. CPU tensors run the plain version; CUDA tensors
    compute ``delta`` with PyTorch ops and launch both passes."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, out, lse, dout, scale, causal,
                             padding_mask)
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal,
                           padding_mask)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal,
                      padding_mask)
    return dq, dk, dv
