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
"""

from __future__ import annotations

import ctypes

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError

__all__ = ["fused_softmax", "softmax_fwd", "softmax_ref", "softmax_bwd_ref",
           "supported"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INT_MAX = 2 ** 31 - 1
_fn = None


def supported(shape, axis: int = -1) -> bool:
    """A softmax over the last axis of at least a non-empty [rows, h]
    tensor: the JAX package's semantic gate, on shape and axis alone as
    there. The kernel's own limit: rows and h within a 32-bit int (its
    grid and in-row index; any width works, a wide row is one block's
    two-pass loop). The TPU's layout gates (h % 128, the VMEM row-block
    ladder) have no counterpart. The dtype is not part of the gate: the
    kernel takes f32, bf16 and f16, and :func:`softmax_fwd` raises on any
    other dtype of a CUDA tensor."""
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


def _kernel():
    global _fn
    if _fn is None:
        from .cuda import build
        _fn = build.function("softmax", "p1t_softmax_fwd",
                             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 +
                             [ctypes.c_void_p])
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
    y = torch.empty_like(x2)
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(x2.data_ptr(), y.data_ptr(), x2.shape[0], h,
                _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"softmax kernel launch failed: CUDA error {rc} "
            f"({build.error_string('softmax', rc)}) at rows={x2.shape[0]} "
            f"h={h}")
    fused_softmax.launches += 1
    return y.reshape(x.shape)


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
