"""LayerNorm forward: the hand-written CUDA kernel and its plain version.

Port of ``paddle1_tpu/ops/pallas/layer_norm.py`` (``_ln_fwd_kernel``).
The kernel lives in ``ops/cuda/layer_norm.cu``; :func:`layer_norm_ref`
is the plain PyTorch version of the same function, used by the CPU tests
and held against the kernel by ``chip_smoke.py`` on the card.

:func:`fused_layer_norm` launches the kernel for a CUDA tensor and runs
the plain version only for a CPU tensor. There is no fallback: a build
or launch failure raises. :func:`layer_norm` is the differentiable entry
(``torch.autograd.Function``): forward through :func:`fused_layer_norm`,
backward by :func:`layer_norm_bwd_ref`, the plain formula of the JAX
package's ``_ln_vjp_bwd``, which the JAX package computes outside Pallas
too (so there is no backward kernel to port).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.errors import InvalidArgumentError, KernelLaunchError

__all__ = ["fused_layer_norm", "layer_norm", "layer_norm_bwd_ref",
           "layer_norm_ref", "supported"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fn = None


def supported(shape, dtype=torch.float32) -> bool:
    """The last axis normalized, over at least a [rows, H] tensor in a
    dtype the kernel stores. Any H works on the GPU: a warp holds a row
    up to 1024 wide in registers, a CTA walks a wider one (the TPU gate
    was H % 128 == 0 for its lane tiling)."""
    if len(shape) < 2 or dtype not in _DTYPES:
        return False
    rows = 1
    for s in shape[:-1]:
        rows *= int(s)
    return rows >= 1 and int(shape[-1]) >= 1


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, epsilon: float = 1e-5
                   ) -> torch.Tensor:
    """Plain version: f32 mean, two-pass variance, rstd, then
    ``y * w + b``, cast to ``x.dtype`` at the edge."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mean
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + epsilon)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        from .cuda import build
        _fn = build.function("layer_norm", "p1t_layer_norm_fwd",
                             [ctypes.c_void_p] * 4 + [
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_void_p])
    return _fn


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, epsilon: float = 1e-5
                     ) -> torch.Tensor:
    """LayerNorm over the last axis. x: [..., H]; weight/bias: [H].
    CUDA tensors launch the kernel; CPU tensors run
    :func:`layer_norm_ref`. Anything else, or inputs outside the kernel's
    contract, raise InvalidArgumentError."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, weight, bias, epsilon)
    h = int(x.shape[-1])
    if not supported(x.shape, x.dtype):
        raise InvalidArgumentError(
            f"fused_layer_norm: shape {tuple(x.shape)} dtype {x.dtype} is "
            "outside the kernel's contract (see supported())")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype or \
                tuple(t.shape) != (h,):
            raise InvalidArgumentError(
                f"fused_layer_norm: {name} must be [{h}] {x.dtype} on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if x.device.type != "cuda":
        raise InvalidArgumentError(f"fused_layer_norm: unsupported device "
                                   f"{x.device}")
    x2 = torch.reshape(x, (-1, h)).contiguous()
    w = weight.contiguous()
    b = bias.contiguous()
    y = torch.empty_like(x2)
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                x2.shape[0], h, float(epsilon), _DTYPES[x.dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        from .cuda import build
        raise KernelLaunchError(
            f"layer_norm kernel launch failed: CUDA error {rc} "
            f"({build.error_string('layer_norm', rc)}) at "
            f"rows={x2.shape[0]} H={h}")
    fused_layer_norm.launches += 1
    return torch.reshape(y, x.shape)


fused_layer_norm.launches = 0  # kernel launches; reset by chip_smoke.py


def layer_norm_bwd_ref(x: torch.Tensor, weight: torch.Tensor,
                       dy: torch.Tensor, epsilon: float = 1e-5):
    """Backward of LayerNorm over the last axis of ``x`` [rows, H]
    (``_ln_vjp_bwd``): recompute the f32 row stats, then
    ``dx = rstd * (dyw - mean(dyw) - xhat * mean(dyw * xhat))``,
    ``dw = sum(dy * xhat)``, ``db = sum(dy)``; each cast to its input's
    dtype. Returns ``(dx, dw, db)``."""
    xf, dyf = x.float(), dy.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mean
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + epsilon)
    xhat = xc * rstd
    dyw = dyf * weight.float()
    dx = rstd * (dyw - torch.mean(dyw, dim=-1, keepdim=True)
                 - xhat * torch.mean(dyw * xhat, dim=-1, keepdim=True))
    dw = torch.sum(dyf * xhat, dim=0)
    db = torch.sum(dyf, dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, bias, epsilon):
        ctx.save_for_backward(x2, weight)
        ctx.epsilon = epsilon
        return fused_layer_norm(x2, weight, bias, epsilon)

    @staticmethod
    def backward(ctx, dy):
        x2, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd_ref(x2, weight, dy, ctx.epsilon)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               epsilon: float = 1e-5) -> torch.Tensor:
    """Differentiable LayerNorm over the last axis of ``x`` [..., H]:
    the kernel (CUDA) or the plain version (CPU) forward, the plain
    formula backward."""
    h = int(x.shape[-1])
    y = _LayerNorm.apply(torch.reshape(x, (-1, h)), weight, bias,
                         float(epsilon))
    return torch.reshape(y, x.shape)
