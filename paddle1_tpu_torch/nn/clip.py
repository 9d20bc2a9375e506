"""Gradient clipping (port of ``paddle1_tpu/nn/clip.py``).

The clip classes take and return ``(param, grad)`` lists, the protocol
every optimizer's ``grad_clip=`` follows (``Optimizer.apply`` calls it
before the update). A parameter whose ``need_clip`` is False, or whose
gradient is None, passes through. Norms are taken in f32 and the scale
is applied in the gradient's dtype, on the gradients' device: nothing is
read back to the host. ``clip_grad_norm_``/``clip_grad_value_`` scale the
``.grad`` of parameters in place, as torch's functions of those names do.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.tensor import to_tensor

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


def _sq_sums(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's sum of squares, in f32."""
    return [torch.sum(torch.square(g.float())) for g in grads]


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient whose own 2-norm exceeds ``clip_norm`` down to
    it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(_sq_sums([g])[0])
            scale = torch.where(norm > self.clip_norm,
                                self.clip_norm / torch.clamp(norm, min=1e-12),
                                torch.ones_like(norm))
            out.append((p, g * scale.to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every clipped gradient by ``min(clip_norm / global_norm, 1)``,
    the global norm taken over all of them together."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        idx = [i for i, (p, g) in enumerate(params_grads) if _clipped(p, g)]
        if not idx:
            return params_grads
        sq = torch.stack(_sq_sums([params_grads[i][1] for i in idx])).sum()
        global_norm = torch.sqrt(sq)
        scale = torch.clamp(
            self.clip_norm / torch.clamp(global_norm, min=1e-12), max=1.0)
        out = list(params_grads)
        for i in idx:
            p, g = params_grads[i]
            out[i] = (p, g * scale.to(g.dtype))
        return out


def _param_list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so their joint
    ``norm_type``-norm is at most ``max_norm``; returns that norm before
    scaling (a Tensor)."""
    params = _param_list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return to_tensor(0.0, place=params[0].device if params else "cpu")
    with torch.no_grad():
        if norm_type == float("inf"):
            total = torch.stack([g.abs().max() for g in grads]).max()
        else:
            total = torch.stack([torch.sum(g.abs() ** norm_type)
                                 for g in grads]).sum() ** (1.0 / norm_type)
        scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return to_tensor(total, place=total.device)


def clip_grad_value_(parameters, clip_value):
    """Clamp the ``.grad`` of ``parameters`` to ``[-clip_value,
    clip_value]`` in place."""
    with torch.no_grad():
        for p in _param_list(parameters):
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)
