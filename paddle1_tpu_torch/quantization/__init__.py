"""int8 decode-weight quantization (port of the decode part of
``paddle1_tpu/quantization/__init__.py``: ``QuantTensor``,
``quantize_weights_int8``, ``dequantize_weights``).

Decode is memory-bound: every step re-reads every weight, so storing the
Linear weights as int8 with one f32 scale per output channel quarters
their bytes on the card. The math stays f32: the generation engine
dequantizes the weights inside each step in plain torch ops (the JAX
package does it inside its trace, where XLA fuses the cast and scale into
the consuming matmul) and the matmuls stay ``torch.matmul``.

``q``: int8 ``[in, out]`` (Paddle's Linear layout); ``scale``: f32
``[out]``, the per-output-channel abs-max over 127, so the error never
mixes channels. Codes are symmetric: ``clip(round(w / scale), -127,
127)``, ``round`` half to even as ``jnp.round``.

The rest of the JAX package's ``quantization`` (QAT, PTQ, ``Int8Linear``,
``quantize_decode``) is not ported yet.
"""

from __future__ import annotations

import collections
from typing import Dict

import torch

__all__ = ["QuantTensor", "quantize_weights_int8", "dequantize_weights"]

QuantTensor = collections.namedtuple("QuantTensor", ["q", "scale"])


def _quantize_array(w: torch.Tensor) -> QuantTensor:
    w = w.float()
    scale = torch.clamp(torch.amax(torch.abs(w), dim=0), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return QuantTensor(q.to(torch.int8), scale)


def _dequantize_array(qt: QuantTensor) -> torch.Tensor:
    return qt.q.to(torch.float32) * qt.scale[None, :]


def quantize_weights_int8(params: Dict[str, torch.Tensor],
                          skip=("embed",)) -> Dict[str, object]:
    """Per-channel int8 quantization over a ``{name: tensor}`` state:
    every 2-D floating ``*.weight`` (except names containing a ``skip``
    fragment: embeddings index rows, where a shared per-column scale
    costs disproportionate accuracy) becomes a :class:`QuantTensor` on
    the tensor's device. Everything else passes through untouched."""
    out: Dict[str, object] = {}
    for name, t in params.items():
        eligible = (name.endswith(".weight")
                    and not any(s in name for s in skip)
                    and t.dim() == 2 and t.is_floating_point())
        out[name] = _quantize_array(t.detach()) if eligible else t
    return out


def dequantize_weights(params: Dict[str, object]
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_weights_int8`: :class:`QuantTensor`
    entries become dense f32 tensors, the rest pass through."""
    return {k: (_dequantize_array(v) if isinstance(v, QuantTensor) else v)
            for k, v in params.items()}
