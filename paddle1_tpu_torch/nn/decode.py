"""Token sampling for decode (port of ``greedy_logits_array`` and
``sample_logits_array`` from ``paddle1_tpu/nn/decode.py``).

The semantics are the JAX package's: ``temperature <= 0`` is a per-row
argmax of the raw logits; ``top_k > 0`` keeps the values ``>=`` the k-th
largest (ties included) before the draw. Draws come from explicit
``torch.Generator``s (Philox on CUDA) through the Gumbel-max trick, one
``[V]`` uniform draw per sampled row. JAX's threefry keys cannot be
reproduced, so sampled tokens are not expected to match across packages;
within the port a row's draw depends only on its own generator's state.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = ["greedy_logits_array", "sample_logits_array"]

GeneratorArg = Union[torch.Generator, Sequence[Optional[torch.Generator]],
                     None]


def greedy_logits_array(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis (first index on ties)."""
    return torch.argmax(logits, dim=-1)


def _uniform(logits: torch.Tensor, generator: GeneratorArg) -> torch.Tensor:
    """``[..., V]`` uniforms in (0, 1). One generator draws the whole
    batch; a sequence gives row r its own generator (None = the row needs
    no draw and gets a constant)."""
    if generator is None or isinstance(generator, torch.Generator):
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
    else:
        rows = logits.reshape(-1, logits.shape[-1])
        if len(generator) != rows.shape[0]:
            raise ValueError(f"{len(generator)} generators for "
                             f"{rows.shape[0]} rows")
        half = torch.full((rows.shape[-1],), 0.5, device=logits.device)
        u = torch.stack([
            half if g is None else torch.rand(
                rows.shape[-1], generator=g, device=logits.device,
                dtype=torch.float32)
            for g in generator]).reshape(logits.shape)
    tiny = torch.finfo(torch.float32).tiny
    return u.clamp(min=tiny, max=1.0 - 2 ** -24)


def sample_logits_array(logits: torch.Tensor, generator: GeneratorArg,
                        temperature=1.0, top_k=0) -> torch.Tensor:
    """Temperature/top-k sampling over the last axis of ``logits``.

    ``temperature``/``top_k`` may be Python scalars or tensors
    broadcastable to ``logits.shape[:-1]`` (the engine's per-slot form).
    ``generator``: one ``torch.Generator`` for the batch, or one per row
    (None for rows that are greedy)."""
    t_static = isinstance(temperature, (int, float))
    if t_static and temperature <= 0 and isinstance(top_k, int):
        return greedy_logits_array(logits)
    batch = logits.shape[:-1]
    v = logits.shape[-1]
    t = torch.as_tensor(temperature, dtype=logits.dtype,
                        device=logits.device).broadcast_to(batch)
    scaled = logits / t.clamp(min=1e-6)[..., None]
    if isinstance(top_k, int) and top_k <= 0:
        masked = scaled
    else:
        tk = torch.as_tensor(top_k, dtype=torch.long,
                             device=logits.device).broadcast_to(batch)
        srt = torch.sort(logits, dim=-1).values
        kth = torch.gather(srt, -1, (v - tk).clamp(0, v - 1)[..., None])
        neg = torch.finfo(logits.dtype).min
        masked = torch.where((tk[..., None] > 0) & (logits < kth),
                             torch.full((), neg, dtype=logits.dtype,
                                        device=logits.device), scaled)
    gumbel = -torch.log(-torch.log(_uniform(logits, generator)))
    sampled = torch.argmax(masked + gumbel.to(masked.dtype), dim=-1)
    if t_static:  # statically > 0: the greedy branch is dead
        return sampled
    return torch.where(t <= 0, greedy_logits_array(logits), sampled)
