"""Attention functionals (port of ``paddle1_tpu/nn/functional/attention.py``).

* :func:`attention_ref` — the dense composition in Paddle's
  ``[batch, seq, heads, head_dim]`` layout (mask, causal, dropout).
* :func:`scaled_dot_product_attention` — the routing of the JAX package
  (``attention.py:127-179``): the flash kernels (``ops/flash_attention``)
  only when dropout is 0, the ``flash_attention`` flag is active for the
  tensors' device, ``supported()`` holds, and the mask is absent or
  provably a pure padding mask (``_as_padding_mask``); everything else
  takes :func:`attention_ref`. The serving paths pass a causal
  ``[1, 1, L, L]`` prefill mask or a decode window of fewer than 128
  queries, so they stay on :func:`attention_ref`.
* :func:`paged_attention` — decode attention over the block-paged K/V
  pool, routed to the CUDA kernel under ``pallas_paged_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.errors import InvalidArgumentError
from ...core.flags import flag_active
from ...ops import flash_attention as fa
from ...ops import paged_attention as pa

__all__ = ["attention_ref", "scaled_dot_product_attention",
           "paged_attention"]


def attention_ref(q, k, v, mask=None, dropout_p: float = 0.0,
                  scale: Optional[float] = None, is_causal: bool = False,
                  dropout_key=None, *,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Dense attention. q, k, v: [B, N, H, D]; ``mask`` broadcastable to
    [B, H, Nq, Nk], boolean (True = keep) or additive. Mixed dtypes (a bf16
    cache under an f32 model) compute in the promoted dtype, as jnp's
    einsum does; the probabilities are rounded to q's dtype first.
    ``is_causal`` keeps keys ``j <= i + Nk - Nq``; ``dropout_p > 0`` drops
    probabilities with a mask drawn from ``generator``; the reference's
    jax ``dropout_key`` has no torch meaning and raises when given."""
    if dropout_key is not None:
        raise InvalidArgumentError(
            "attention_ref: dropout_key is a jax PRNG key; the port draws "
            "its dropout mask from generator=")
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / float(d) ** 0.5
    ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    qh, kh, vh = (torch.transpose(t, 1, 2).to(ct)  # [B,H,N,D]
                  for t in (q, k, v))
    logits = torch.matmul(qh, torch.transpose(kh, -1, -2)) * s
    neg = torch.finfo(logits.dtype).min
    if is_causal:
        nq, nk = logits.shape[-2], logits.shape[-1]
        keep = torch.tril(torch.ones(nq, nk, dtype=torch.bool,
                                     device=logits.device), nk - nq)
        logits = torch.masked_fill(logits, ~keep, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.masked_fill(logits, ~mask, neg)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype).to(ct)
    if dropout_p > 0.0:
        keep = torch.empty(probs.shape, dtype=torch.float32,
                           device=probs.device)
        keep.bernoulli_(1.0 - dropout_p, generator=generator)
        probs = torch.where(keep.bool(), probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.transpose(torch.matmul(probs, vh), 1, 2)


def _as_padding_mask(mask, b: int, nk: int):
    """A ``[B|1, 1, 1, Nk]`` bool or additive mask → ``[B, Nk]`` bool
    keep-mask, or None when it is not provably a pure padding mask (the
    flash kernels drop keys; they cannot carry a finite soft bias). An
    additive mask is read on the host to prove that (as the JAX package
    does for a concrete mask)."""
    if mask is None or mask.dim() != 4 or mask.shape[-1] != nk:
        return None
    if mask.shape[1] != 1 or mask.shape[2] != 1 or \
            mask.shape[0] not in (1, b):
        return None
    flat = mask[:, 0, 0, :]
    if mask.dtype != torch.bool:
        if not bool(((flat.abs() <= 1e-6) | (flat <= -1e4)).all()):
            return None                     # soft bias → dense path
        flat = flat > -1e4
    return flat.expand(b, nk)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None,
                                 use_flash: bool = True, *,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Attention entry (``[B, N, H, D]``): the flash kernels where the
    JAX routing rules allow them (see the module docstring) and
    ``use_flash`` does not forbid them, else the dense composition with
    dropout ``dropout_p`` in training."""
    drop = dropout_p if training else 0.0
    if use_flash and drop == 0.0 and \
            flag_active("flash_attention", query.device) and \
            fa.supported(query.shape, key.shape, causal=is_causal):
        if attn_mask is None:
            return fa.flash_attention(query, key, value, causal=is_causal)
        pm = _as_padding_mask(attn_mask, query.shape[0], key.shape[1])
        if pm is not None:
            return fa.flash_attention(query, key, value, causal=is_causal,
                                      padding_mask=pm)
    return attention_ref(query, key, value, mask=attn_mask, dropout_p=drop,
                         is_causal=is_causal, generator=generator)


def paged_attention(query, k_pool, v_pool, table, pos,
                    name=None) -> torch.Tensor:
    """Decode attention over the block-paged KV pool.

    ``query``: [slots, window, heads, dim] — the window just written;
    ``k_pool``/``v_pool``: [pages, page_size, heads, dim]; ``table``:
    [slots, max_pages_per_slot] int32; ``pos``: [slots] cursor AFTER the
    window write, so query row ``i`` attends key positions
    ``<= pos - window + i``. Under ``pallas_paged_attention`` (``auto`` =
    CUDA tensors) the kernel's wrapper runs, and raises on inputs outside
    the kernel's contract; otherwise the plain version runs."""
    base = pos.to(torch.int32) - query.shape[1]
    fn = pa.paged_attention if flag_active("pallas_paged_attention",
                                           query.device) \
        else pa.paged_attention_ref
    return fn(query, k_pool, v_pool, table, base)
