"""Attention functionals (port of ``paddle1_tpu/nn/functional/attention.py``).

* :func:`attention_ref` / :func:`scaled_dot_product_attention` — the
  dense composition in Paddle's ``[batch, seq, heads, head_dim]``
  layout. The serving slice always passes an explicit mask (the causal
  ``[1, 1, L, L]`` prefill mask or the dense-decode cursor mask), which
  the JAX package routes to its plain composition as well, so this port
  has no flash kernel yet.
* :func:`paged_attention` — decode attention over the block-paged K/V
  pool, routed to the CUDA kernel under ``pallas_paged_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.flags import flag_active
from ...ops import paged_attention as pa

__all__ = ["attention_ref", "scaled_dot_product_attention",
           "paged_attention"]


def attention_ref(q, k, v, mask=None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention. q, k, v: [B, N, H, D]; ``mask`` broadcastable to
    [B, H, Nq, Nk], boolean (True = keep) or additive. Mixed dtypes (a bf16
    cache under an f32 model) compute in the promoted dtype, as jnp's
    einsum does; the probabilities are rounded to q's dtype first."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / float(d) ** 0.5
    ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    qh, kh, vh = (t.transpose(1, 2).to(ct) for t in (q, k, v))  # [B,H,N,D]
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * s
    neg = torch.finfo(logits.dtype).min
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, neg)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype).to(ct)
    return torch.matmul(probs, vh).transpose(1, 2)


def scaled_dot_product_attention(query, key, value,
                                 attn_mask=None) -> torch.Tensor:
    """Attention entry for the dense path (inference: no dropout)."""
    return attention_ref(query, key, value, mask=attn_mask)


def paged_attention(query, k_pool, v_pool, table, pos) -> torch.Tensor:
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
