"""Sequence parallelism: ring and Ulysses attention (port of
``paddle1_tpu/distributed/sequence_parallel.py``).

Both take ``[B, N_local, H, D]`` on each rank of the sequence group (the
sequence cut into equal contiguous pieces, rank i holding piece i) and
return the attention output in the same layout, differentiable in q, k
and v. The group is ``group=``, else the group ``env.spmd_axes`` binds
to ``axis_name``, else the hybrid group's ``axis_name`` axis (``sep``
names ``sp``); without one the sequence is whole on this rank.

* :func:`ring_attention` — the K/V pieces travel around the ring, one
  rank a step, while each rank's queries merge every piece's partial into
  an online softmax (JAX ``:47-91``). The block math is the JAX
  package's plain f32 (``_block_attn``, ``:33-44``), outside any kernel
  there too. The rotation is one differentiable shift a step of K and V
  stacked (:class:`_Rotate`: forward to the next rank, backward the
  cotangent to the previous one), so each rank's backward makes the same
  collectives in the same order.
* :func:`ulysses_attention` — one all-to-all moves the cut from the
  sequence to the heads (each rank then holds the whole sequence for
  ``H / n`` heads), attention runs locally, and a second all-to-all moves
  it back (JAX ``:94-131``). The exchange is its own inverse, so its
  backward is the same exchange of the cotangent. The local attention is
  the flash kernel (``ops/flash_attention``, rows 3-5 on the card) where
  the ``flash_attention`` flag is active for the tensors' device and
  ``supported()`` holds, else the plain ``attention_ref``. ``num_heads %
  n`` raises.

Both exchanges are all-to-alls over the tensors' bytes, which gloo takes
on CUDA tensors (gloo refuses point-to-point transfers of them:
``tools/torch_hybrid_phases.py --gloo-probe``).

The sequence cut inside ``ParallelEngine`` (a ``batch_spec`` that cuts
the sequence over ``sp``) uses three helpers beside them, over the
group that the engine binds to ``sp``:

* :func:`_seq_slice` — this rank's contiguous slice of the sequence
  (axis 1); its backward all-gathers the slices' cotangents, so the
  input's gradient is whole and equal on every rank;
* :func:`_seq_gather` — the slices gathered whole; its backward keeps
  this rank's slice of the cotangent (the heads after it are replicated,
  so their cotangent is the same on every rank: a sum would scale it by
  the group's size);
* :func:`_ulysses_heads` — Ulysses' first exchange for self-attention
  with the whole ``[B, 1, 1, S]`` key-padding keep-mask (or any mask over
  the whole sequence): after it each rank holds the whole sequence for
  ``H / n`` heads, so the mask applies as on one rank, through the same
  routing as one rank's attention (``F.scaled_dot_product_attention``:
  the flash kernels, rows 3-5, where they apply), and
  :func:`_heads_to_seq` moves the output back. The public
  :func:`ulysses_attention` keeps the JAX signature, which has no mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.errors import InvalidArgumentError
from ..core.flags import flag_active
from . import collective

__all__ = ["ring_attention", "ulysses_attention"]

_NEG_INF = -1e30


def _group(axis_name: str, group) -> Optional[collective.Group]:
    """The sequence group, or None for a sequence whole on this rank."""
    g = collective.axis_group(axis_name, group)
    return collective._active(g) if g is not None and g.nranks > 1 \
        else None


class _Rotate(torch.autograd.Function):
    """``x`` from each rank to the next one around the group; the
    backward moves the cotangent back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        return collective.shift(x, out, 1, group)

    @staticmethod
    def backward(ctx, dy):
        out = torch.empty_like(dy, memory_format=torch.contiguous_format)
        return collective.shift(dy, out, -1, ctx.group), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.exchange(x, group)

    @staticmethod
    def backward(ctx, dy):
        return collective.exchange(dy, ctx.group), None


def _block_attn(q, k, v, scale: float, mask=None):
    """One query piece against one key piece, in f32: the numerator, the
    sum of exponentials and the row maximum (``[B, H, Nq, D]``, ``[B, H,
    Nq]``, ``[B, H, Nq]``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bhqk,bkhd->bhqd", p, v.float()), p.sum(-1), m


def ring_attention(q, k, v, axis_name: str, causal: bool = False,
                   scale: Optional[float] = None, *, group=None):
    """Attention over a sequence cut across the group's ranks:
    ``[B, N_local, H, D]`` in and out on each rank (see the module
    docstring). ``causal`` masks by global position."""
    d = q.shape[-1]
    sc = float(scale) if scale is not None else float(1.0 / (d ** 0.5))
    g = _group(axis_name, group)
    n, my = (1, 0) if g is None else (g.nranks, g.rank)
    nl = q.shape[1]
    pos = torch.arange(nl, device=q.device)
    q_pos = my * nl + pos
    kv = torch.stack([k, v])
    m_run = l_run = acc = None
    for i in range(n):
        src = (my - i) % n
        mask = (q_pos[:, None] >= (src * nl + pos)[None, :])[None, None] \
            if causal else None
        num, l, m = _block_attn(q, kv[0], kv[1], sc, mask)
        if m_run is None:
            m_run, l_run, acc = m, l, num
        else:
            m_new = torch.maximum(m_run, m)
            alpha, beta = torch.exp(m_run - m_new), torch.exp(m - m_new)
            l_run = l_run * alpha + l * beta
            acc = acc * alpha[..., None] + num * beta[..., None]
            m_run = m_new
        if i < n - 1:
            kv = _Rotate.apply(kv, g)
    l_safe = torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)
    out = acc / l_safe[..., None]                          # [B, H, Nq, D]
    return out.transpose(1, 2).to(q.dtype)


def _seq_to_heads(x, g):
    """``[B, Nl, H, D]`` cut over the sequence -> ``[B, n * Nl, H / n, D]``
    cut over the heads: row j of the exchange is heads group j, row i
    received is sequence piece i."""
    b, nl, h, d = x.shape
    n = g.nranks
    x = x.reshape(b, nl, n, h // n, d).permute(2, 0, 1, 3, 4)
    x = _Exchange.apply(x, g)
    return x.permute(1, 0, 2, 3, 4).reshape(b, n * nl, h // n, d)


def _heads_to_seq(x, g):
    """The inverse of :func:`_seq_to_heads`: ``[B, N, H / n, D]`` ->
    ``[B, N / n, H, D]``."""
    b, nn_, hl, d = x.shape
    n = g.nranks
    nl = nn_ // n
    x = x.reshape(b, n, nl, hl, d).permute(1, 0, 2, 3, 4)
    x = _Exchange.apply(x, g)
    return x.permute(1, 2, 0, 3, 4).reshape(b, nl, hl * n, d)


def _check_heads(h: int, g) -> None:
    if h % g.nranks:
        raise InvalidArgumentError(
            f"ulysses: num_heads {h} not divisible by sp={g.nranks}")


def ulysses_attention(q, k, v, axis_name: str, causal: bool = False,
                      scale: Optional[float] = None, *, group=None):
    """Attention over a sequence cut across the group's ranks, the cut
    moved to the heads for the local attention (see the module
    docstring): ``[B, N_local, H, D]`` in and out on each rank."""
    g = _group(axis_name, group)
    if g is not None:
        _check_heads(q.shape[2], g)
        q, k, v = _seq_to_heads(q, g), _seq_to_heads(k, g), \
            _seq_to_heads(v, g)
    from ..nn.functional.attention import attention_ref
    from ..ops import flash_attention as fa
    if flag_active("flash_attention", q.device) and \
            fa.supported(q.shape, k.shape, causal=causal):
        out = fa.flash_attention(q, k, v, causal=causal, scale=scale)
    else:
        out = attention_ref(q, k, v, is_causal=causal, scale=scale)
    return _heads_to_seq(out, g) if g is not None else out


def _ulysses_heads(q, k, v, group):
    """Ulysses' first exchange for self-attention on this rank's ``[B,
    S / n, H, D]`` slice: ``q``, ``k``, ``v`` as ``[B, S, H / n, D]``, on
    which one rank's attention runs with a mask over the WHOLE sequence
    (``MultiHeadAttention.forward``; :func:`_heads_to_seq` moves the output
    back). ``H % n`` raises."""
    _check_heads(q.shape[2], group)
    return tuple(_seq_to_heads(t, group) for t in (q, k, v))


def _gather_seq(x, g):
    """Every rank's ``[B, k, ...]`` slice concatenated along axis 1 in
    group-rank order (one all-gather over the bytes)."""
    xt = x.transpose(0, 1).contiguous()
    out = torch.empty((g.nranks * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    collective.all_gather_into(collective._as_bytes(out),
                               collective._as_bytes(xt), g)
    return out.transpose(0, 1)


def _own_slice(x, g):
    k = x.shape[1] // g.nranks
    return x[:, g.rank * k:(g.rank + 1) * k]


class _SliceSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_slice(x, group).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return _gather_seq(dy, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _own_slice(dy, ctx.group).contiguous(), None


def _seq_slice(x, group):
    """This rank's contiguous slice of ``x``'s sequence (axis 1) over
    ``group``; the backward all-gathers the cotangent (see the module
    docstring). A sequence that does not divide raises."""
    if x.shape[1] % group.nranks:
        raise InvalidArgumentError(
            f"sequence cut: a sequence of {x.shape[1]} does not divide "
            f"over sp={group.nranks}")
    return _SliceSeq.apply(x, group)


def _seq_gather(x, group):
    """The slices of ``group``'s ranks gathered along axis 1; the backward
    keeps this rank's slice of the cotangent."""
    return _GatherSeq.apply(x, group)
