"""Sequence ops over dense-plus-lengths ragged batches (port of
``paddle1_tpu/ops/sequence_ops.py``, the reference's LoDTensor sequence
op family).

As in the JAX package, a batch of sequences is a dense ``[batch,
max_len, ...]`` tensor and an integer ``lengths`` vector, or a packed
``[sum(lengths), ...]`` tensor and its lengths; every op is a masked
dense computation in torch, with autograd, on the device its input lies
on; host data (numpy, lists) goes to the current place first, as
``to_tensor`` puts it, and the other inputs of an op follow its first
tensor. Where an op's output shape depends on the lengths (``sequence_pad``,
``sequence_unpad``, ``sequence_expand``, ``sequence_concat``,
``sequence_slice``) the lengths are read on the host once, as the JAX
package reads them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import to_tensor

__all__ = ["sequence_mask", "sequence_pad", "sequence_unpad",
           "sequence_pool", "sequence_softmax", "sequence_expand",
           "sequence_reverse", "sequence_concat", "sequence_first_step",
           "sequence_last_step", "sequence_conv", "sequence_enumerate",
           "sequence_erase", "sequence_expand_as", "sequence_reshape",
           "sequence_scatter", "sequence_slice",
           "sequence_topk_avg_pooling"]


def _tensor(v, like=None) -> torch.Tensor:
    """``v`` as a tensor: a tensor as it is; host data (numpy, lists,
    scalars) as :func:`to_tensor` makes it, on ``like``'s device, else on
    the current place."""
    if isinstance(v, torch.Tensor):
        return v
    if like is None:
        return to_tensor(v)
    return to_tensor(v, place="cpu").to(like.device)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _valid(lengths: torch.Tensor, t: int, ndim: int) -> torch.Tensor:
    """``[B, T, 1, ...]`` bool: position ``t`` < ``lengths[b]``, with
    ``ndim - 2`` trailing unit dims."""
    ids = torch.arange(t, device=lengths.device)
    mask = ids[None, :] < lengths[:, None]
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


def _lowest(dt: torch.dtype):
    return torch.finfo(dt).min if dt.is_floating_point else \
        torch.iinfo(dt).min


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``lengths [B]`` → a ``[B, maxlen]`` 0/1 mask of ``dtype``
    (``maxlen`` defaults to the longest length)."""
    lengths = _tensor(x)
    ml = int(maxlen) if maxlen is not None else int(lengths.max())
    ids = torch.arange(ml, device=lengths.device)
    return (ids[None, :] < lengths[:, None]).to(dtypes.convert_dtype(dtype))


def sequence_pad(x, pad_value, lengths, maxlen=None, name=None):
    """Packed rows ``[sum(len), ...]`` + ``lengths`` → ``(dense [B,
    maxlen, ...] filled with pad_value, lengths as int64)``."""
    flat = _tensor(x)
    ln = _host(lengths).astype(np.int64).reshape(-1)
    ml = int(maxlen) if maxlen is not None else int(ln.max())
    pv = _tensor(pad_value, flat).to(flat.dtype).reshape(())
    rows, start = [], 0
    for n in ln.tolist():
        seg = flat[start:start + n]
        pad = pv.expand((ml - n,) + tuple(flat.shape[1:]))
        rows.append(torch.cat([seg, pad], dim=0))
        start += n
    return torch.stack(rows), torch.as_tensor(ln, device=flat.device)


def sequence_unpad(x, length, name=None):
    """Dense ``[B, maxlen, ...]`` + lengths → the packed rows."""
    dense = _tensor(x)
    ln = _host(length).astype(np.int64).reshape(-1)
    return torch.cat([dense[b, :n] for b, n in enumerate(ln.tolist())],
                     dim=0)


def sequence_pool(x, lengths, pool_type="sum", name=None):
    """Pooling over the valid time steps of each row: ``sum``,
    ``average``/``mean``, ``sqrt`` (sum over sqrt(len)), ``max``,
    ``first`` or ``last``; an empty row divides by 1."""
    dense = _tensor(x)
    lengths = _tensor(lengths, dense)
    pool_type = pool_type.lower()
    mexp = _valid(lengths, dense.shape[1], dense.dim())
    per_row = (-1,) + (1,) * (dense.dim() - 2)
    zero = torch.zeros((), dtype=dense.dtype, device=dense.device)
    if pool_type in ("sum", "average", "mean", "sqrt"):
        s = torch.where(mexp, dense, zero).sum(dim=1)
        if pool_type == "sum":
            return s
        n = lengths.clamp(min=1).to(dense.dtype).reshape(per_row)
        return s / (n if pool_type != "sqrt" else torch.sqrt(n))
    if pool_type == "max":
        low = torch.full((), _lowest(dense.dtype), dtype=dense.dtype,
                         device=dense.device)
        return torch.where(mexp, dense, low).amax(dim=1)
    if pool_type == "first":
        return dense[:, 0]
    if pool_type == "last":
        idx = (lengths - 1).clamp(min=0).to(torch.int64)
        idx = idx.reshape((-1, 1) + (1,) * (dense.dim() - 2)).expand(
            (-1, 1) + tuple(dense.shape[2:]))
        return torch.gather(dense, 1, idx)[:, 0]
    raise ValueError(f"unknown pool_type {pool_type}")


def sequence_first_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "last")


def sequence_softmax(x, lengths, name=None):
    """Softmax over each row's valid time steps; padding gives 0."""
    dense = _tensor(x)
    lengths = _tensor(lengths, dense)
    mexp = _valid(lengths, dense.shape[1], dense.dim())
    low = torch.full((), torch.finfo(dense.dtype).min, dtype=dense.dtype,
                     device=dense.device)
    out = torch.softmax(torch.where(mexp, dense, low), dim=1)
    return torch.where(mexp, out, torch.zeros_like(out))


def sequence_expand(x, lengths, name=None):
    """Row ``b`` of ``x`` repeated ``lengths[b]`` times, packed."""
    dense = _tensor(x)
    ln = _host(lengths).astype(np.int64).reshape(-1)
    return torch.repeat_interleave(
        dense, torch.as_tensor(ln, device=dense.device), dim=0,
        output_size=int(ln.sum()))


def sequence_reverse(x, lengths, name=None):
    """Each row's valid prefix reversed, the padding left in place."""
    dense = _tensor(x)
    lengths = _tensor(lengths, dense).to(torch.int64)
    ids = torch.arange(dense.shape[1], device=dense.device)[None, :]
    idx = torch.where(ids < lengths[:, None], lengths[:, None] - 1 - ids,
                      ids)
    idx = idx.reshape(idx.shape + (1,) * (dense.dim() - 2)).expand(
        dense.shape)
    return torch.gather(dense, 1, idx)


def sequence_concat(xs, lengths_list, name=None):
    """Several packed batches joined row by row: row ``b`` of the result
    is row ``b`` of each input in turn. Returns ``(packed, lengths)``."""
    flats = [_tensor(x) for x in xs]
    ls = [_host(v).astype(np.int64).reshape(-1) for v in lengths_list]
    offs = [np.concatenate([[0], np.cumsum(v)]) for v in ls]
    rows = [flat[int(off[b]):int(off[b]) + int(v[b])]
            for b in range(len(ls[0]))
            for flat, off, v in zip(flats, offs, ls)]
    return torch.cat(rows, dim=0), torch.as_tensor(
        np.sum(ls, axis=0), device=flats[0].device)


def sequence_conv(x, lengths, filter, context_length, context_start=None,
                  bias=None, name=None):
    """Context-window convolution over time: each position's rows
    ``[t + start, t + start + L)`` (zeros outside the row's valid prefix)
    concatenated feature-wise and projected by ``filter [L * D, out]``
    (+ ``bias``); positions past the row's length give 0.
    ``context_start`` defaults to ``-(L - 1) // 2``."""
    dense = _tensor(x)
    lengths = _tensor(lengths, dense)
    w = _tensor(filter, dense)
    ctx_len = int(context_length)
    start = -((ctx_len - 1) // 2) if context_start is None else \
        int(context_start)
    t = dense.shape[1]
    ids = torch.arange(t, device=dense.device)[None, :]
    zero = torch.zeros((), dtype=dense.dtype, device=dense.device)
    ctx = []
    for off in range(start, start + ctx_len):
        src = ids + off
        ok = (src >= 0) & (src < lengths[:, None])
        safe = src.clamp(0, t - 1).expand(dense.shape[0], t)
        shifted = torch.gather(dense, 1, safe[..., None].expand(
            -1, -1, dense.shape[2]))
        ctx.append(torch.where(ok[..., None], shifted, zero))
    out = torch.cat(ctx, dim=-1) @ w
    if bias is not None:
        out = out + _tensor(bias, dense)
    return torch.where((ids < lengths[:, None])[..., None], out, zero)


def sequence_enumerate(x, lengths, win_size, pad_value=0, name=None):
    """Sliding windows of ids: ``[B, T]`` → ``[B, T, win_size]``; a
    window cell past the row's length, and every cell of a position past
    it, is ``pad_value``."""
    ids = _tensor(x)
    lengths = _tensor(lengths, ids)
    win = int(win_size)
    t = ids.shape[1]
    pos = torch.arange(t, device=ids.device)[None, :, None] + \
        torch.arange(win, device=ids.device)[None, None, :]
    ok = pos < lengths[:, None, None]
    safe = pos.clamp(0, t - 1).expand(ids.shape[0], t, win)
    got = torch.gather(ids[:, :, None].expand(-1, -1, win), 1, safe)
    pad = torch.full((), pad_value, dtype=ids.dtype, device=ids.device)
    got = torch.where(ok, got, pad)
    row = torch.arange(t, device=ids.device)[None, :, None] < \
        lengths[:, None, None]
    return torch.where(row, got, pad)


def sequence_erase(x, lengths, tokens, name=None):
    """Every occurrence of ``tokens`` removed from each row's valid
    prefix, the rest moved left in order. Returns ``(dense,
    new_lengths)``; freed cells are 0."""
    ids = _tensor(x)
    lengths = _tensor(lengths, ids)
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    erase = torch.zeros_like(ids, dtype=torch.bool)
    for tok in np.asarray(tokens, np.int64).reshape(-1).tolist():
        erase |= ids == tok
    keep = (pos < lengths[:, None]) & ~erase
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True)[1]
    compacted = torch.gather(ids, 1, order)
    new_len = keep.sum(dim=1).to(lengths.dtype)
    zero = torch.zeros((), dtype=ids.dtype, device=ids.device)
    return torch.where(pos < new_len[:, None], compacted, zero), new_len


def sequence_expand_as(x, lengths, name=None):
    """:func:`sequence_expand` (the reference's lengths come from ``y``'s
    LoD; here they are given)."""
    return sequence_expand(x, lengths, name=name)


def sequence_reshape(x, lengths, new_dim, name=None):
    """Each row's ``lengths[b] * D`` values re-cut into rows of
    ``new_dim``: ``(dense [B, T * D // new_dim, new_dim], new_lengths)``,
    padding 0. Every ``lengths[b] * D`` must divide by ``new_dim``."""
    dense = _tensor(x)
    nd = int(new_dim)
    ln = _host(lengths)
    b, t, d = dense.shape
    bad = ln[(ln * d) % nd != 0]
    if bad.size:
        raise ValueError(
            f"sequence_reshape: every lengths[b]*D must divide "
            f"new_dim={nd}; rows with lengths {bad.tolist()} (D={d}) do "
            "not — their tail values would be silently dropped")
    if (t * d) % nd:
        raise ValueError(f"T*D={t * d} not divisible by {nd}")
    lengths = _tensor(lengths, dense)
    out = dense.reshape(b, (t * d) // nd, nd)
    new_len = lengths * d // nd
    pos = torch.arange(out.shape[1], device=dense.device)[None, :, None]
    zero = torch.zeros((), dtype=dense.dtype, device=dense.device)
    return torch.where(pos < new_len[:, None, None], out, zero), new_len


def sequence_scatter(x, index, updates, lengths, name=None):
    """Scatter-add: update ``s`` of row ``b`` is added at ``x[b,
    index[b, s]]`` for ``s < lengths[b]``."""
    dense = _tensor(x)
    idx = _tensor(index, dense).to(torch.int64)
    upd = _tensor(updates, dense)
    lengths = _tensor(lengths, dense)
    s = idx.shape[1]
    ok = torch.arange(s, device=dense.device)[None, :] < lengths[:, None]
    upd = torch.where(ok, upd, torch.zeros((), dtype=upd.dtype,
                                           device=upd.device))
    return dense.scatter_add(1, idx, upd.to(dense.dtype))


def sequence_slice(x, offset, length, name=None):
    """Row ``b`` keeps ``[offset[b], offset[b] + length[b])``: ``(dense
    [B, max(length), ...] with freed cells 0, the lengths as int64)``."""
    dense = _tensor(x)
    off = _host(offset).astype(np.int64).reshape(-1)
    ln = _host(length).astype(np.int64).reshape(-1)
    t = dense.shape[1]
    if (off < 0).any() or (ln < 0).any() or (off + ln > t).any():
        raise ValueError(
            f"sequence_slice: offset+length must stay inside the time "
            f"dim (T={t}); got offset={off.tolist()} length={ln.tolist()} "
            "(reference sequence_slice_op enforces the same)")
    ml = int(ln.max()) if ln.size else 0
    dev = dense.device
    steps = torch.arange(ml, device=dev)[None, :]
    pos = steps + torch.as_tensor(off, device=dev)[:, None]
    ok = steps < torch.as_tensor(ln, device=dev)[:, None]
    extra = (1,) * (dense.dim() - 2)
    idx = pos.clamp(0, t - 1).reshape(pos.shape + extra).expand(
        (dense.shape[0], ml) + tuple(dense.shape[2:]))
    out = torch.gather(dense, 1, idx)
    zero = torch.zeros((), dtype=dense.dtype, device=dev)
    return torch.where(ok.reshape(ok.shape + extra), out, zero), \
        torch.as_tensor(ln, device=dev)


def sequence_topk_avg_pooling(x, lengths, topks, name=None):
    """For each ``k`` of ``topks``, the mean of the ``k`` largest valid
    time steps of each channel (a row shorter than ``k`` averages what it
    has): ``x [B, T, C]`` → ``[B, len(topks) * C]``."""
    dense = _tensor(x)
    lengths = _tensor(lengths, dense)
    t = dense.shape[1]
    mask = torch.arange(t, device=dense.device)[None, :, None] < \
        lengths[:, None, None]
    low = torch.full((), torch.finfo(dense.dtype).min, dtype=dense.dtype,
                     device=dense.device)
    srt = torch.sort(torch.where(mask, dense, low), dim=1,
                     descending=True)[0]
    zero = torch.zeros((), dtype=dense.dtype, device=dense.device)
    outs = []
    for k in (int(k) for k in topks):
        kk = min(k, t)
        cnt = torch.clamp(lengths, max=kk)
        valid = torch.arange(kk, device=dense.device)[None, :, None] < \
            cnt[:, None, None]
        s = torch.where(valid, srt[:, :kk], zero).sum(dim=1)
        outs.append(s / cnt[:, None].to(dense.dtype).clamp(min=1))
    return torch.cat(outs, dim=-1)
