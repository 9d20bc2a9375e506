"""Linear-chain CRF (port of ``paddle1_tpu/nn/functional/crf.py``):
``linear_chain_crf``, the log-likelihood of a tag path, and
``crf_decoding``, the Viterbi path.

The JAX package runs the forward algorithm and Viterbi as ``lax.scan``s
over time, outside any Pallas kernel; the port runs the time steps as a
Python loop of torch ops on batched ``[B, T, N]`` emissions, padding
steps skipped by ``length``. The transition layout is the reference op's:
``transition`` is ``[N + 2, N]``, row 0 the start scores, row 1 the end
scores, rows 2.. the pairwise scores ``transition[2 + i, j]`` of i -> j.
Ties in Viterbi's max go to the lowest tag, as ``jnp.argmax`` breaks
them.
"""

from __future__ import annotations

import torch

from ...core.tensor import Tensor, to_tensor

__all__ = ["linear_chain_crf", "crf_decoding"]


def _t(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _mask(length, T, B, device):
    """``[B, T]`` bool: step t of sequence b is real (all real without
    ``length``)."""
    if length is None:
        return torch.ones((B, T), dtype=torch.bool, device=device)
    lengths = torch.reshape(torch.as_tensor(length, device=device), (B, 1))
    return torch.arange(T, device=device)[None, :] < lengths


def _at(table, rows):
    """``table[rows]`` of a 1-D table."""
    return torch.index_select(table, 0, rows)


def linear_chain_crf(emission, transition, label, length=None):
    """Per-sequence log-likelihood ``log p(label | emission)`` ``[B, 1]``
    (the training objective is its negative). ``emission`` ``[B, T, N]``,
    ``transition`` ``[N + 2, N]``, ``label`` ``[B, T]`` ints, ``length``
    an optional ``[B]`` of real lengths."""
    e, w, y = _t(emission), _t(transition), _t(label)
    B, T, N = (int(v) for v in e.shape)
    start, end = torch.select(w, 0, 0), torch.select(w, 0, 1)
    pair = torch.narrow(w, 0, 2, N)
    pair_flat = torch.reshape(pair, (-1,))
    m = _mask(length, T, B, e.device)
    y = y.to(torch.long)

    def emit(t, tags):
        return torch.gather(torch.select(e, 1, t), 1, tags[:, None])[:, 0]

    # the gold path's score
    prev = torch.select(y, 1, 0)
    score = _at(start, prev) + emit(0, prev)
    for t in range(1, T):
        yt = torch.select(y, 1, t)
        add = _at(pair_flat, prev * N + yt) + emit(t, yt)
        valid = torch.select(m, 1, t)
        score = torch.where(valid, score + add, score)
        prev = torch.where(valid, yt, prev)
    score = score + _at(end, prev)
    # the partition function (the forward algorithm)
    alpha = start[None, :] + torch.select(e, 1, 0)
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + pair[None, :, :], 1) + \
            torch.select(e, 1, t)
        alpha = torch.where(torch.select(m, 1, t)[:, None], nxt, alpha)
    logz = torch.logsumexp(alpha + end[None, :], 1)
    return (score - logz)[:, None]


def crf_decoding(emission, transition, label=None, length=None):
    """The Viterbi path ``[B, T]`` int32, 0 at padding steps. With
    ``label``, the ``[B, T]`` int32 marks: 1 where the decoded tag equals
    the label (on real steps when ``length`` is given)."""
    e, w = _t(emission), _t(transition)
    B, T, N = (int(v) for v in e.shape)
    start, end = torch.select(w, 0, 0), torch.select(w, 0, 1)
    pair = torch.narrow(w, 0, 2, N)
    m = _mask(length, T, B, e.device)
    ident = torch.arange(N, device=e.device)[None, :]
    with torch.no_grad():
        alpha = start[None, :] + torch.select(e, 1, 0)
        backs = []
        for t in range(1, T):
            cand = alpha[:, :, None] + pair[None, :, :]     # [B, from, to]
            back = torch.argmax(cand, 1)                    # lowest on ties
            best = torch.amax(cand, 1) + torch.select(e, 1, t)
            valid = torch.select(m, 1, t)[:, None]
            alpha = torch.where(valid, best, alpha)
            # padding steps carry an identity backpointer
            backs.append(torch.where(valid, back, ident))
        tag = torch.argmax(alpha + end[None, :], 1)
        tags = [tag]
        for back in reversed(backs):
            tag = torch.gather(back, 1, tag[:, None])[:, 0]
            tags.append(tag)
        path = torch.stack(tags[::-1], 1)
        path = torch.where(m, path, torch.zeros_like(path)).to(torch.int32)
        if label is None:
            return path.as_subclass(Tensor)
        eq = (path == _t(label).to(path.device)).to(torch.int32)
        if length is not None:
            eq = torch.where(m, eq, torch.zeros_like(eq))
        return eq.as_subclass(Tensor)
