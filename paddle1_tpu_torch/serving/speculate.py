"""Draft proposal for speculative decoding (a copy of
``paddle1_tpu/serving/speculate.py``: host code, numpy only).

The engine verifies ``k`` proposed tokens per decode step by equality
against its own per-(seed, token index) sample schedule (see
``generate.GenerationEngine``), so a speculator is pure upside: a wrong
draft costs nothing but the wasted window width, a right one turns k+1
tokens into one step. Correctness never depends on the speculator:
output is bit-identical to non-speculative decode whatever it proposes.

:class:`NGramSpeculator` is the zero-model prompt-lookup speculator: the
draft is the continuation of the most recent earlier occurrence of the
last ``n`` tokens in the request's own history (prompt + generated),
falling back to shorter grams. :class:`DraftModelSpeculator` adapts any
greedy-decoding callable (e.g. a smaller CausalLM) to the same
``propose`` protocol.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["NGramSpeculator", "DraftModelSpeculator"]


class NGramSpeculator:
    """Prompt-lookup drafts over one request's token history.

    ``observe`` feeds every produced token (the engine feeds the prompt
    at construction and each delivered token after); ``propose``
    returns up to ``k`` draft tokens following the current history —
    the continuation found after the latest earlier occurrence of the
    trailing n-gram, trying ``n`` down to 1. Empty proposal = decode
    proceeds non-speculatively for that step.
    """

    def __init__(self, prompt: Sequence[int], k: int, n: int = 3):
        self.k = int(k)
        self.n = max(1, int(n))
        self._hist: List[int] = [int(t) for t in np.asarray(
            prompt).reshape(-1)]

    def observe(self, token: int) -> None:
        self._hist.append(int(token))

    @property
    def history(self) -> List[int]:
        return list(self._hist)

    def propose(self, k: Optional[int] = None) -> np.ndarray:
        k = self.k if k is None else min(int(k), self.k)
        h = self._hist
        if k <= 0 or len(h) < 2:
            return np.zeros([0], np.int32)
        for n in range(min(self.n, len(h) - 1), 0, -1):
            gram = h[-n:]
            # latest earlier occurrence, right to left, excluding the
            # trailing one itself; the most recent occurrence whose
            # continuation fills the whole window wins (on short-cycle
            # text every near-tail match is truncated by the tail)
            best: List[int] = []
            for s in range(len(h) - n - 1, -1, -1):
                if h[s:s + n] == gram:
                    cont = h[s + n:s + n + k]
                    if len(cont) > len(best):
                        best = cont
                        if len(best) == k:
                            return np.asarray(best, np.int32)
            if best:
                return np.asarray(best, np.int32)
        return np.zeros([0], np.int32)


class DraftModelSpeculator:
    """A small model as the draft source: ``draft_fn(history, k)`` must
    return up to ``k`` draft ints (greedy continuation of ``history``).
    Same observe/propose protocol as :class:`NGramSpeculator`."""

    def __init__(self, prompt: Sequence[int], k: int,
                 draft_fn: Callable[[List[int], int], Sequence[int]]):
        self.k = int(k)
        self._draft_fn = draft_fn
        self._hist: List[int] = [int(t) for t in np.asarray(
            prompt).reshape(-1)]

    def observe(self, token: int) -> None:
        self._hist.append(int(token))

    @property
    def history(self) -> List[int]:
        return list(self._hist)

    def propose(self, k: Optional[int] = None) -> np.ndarray:
        k = self.k if k is None else min(int(k), self.k)
        if k <= 0:
            return np.zeros([0], np.int32)
        out = np.asarray(list(self._draft_fn(list(self._hist), k)),
                         np.int32).reshape(-1)[:k]
        return out.astype(np.int32)
