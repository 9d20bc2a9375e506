"""Lazy loss handles (port of ``LossFuture`` and ``StepFuture`` from
``paddle1_tpu/core/async_loss.py``).

A training step returns its loss as a tensor still on the device; the
host reads it only when someone asks (``float()``, ``.item()``,
``.numpy()``, ``np.asarray``, formatting, comparisons), so the host can
queue the next step while the card runs this one. Each handle reads back
at most once (one ``.cpu()``), and every readback adds one to a module
counter (:func:`readback_count`), the test hook for "no readback per
step". ``block()`` waits for the step to finish on the card without a
readback: a handle made from a CUDA tensor records a CUDA event when it
is made, and ``block()`` waits on that event.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["LossFuture", "StepFuture", "readback_count",
           "reset_readback_count", "set_readback_observer"]

_lock = threading.Lock()
_readbacks = 0
# optional duration hook (seconds per readback); None keeps the fetch
# path free of even a perf_counter
_observer: Optional[Callable[[float], None]] = None


def set_readback_observer(fn: Optional[Callable[[float], None]]) -> None:
    """Install (or clear, with None) a callable receiving each readback's
    duration in seconds."""
    global _observer
    _observer = fn


def readback_count() -> int:
    """Total device→host readbacks of loss handles (test hook)."""
    return _readbacks


def reset_readback_count() -> None:
    global _readbacks
    with _lock:
        _readbacks = 0


def _read(t: torch.Tensor) -> np.ndarray:
    """One counted readback of ``t`` (as f32 numpy)."""
    global _readbacks
    obs = _observer
    t0 = time.perf_counter() if obs is not None else 0.0
    out = t.detach().float().cpu().numpy()
    with _lock:
        _readbacks += 1
    if obs is not None:
        obs(time.perf_counter() - t0)
    return out


class LossFuture:
    """A loss still living on the device. Reads materialize it.

    A scalar loss behaves like a float wherever one is expected
    (``float()``, ``f"{loss:.4f}"``, numpy coercion, ``<``, ``+``).
    ``ParallelEngine.step_many`` returns one handle over the ``[k]``
    losses: ``np.asarray(fut)`` gives all k in one readback."""

    __slots__ = ("_t", "_result", "_event")

    def __init__(self, t: torch.Tensor):
        self._t = t.detach()
        self._result: Optional[np.ndarray] = None
        self._event = None
        if self._t.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    # -- device side --------------------------------------------------------

    @property
    def tensor(self) -> torch.Tensor:
        """The device tensor (no readback)."""
        return self._t

    data = tensor

    def block(self) -> "LossFuture":
        """Wait until the step that made this loss has finished on the
        card, without a readback."""
        if self._result is None and self._event is not None:
            self._event.synchronize()
        return self

    @property
    def materialized(self) -> bool:
        return self._result is not None

    # -- host reads (one readback per handle) --------------------------------

    def numpy(self) -> np.ndarray:
        if self._result is None:
            self._result = _read(self._t)
        return self._result

    def item(self) -> float:
        a = self.numpy()
        return float(np.ravel(a)[0]) if a.size == 1 else a.item()

    def __float__(self) -> float:
        return self.item()

    def __int__(self) -> int:
        return int(self.item())

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    # the numeric protocol of a float return (`if loss < best:`,
    # `total += loss`): each reads back through item()

    def __lt__(self, other):
        return self.item() < other

    def __le__(self, other):
        return self.item() <= other

    def __gt__(self, other):
        return self.item() > other

    def __ge__(self, other):
        return self.item() >= other

    def __eq__(self, other):
        if isinstance(other, LossFuture):
            other = other.item()
        return self.item() == other

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = object.__hash__

    def __add__(self, other):
        return self.item() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.item() - other

    def __rsub__(self, other):
        return other - self.item()

    def __mul__(self, other):
        return self.item() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.item() / other

    def __rtruediv__(self, other):
        return other / self.item()

    def __neg__(self):
        return -self.item()

    def __abs__(self):
        return abs(self.item())

    def __format__(self, spec: str) -> str:
        a = self.numpy()
        if a.size == 1:
            return format(float(np.ravel(a)[0]), spec)
        return format(a, spec)

    def __repr__(self) -> str:
        if self._result is not None:
            return f"LossFuture({self._result!r})"
        return f"LossFuture(<pending on {self._t.device}>)"

    def __len__(self):
        return len(self.numpy())

    def __iter__(self):
        return iter(self.numpy())


class StepFuture(LossFuture):
    """A :class:`LossFuture` over packed ``[..., 2]`` ``[loss, notfinite]``
    pairs, what a ``check_finite`` engine step returns. One readback
    gives both columns; the float/format/numpy protocol sees the loss
    column only, and :attr:`bad`, :meth:`bad_count` and :meth:`bad_mask`
    the flag."""

    __slots__ = ("_raw",)

    def __init__(self, packed: torch.Tensor):
        super().__init__(packed)
        self._raw: Optional[np.ndarray] = None

    def _fetch(self) -> np.ndarray:
        if self._raw is None:
            self._raw = _read(self._t)
        return self._raw

    def numpy(self) -> np.ndarray:
        if self._result is None:
            self._result = np.asarray(self._fetch()[..., 0])
        return self._result

    def bad_mask(self) -> np.ndarray:
        """Per-step non-finite flags (bool; 0-d for one step, ``[k]`` for
        a ``step_many`` chunk)."""
        return np.asarray(self._fetch()[..., 1] > 0)

    def bad_count(self) -> int:
        return int(np.sum(self.bad_mask()))

    @property
    def bad(self) -> bool:
        """True when a step of this dispatch saw a non-finite loss or
        gradient (its update was skipped on the device)."""
        return bool(np.any(self.bad_mask()))
