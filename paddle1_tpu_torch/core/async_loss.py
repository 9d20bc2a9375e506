"""Lazy loss handles (port of ``LossFuture`` from
``paddle1_tpu/core/async_loss.py``).

A training step returns its loss as a tensor still on the device; the
host reads it only when someone asks (``float()``, ``.item()``,
``.numpy()``), so the host can queue the next step while
the card runs this one. The fetched value is cached: one readback per
handle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["LossFuture"]


class LossFuture:
    """A loss value still living on the device. Reads materialize it."""

    __slots__ = ("_t", "_value")

    def __init__(self, t: torch.Tensor):
        self._t = t.detach()
        self._value: Optional[np.ndarray] = None

    @property
    def tensor(self) -> torch.Tensor:
        """The device tensor (no readback)."""
        return self._t

    def numpy(self) -> np.ndarray:
        if self._value is None:
            self._value = self._t.float().cpu().numpy()
        return self._value

    def item(self) -> float:
        return float(self.numpy().reshape(-1)[-1])

    def __float__(self) -> float:
        return self.item()

    def __repr__(self) -> str:
        state = "ready" if self._value is not None else "pending"
        return f"LossFuture({state}, device={self._t.device})"
