"""Random state (port of ``paddle1_tpu/core/generator.py``).

The JAX package hands out counter-based keys from a root seed; here every
device has one ``torch.Generator`` (``torch.default_generator`` for the
CPU, ``torch.cuda.default_generators`` for each card), which the
port's random ops and weight initializers draw from. :func:`seed` seeds
them all, :func:`get_rng_state`/:func:`set_rng_state` save and restore
them. Torch's generators give other numbers than the JAX package's keys
for the same seed: tests make their inputs with numpy and hand them to
both. The tensor-parallel ``RNGStatesTracker`` waits for model
parallelism.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state"]


def seed(seed_: int) -> torch.Generator:
    """Seed every device's generator (Paddle's ``paddle.seed``); returns
    the CPU's."""
    return torch.manual_seed(int(seed_))


def get_rng_state() -> Dict[str, object]:
    """``{"cpu": state, "cuda": [state per card]}`` (byte tensors; the
    cards' list is empty without CUDA)."""
    cuda = torch.cuda.get_rng_state_all() if torch.cuda.is_available() \
        else []
    return {"cpu": torch.get_rng_state(), "cuda": cuda}


def set_rng_state(state: Dict[str, object]) -> None:
    torch.set_rng_state(state["cpu"])
    if state.get("cuda"):
        torch.cuda.set_rng_state_all(state["cuda"])
