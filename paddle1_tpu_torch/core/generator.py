"""Random state (port of ``paddle1_tpu/core/generator.py``).

The JAX package hands out counter-based keys from a root seed; here every
device has one ``torch.Generator`` (``torch.default_generator`` for the
CPU, ``torch.cuda.default_generators`` for each card), which the
port's random ops and weight initializers draw from. :func:`seed` seeds
them all, :func:`get_rng_state`/:func:`set_rng_state` save and restore
them. Torch's generators give other numbers than the JAX package's keys
for the same seed: tests make their inputs with numpy and hand them to
both.

``RNGStatesTracker`` (``core/generator.py:130-192`` of the JAX package)
keeps named random streams for tensor parallelism: random ops on
replicated tensors draw from the default generators, seeded alike on
every rank, while those on model-parallel shards (dropout on a rank's
heads) draw inside ``get_rng_tracker().rng_state()`` from a stream seeded
per rank. A stream is a state for the CPU's generator and one for each
card's; ``rng_state`` swaps them into the device generators for the
block and back out after it, so the default streams go on where they
stopped.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from .errors import AlreadyExistsError, NotFoundError

__all__ = ["seed", "get_rng_state", "set_rng_state", "RNGStatesTracker",
           "get_rng_tracker", "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def seed(seed_: int) -> torch.Generator:
    """Seed every device's generator (Paddle's ``paddle.seed``) and drop
    the tracker's streams, as the JAX package's does; returns the
    CPU's."""
    get_rng_tracker().reset(seed_)
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


def _device_generators():
    """The generators a stream swaps: the CPU's, then each card's that
    torch has set up (a card nothing has touched keeps its own)."""
    gens = [torch.default_generator]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        gens += list(torch.cuda.default_generators)
    return gens


class RNGStatesTracker:
    """Named random streams for tensor parallelism (reference
    ``random.py:23``): ``add(name, seed)`` registers one (two streams may
    not share a name or a seed), ``rng_state(name)`` draws from it for the
    enclosed block."""

    def __init__(self):
        self._states: Dict[str, dict] = {}
        self._seeds: set = set()

    def reset(self, base_seed: Optional[int] = None) -> None:
        self._states.clear()
        self._seeds.clear()

    def add(self, name: str, seed_: int) -> None:
        if name in self._states:
            raise AlreadyExistsError(f"RNG state {name!r} already exists")
        if seed_ in self._seeds:
            raise AlreadyExistsError(f"RNG seed {seed_} already used by "
                                     "another tracked state")
        self._seeds.add(seed_)
        self._states[name] = {"seed": int(seed_), "gens": {}}

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        if name not in self._states:
            raise NotFoundError(
                f"RNG state {name!r} not registered; call add() first")
        st = self._states[name]
        gens = _device_generators()
        saved = [g.get_state() for g in gens]
        for i, g in enumerate(gens):
            if i in st["gens"]:
                g.set_state(st["gens"][i])
            else:
                g.manual_seed(st["seed"])
        try:
            yield
        finally:
            for i, (g, prev) in enumerate(zip(gens, saved)):
                st["gens"][i] = g.get_state()
                g.set_state(prev)


_tracker = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _tracker
