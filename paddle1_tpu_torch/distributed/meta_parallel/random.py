"""Tensor-parallel random streams (port of
``paddle1_tpu/distributed/meta_parallel/random.py``): random ops on
replicated tensors draw identical values on every model-parallel rank
from the default generators, seeded alike; dropout on a rank's shard
draws inside ``get_rng_state_tracker().rng_state()`` from the
``model_parallel_rng`` stream, seeded per rank."""

from __future__ import annotations

from ...core.generator import (MODEL_PARALLEL_RNG, RNGStatesTracker,
                               get_rng_tracker, seed as _seed_all)

__all__ = ["get_rng_state_tracker", "model_parallel_random_seed",
           "RNGStatesTracker", "MODEL_PARALLEL_RNG"]


def get_rng_state_tracker() -> RNGStatesTracker:
    """The reference's spelling for the global tracker."""
    return get_rng_tracker()


def model_parallel_random_seed(seed: int = 2048) -> None:
    """Seed the replicated streams with ``seed`` and register the per-rank
    ``model_parallel_rng`` stream at ``seed + 1024 + mp_rank`` (reference
    random.py:66)."""
    from ..topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _seed_all(seed)   # also resets the tracker
    get_rng_tracker().add(MODEL_PARALLEL_RNG, seed + 1024 + rank)
