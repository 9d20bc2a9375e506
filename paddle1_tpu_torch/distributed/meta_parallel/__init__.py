"""Hybrid-parallel building blocks (port of
``paddle1_tpu/distributed/meta_parallel/``: the tensor-parallel layers,
``ModelParallel``, the hybrid optimizer and scaler, and the RNG tracker).
The pipeline-parallel ones (``LayerDesc``, ``PipelineLayer``,
``PipelineParallel``, ...) are ROADMAP Queue 1 item 5(iii)."""

from .hybrid_optimizer import (HybridParallelGradScaler,  # noqa: F401
                               HybridParallelOptimizer)
from .model_parallel import ModelParallel  # noqa: F401
from .mp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding, shard_tagged_layers)
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "ModelParallel", "HybridParallelOptimizer",
           "HybridParallelGradScaler", "get_rng_state_tracker",
           "model_parallel_random_seed", "RNGStatesTracker",
           "shard_tagged_layers"]
