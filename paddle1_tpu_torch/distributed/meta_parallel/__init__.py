"""Hybrid-parallel building blocks (port of
``paddle1_tpu/distributed/meta_parallel/``: the tensor-parallel layers,
the pipeline layers, ``ModelParallel`` and ``PipelineParallel``, the
hybrid optimizer and scaler, and the RNG tracker)."""

from .hybrid_optimizer import (HybridParallelGradScaler,  # noqa: F401
                               HybridParallelOptimizer)
from .model_parallel import ModelParallel  # noqa: F401
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .pp_layers import (LayerDesc, PipelineLayer,  # noqa: F401
                        SegmentLayers, SharedLayerDesc)
from .mp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding, shard_tagged_layers)
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "LayerDesc",
           "SharedLayerDesc", "PipelineLayer", "SegmentLayers",
           "ModelParallel", "PipelineParallel", "HybridParallelOptimizer",
           "HybridParallelGradScaler", "get_rng_state_tracker",
           "model_parallel_random_seed", "RNGStatesTracker",
           "shard_tagged_layers"]
