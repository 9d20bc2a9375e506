"""Distributed training of the port (``paddle1_tpu.distributed``'s
collective side): the process-group environment, every collective of
``collective.py`` over ``torch.distributed``, the hybrid topology
(``build_mesh``, ``HybridCommunicateGroup``), ``DataParallel``,
``spawn`` and the launcher, ``ParallelEngine``/``make_train_step`` at any
mesh (data, ZeRO 1-3, tensor and pipeline parallelism; ``sp`` ranks
replicate the batch or cut the sequence), ``pipeline`` (``pipeline_apply``,
``stack_stage_params``), ``sequence_parallel`` (``ring_attention``,
``ulysses_attention``), ``meta_parallel`` and ``fleet``.

``checkpoint`` (``save_sharded``, ``load_sharded``,
``CheckpointManager``) saves and restores sharded state, one file a
rank. ``resilience`` and ``supervisor`` are ROADMAP Queue 1 item 6; the
parameter server and the embedding services item 8."""

from . import checkpoint  # noqa: F401
from . import env  # noqa: F401
from . import fleet  # noqa: F401
from . import meta_parallel  # noqa: F401
from . import pipeline  # noqa: F401
from . import sequence_parallel  # noqa: F401
from . import sharding_specs  # noqa: F401
from .checkpoint import (CheckpointManager, load_sharded,  # noqa: F401
                         save_sharded)
from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_gather_object, all_reduce, all_to_all,
                         alltoall, barrier, broadcast,
                         destroy_process_group, differentiable_all_reduce,
                         get_group, get_rank, get_world_size,
                         hierarchical_all_reduce, irecv, is_initialized,
                         isend, new_group, recv, reduce, reduce_scatter,
                         scatter, send, split, wait)
from .env import current_spmd_axis, spmd_axes  # noqa: F401
from .parallel import (DataParallel, ParallelEnv,  # noqa: F401
                       init_parallel_env)
from .parallel_engine import ParallelEngine, make_train_step  # noqa: F401
from .pipeline import pipeline_apply, stack_stage_params  # noqa: F401
from .sequence_parallel import (ring_attention,  # noqa: F401
                                ulysses_attention)
from .spawn import spawn  # noqa: F401
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, Mesh, MeshDescriptor,
                       ReshardError, build_mesh, ensure_reshardable,
                       get_hybrid_communicate_group, mesh_descriptor,
                       plan_resize, set_hybrid_communicate_group)


def __getattr__(name):
    # ``launch`` resolves lazily, so that ``python -m
    # paddle1_tpu_torch.distributed.launch`` does not trip runpy's
    # already-imported warning
    if name == "launch":
        import importlib
        return importlib.import_module(".launch", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
