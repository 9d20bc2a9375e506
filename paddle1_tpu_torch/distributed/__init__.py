"""Distributed training of the port (``paddle1_tpu.distributed`` subset):
the process-group environment, the collectives over
``torch.distributed``, ``DataParallel``, ``spawn``, the data-parallel
``build_mesh``, ``ParallelEngine`` (one device, or data-parallel over
a mesh) and ``fleet.utils.recompute``."""

from . import fleet  # noqa: F401
from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_reduce, barrier, broadcast,
                         destroy_process_group, differentiable_all_reduce,
                         get_group, get_rank, get_world_size,
                         is_initialized, new_group, reduce)
from .env import current_spmd_axis, spmd_axes  # noqa: F401
from .parallel import (DataParallel, ParallelEnv,  # noqa: F401
                       init_parallel_env)
from .parallel_engine import ParallelEngine  # noqa: F401
from .spawn import spawn  # noqa: F401
from .topology import Mesh, build_mesh  # noqa: F401
