"""``distributed.fleet`` of the port (``paddle1_tpu.distributed.fleet``'s
collective side):

    import paddle1_tpu_torch.distributed.fleet as fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    # or compiled: engine = fleet.parallel_engine(model, opt, loss_fn)

The parameter-server trainers (``MultiTrainer``, ``ProcessMultiTrainer``,
the workers and descriptors), ``data_generator``, the file datasets and
``UtilBase``/``fleet_util`` are ROADMAP Queue 1 items 8 and 10.
"""

from . import utils  # noqa: F401
from ..meta_parallel import (ColumnParallelLinear,  # noqa: F401
                             LayerDesc, ParallelCrossEntropy, PipelineLayer,
                             RowParallelLinear, SegmentLayers,
                             SharedLayerDesc, VocabParallelEmbedding)
from ..topology import (CommunicateTopology,  # noqa: F401
                        HybridCommunicateGroup)
from .fleet_base import Fleet, fleet  # noqa: F401
from .meta_optimizers import (DGCMomentumOptimizer,  # noqa: F401
                              LocalSGDOptimizer, compile_strategy)
from .role_maker import (PaddleCloudRoleMaker, Role,  # noqa: F401
                         UserDefinedRoleMaker)
from .strategy import DistributedStrategy  # noqa: F401
from .utils import recompute  # noqa: F401

# module-level delegation to the singleton (the reference exposes
# fleet.init etc. as module functions)
init = fleet.init
parallel_engine = fleet.parallel_engine
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
distributed_scaler = fleet.distributed_scaler
minimize = fleet.minimize
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
is_server = fleet.is_server
worker_endpoints = fleet.worker_endpoints
barrier_worker = fleet.barrier_worker
init_worker = fleet.init_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_worker = fleet.stop_worker
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group

__all__ = ["DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "Role", "Fleet", "fleet", "init",
           "distributed_model", "distributed_optimizer", "minimize",
           "recompute", "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "LayerDesc",
           "SharedLayerDesc", "PipelineLayer", "SegmentLayers"]
