"""The fleet façade (port of ``paddle1_tpu/distributed/fleet/fleet_base.py``,
its collective side).

``fleet.init`` joins the process group (``init_parallel_env``) and builds
the hybrid mesh from ``hybrid_configs`` (``topology.build_mesh``: the
process groups of every axis); ``distributed_model``,
``distributed_optimizer`` and ``distributed_scaler`` wrap a model, an
optimizer and a scaler for eager training on it; ``parallel_engine``
compiles the strategy into a ``ParallelEngine`` on the same mesh. The
degrees must multiply to the world size; with none given, every rank is
data-parallel. The parameter-server methods (``init_server``,
``run_server``, ``save_persistables``, ...) are ROADMAP Queue 1 item 8
and raise.
"""

from __future__ import annotations

from typing import Optional

from ...core.errors import PreconditionNotMetError, UnimplementedError
from .. import collective
from ..parallel import DataParallel, init_parallel_env
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        build_mesh, set_hybrid_communicate_group)
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase
from .strategy import DistributedStrategy

__all__ = ["Fleet", "fleet"]


def _ps(name: str):
    def method(self, *args, **kwargs):
        raise UnimplementedError(
            f"fleet.{name}: the parameter server (distributed/ps*.py) is "
            "ROADMAP Queue 1 item 8")
    method.__name__ = name
    method.__doc__ = ("Parameter-server mode: raises (ROADMAP Queue 1 "
                      "item 8).")
    return method


class Fleet:
    """The fleet singleton (reference fleet_base.py:71)."""

    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._user_defined_strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False

    def init(self, role_maker: Optional[RoleMakerBase] = None,
             is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None,
             **parallel_env) -> "Fleet":
        """Join the job and build the hybrid mesh; ``parallel_env``
        (``backend``, ``device``, ``init_method``) goes to
        ``init_parallel_env``."""
        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._user_defined_strategy = strategy or DistributedStrategy()
        init_parallel_env(**parallel_env)
        hc = self._user_defined_strategy.hybrid_configs
        n = collective.get_world_size()
        degrees = {"dp": hc.get("dp_degree", 1), "mp": hc.get("mp_degree", 1),
                   "pp": hc.get("pp_degree", 1),
                   "sharding": hc.get("sharding_degree", 1),
                   "sp": hc.get("sep_degree", 1)}
        total = 1
        for v in degrees.values():
            total *= max(1, v)
        if total == 1 and n > 1:
            degrees["dp"] = total = n   # default: every rank data-parallel
        if total != n:
            raise PreconditionNotMetError(
                f"hybrid_configs {degrees} need {total} ranks, the world "
                f"has {n}")
        topo = CommunicateTopology(
            ["pp", "dp", "sharding", "mp", "sp"],
            [degrees["pp"], degrees["dp"], degrees["sharding"],
             degrees["mp"], degrees["sp"]])
        mesh = build_mesh(**degrees)
        self._hcg = HybridCommunicateGroup(topo, mesh=mesh)
        set_hybrid_communicate_group(self._hcg)
        self._is_initialized = True
        return self

    def _ensure_init(self):
        if not self._is_initialized:
            raise PreconditionNotMetError(
                "fleet.init() must be called first")

    # -- role queries (reference fleet_base.py:340-510) ---------------------

    def is_first_worker(self) -> bool:
        self._ensure_init()
        return self._role_maker.is_first_worker()

    def worker_index(self) -> int:
        self._ensure_init()
        return self._role_maker.worker_index()

    def worker_num(self) -> int:
        self._ensure_init()
        return self._role_maker.worker_num()

    def is_worker(self) -> bool:
        self._ensure_init()
        return self._role_maker.is_worker()

    def is_server(self) -> bool:
        self._ensure_init()
        return self._role_maker.is_server()

    def worker_endpoints(self, to_string: bool = False):
        self._ensure_init()
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        self._ensure_init()
        self._role_maker._barrier()

    def init_worker(self):
        self._ensure_init()

    def stop_worker(self):
        pass

    init_server = _ps("init_server")
    run_server = _ps("run_server")
    save_persistables = _ps("save_persistables")
    load_persistables = _ps("load_persistables")
    save_inference_model = _ps("save_inference_model")

    # -- the distributed wrappers ------------------------------------------

    @property
    def _strategy(self) -> DistributedStrategy:
        return self._user_defined_strategy or DistributedStrategy()

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        self._ensure_init()
        return self._hcg

    def distributed_model(self, model):
        """Wrap ``model`` for eager training on the mesh (reference
        fleet_base.py:765): ``PipelineParallel`` where ``pp > 1`` (a
        ``PipelineLayer``, its stages run by the 1F1B schedule in this
        process), ``ModelParallel`` where ``mp > 1`` (the tagged layers
        cut to this rank's shard), else ``DataParallel`` over the data
        ranks."""
        self._ensure_init()
        hcg = self._hcg
        if hcg.get_pipe_parallel_world_size() > 1:
            from ..meta_parallel.pipeline_parallel import PipelineParallel
            return PipelineParallel(model, hcg, self._strategy)
        if hcg.get_model_parallel_world_size() > 1:
            from ..meta_parallel.model_parallel import ModelParallel
            return ModelParallel(model, hcg, self._strategy)
        fp16_comm = bool(self._strategy.fp16_allreduce)
        return DataParallel(model, group=hcg.mesh.data_group,
                            comm_dtype="bfloat16" if fp16_comm else None)

    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy] = None):
        """Reference fleet_base.py:712: the lars/lamb rewrites, then a
        ``HybridParallelOptimizer`` on the mesh."""
        self._ensure_init()
        if strategy is not None:
            self._user_defined_strategy = strategy
        from .meta_optimizers import apply_optimizer_meta
        optimizer = apply_optimizer_meta(optimizer, self._strategy)
        from ..meta_parallel.hybrid_optimizer import HybridParallelOptimizer
        return HybridParallelOptimizer(optimizer, self._hcg, self._strategy)

    def distributed_scaler(self, scaler):
        """``GradScaler`` whose ``found_inf`` is any-reduced over the
        model-parallel group."""
        self._ensure_init()
        from ..meta_parallel.hybrid_optimizer import \
            HybridParallelGradScaler
        return HybridParallelGradScaler(scaler, self._hcg)

    def parallel_engine(self, model, optimizer, loss_fn, mesh=None,
                        **overrides):
        """The strategy compiled into a ``ParallelEngine`` (the JAX
        package's fleet.minimize for compiled training):
        ``compile_strategy``'s settings, ``overrides`` on top (a
        ``batch_spec`` that cuts the sequence over ``sp`` among them), on
        ``mesh``, else on fleet's mesh where the compiled degrees are its
        degrees, else on a mesh of the compiled degrees (a collective
        call). ``hybrid_configs["sep_degree"]`` is the ``sp`` degree: the
        other axes are compiled over the world's ranks divided by it."""
        self._ensure_init()
        from .meta_optimizers import compile_strategy
        sp = max(int(self._strategy.hybrid_configs.get("sep_degree", 1)), 1)
        cfg = compile_strategy(self._strategy,
                               collective.get_world_size() // sp)
        cfg.update(overrides)
        degrees = cfg.pop("degrees", None)
        if degrees is not None and sp > 1:
            degrees = {**degrees, "sp": sp}
        if mesh is None:
            have = self._hcg.mesh
            same = degrees is None or all(
                have.shape.get(k, 1) == v for k, v in degrees.items())
            mesh = have if same else build_mesh(**degrees)
        from ..parallel_engine import ParallelEngine
        return ParallelEngine(model, optimizer, loss_fn, mesh=mesh, **cfg)

    def minimize(self, optimizer, loss=None, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        """Static-mode minimize (reference fleet_base.py:1212): delegates to
        the optimizer's ``minimize``."""
        self._ensure_init()
        if loss is not None and hasattr(optimizer, "minimize"):
            return optimizer.minimize(loss)
        return None

    @property
    def util(self):
        raise UnimplementedError(
            "fleet.util (UtilBase) is ROADMAP Queue 1 item 8")


fleet = Fleet()
