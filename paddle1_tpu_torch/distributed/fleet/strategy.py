"""DistributedStrategy — the fleet configuration surface (port of
``paddle1_tpu/distributed/fleet/strategy.py``, the same fields and
defaults).

Analog of the reference's ``DistributedStrategy`` façade
(python/paddle/distributed/fleet/base/distributed_strategy.py over the proto
paddle/fluid/framework/distributed_strategy.proto:146-196). Every toggle the
reference exposes is kept. ``compile_strategy`` turns the fields that shape
training into ``ParallelEngine`` settings; the collective transport knobs
(``fuse_all_reduce_ops``, ``nccl_comm_num``, ...) are recorded and change
nothing, as in the JAX package: the engine reduces its gradients in one
flat buffer already.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

__all__ = ["DistributedStrategy"]


_DEFAULTS: Dict[str, Any] = {
    # --- mixed precision (reference proto field amp / amp_configs) ---
    "amp": False,
    "amp_configs": {
        "init_loss_scaling": 32768.0,
        "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2,
        "incr_ratio": 2.0,
        "decr_ratio": 0.8,
        "use_dynamic_loss_scaling": True,
        "custom_white_list": [],
        "custom_black_list": [],
        "use_pure_fp16": False,
        "use_fp16_guard": True,
        "use_bf16": True,  # the JAX package's default: bf16, no loss scaling
    },
    # --- recompute ---
    "recompute": False,
    "recompute_configs": {"checkpoints": [], "enable_offload": False},
    # --- pipeline ---
    "pipeline": False,
    "pipeline_configs": {"accumulate_steps": 1, "micro_batch_size": 1,
                         "schedule_mode": "1F1B"},
    # --- tensor parallel (static-mode naming) ---
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1,
                                "tensor_init_seed": -1},
    # --- ZeRO sharding ---
    "sharding": False,
    "sharding_configs": {"sharding_degree": 1, "stage": 2,
                         "segment_broadcast_MB": 32.0,
                         "offload": False, "hybrid_dp": False},
    # --- hybrid (dygraph naming) ---
    "hybrid_configs": {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                       "sharding_degree": 1, "sep_degree": 1},
    # --- gradient merge / accumulation ---
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    # --- multi-step training: k optimizer steps a call
    #     (ParallelEngine.step_many / step_stream) ---
    "train_steps_per_sync": 1,
    # --- localsgd ---
    "localsgd": False,
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "adaptive_localsgd": False,
    "adaptive_localsgd_configs": {"init_k_steps": 1, "begin_step": 1},
    # --- large-batch optimizers ---
    "lamb": False,
    "lamb_configs": {"lamb_weight_decay": 0.01, "exclude_from_weight_decay": []},
    "lars": False,
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                     "epsilon": 0.0, "exclude_from_weight_decay": []},
    # --- gradient compression (DGCMomentumOptimizer) ---
    "dgc": False,
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1,
                    "sparsity": [0.999]},
    "fp16_allreduce": False,
    # --- collective transport knobs: recorded only ---
    "nccl_comm_num": 1,
    "use_hierarchical_allreduce": False,
    "hierarchical_allreduce_inter_nranks": 1,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "sync_nccl_allreduce": True,
    # --- batch norm ---
    "sync_batch_norm": False,
    # --- PS / async ---
    "a_sync": False,
    "a_sync_configs": {"k_steps": -1, "max_merge_var_num": 1,
                       "send_queue_size": 16, "independent_recv_thread": False,
                       "thread_pool_size": 1, "send_wait_times": 1,
                       "runtime_split_send_recv": False, "launch_barrier": True},
    # --- elastic (flag-only in the reference too, proto:157) ---
    "elastic": False,
    # --- execution ---
    "auto": False,
    "semi_auto": False,
    "without_graph_optimization": False,
}


class DistributedStrategy:
    """Attribute-style strategy bag with the reference's field set."""

    def __init__(self):
        self.__dict__["_conf"] = copy.deepcopy(_DEFAULTS)
        # flag-defaulted fields, resolved at construction (not import)
        # so set_flags before building a strategy takes effect
        from ...core import flags as core_flags
        self.__dict__["_conf"]["use_hierarchical_allreduce"] = bool(
            core_flags.flag("hierarchical_allreduce"))

    def __getattr__(self, name):
        conf = self.__dict__.get("_conf", {})
        if name in conf:
            return conf[name]
        raise AttributeError(f"DistributedStrategy has no field {name!r}")

    def __setattr__(self, name, value):
        conf = self.__dict__["_conf"]
        if name not in conf:
            raise AttributeError(f"DistributedStrategy has no field {name!r}")
        current = conf[name]
        if isinstance(current, dict) and isinstance(value, dict):
            merged = dict(current)
            merged.update(value)
            conf[name] = merged
        else:
            conf[name] = value

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._conf)

    def __repr__(self):
        on = [k for k, v in self._conf.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"
