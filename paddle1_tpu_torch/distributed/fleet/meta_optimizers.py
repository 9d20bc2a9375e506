"""Meta-optimizer composition (port of
``paddle1_tpu/distributed/fleet/meta_optimizers.py``: ``compile_strategy``,
``apply_optimizer_meta``, ``LocalSGDOptimizer``, ``DGCMomentumOptimizer``).

The reference rewrites ProgramDescs per strategy; the JAX package and the
port compile the strategy into ``ParallelEngine`` settings (mesh degrees,
ZeRO stage, gradient accumulation, AMP dtype, recompute) —
``compile_strategy`` is that mapping, the same one. LocalSGD and DGC,
which change the update rule rather than the layout, wrap an optimizer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...core.errors import InvalidArgumentError
from .strategy import DistributedStrategy

__all__ = ["compile_strategy", "apply_optimizer_meta", "LocalSGDOptimizer",
           "DGCMomentumOptimizer"]


def compile_strategy(strategy: DistributedStrategy,
                     n_devices: Optional[int] = None) -> Dict[str, Any]:
    """DistributedStrategy → ParallelEngine kwargs (the reference's
    StrategyCompiler): ``sharding`` gives the ZeRO stage over the
    ``sharding`` axis, ``gradient_merge`` ``grad_accum``,
    ``hybrid_configs``/``tensor_parallel`` the mesh degrees, ``recompute``
    the per-block recompute, ``amp`` bf16. ``n_devices`` defaults to the
    world size; the one axis the user did not pin absorbs the rest
    (``sharding`` when sharding is on without a degree, else ``dp``)."""
    from .. import collective
    conf = strategy.to_dict()
    n = n_devices if n_devices is not None else collective.get_world_size()
    hybrid = conf.get("hybrid_configs", {}) or {}
    mp = int(hybrid.get("mp_degree", 1))
    pp = int(hybrid.get("pp_degree", 1))
    dp_requested = int(hybrid.get("dp_degree", 1))
    zero_stage = 0
    sharding_requested = 1
    if conf.get("sharding"):
        sc = conf.get("sharding_configs", {}) or {}
        zero_stage = int(sc.get("stage", 2))
        sharding_requested = int(sc.get("sharding_degree", 1))
    if conf.get("tensor_parallel"):
        tc = conf.get("tensor_parallel_configs", {}) or {}
        mp = max(mp, int(tc.get("tensor_parallel_degree", 1)))
    if n % (mp * pp) != 0:
        raise InvalidArgumentError(
            f"hybrid_configs mp_degree={mp} * pp_degree={pp} does not "
            f"divide the device count {n}")
    dp = dp_requested
    sharding = sharding_requested
    fixed = mp * pp
    if dp * sharding * fixed != n:
        if zero_stage and sharding_requested <= 1:
            if n % (fixed * dp) != 0:
                raise InvalidArgumentError(
                    f"dp_degree={dp} * mp*pp={fixed} does not divide "
                    f"device count {n}")
            sharding = n // (fixed * dp)
        else:
            if n % (fixed * sharding) != 0:
                raise InvalidArgumentError(
                    f"sharding_degree={sharding} * mp*pp={fixed} does not "
                    f"divide device count {n}")
            dp = n // (fixed * sharding)
    degrees = {"dp": dp, "mp": mp, "pp": pp, "sharding": max(sharding, 1)}

    grad_accum = 1
    if conf.get("gradient_merge"):
        gm = conf.get("gradient_merge_configs", {}) or {}
        grad_accum = int(gm.get("k_steps", 1))
    # amp maps to bf16 whatever its pure/mixed mode, as in the JAX package
    amp_dtype = "bfloat16" if conf.get("amp") else None
    pp_microbatches = None
    if pp > 1 or conf.get("pipeline"):
        pc = conf.get("pipeline_configs", {}) or {}
        pp_microbatches = int(pc.get("accumulate_steps", 0)) or None
    return {"degrees": degrees, "zero_stage": zero_stage,
            "grad_accum": grad_accum,
            "amp_dtype": amp_dtype,
            "pp_microbatches": pp_microbatches,
            "recompute": bool(conf.get("recompute")),
            "train_steps_per_sync": max(
                int(conf.get("train_steps_per_sync", 1)), 1)}


def apply_optimizer_meta(optimizer, strategy: DistributedStrategy):
    """The lars/lamb rewrites: with ``strategy.lars`` a plain ``Momentum``
    becomes ``Lars`` (and ``Adam`` becomes ``Lamb`` under
    ``strategy.lamb``) over the same rate, parameters, regularization and
    clip; other optimizers pass through."""
    from ...optimizer import Adam, Lamb, Lars, Momentum
    conf = strategy.to_dict()
    if conf.get("lars") and type(optimizer) is Momentum:
        lc = conf.get("lars_configs", {}) or {}
        return Lars(learning_rate=optimizer._learning_rate,
                    momentum=optimizer._momentum,
                    parameters=optimizer._params,
                    lars_coeff=float(lc.get("lars_coeff", 0.001)),
                    lars_weight_decay=float(
                        lc.get("lars_weight_decay", 0.0005)),
                    epsilon=float(lc.get("epsilon", 1e-9)),
                    weight_decay=optimizer._weight_decay or None,
                    grad_clip=optimizer._grad_clip)
    if conf.get("lamb") and type(optimizer) is Adam:
        lc = conf.get("lamb_configs", {}) or {}
        wd = lc.get("lamb_weight_decay",
                    optimizer._weight_decay or 0.01)
        return Lamb(learning_rate=optimizer._learning_rate,
                    beta1=optimizer._beta1, beta2=optimizer._beta2,
                    epsilon=optimizer._epsilon,
                    parameters=optimizer._params,
                    lamb_weight_decay=float(wd),
                    grad_clip=optimizer._grad_clip)
    return optimizer


class _WrappedOptimizer:
    """Delegates everything to the inner optimizer, intercepts step()."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, item):
        return getattr(self._inner, item)

    @property
    def inner_opt(self):
        return self._inner


class LocalSGDOptimizer(_WrappedOptimizer):
    """LocalSGD: ``k_steps`` local updates, then the parameters averaged
    over the data-parallel ``group``."""

    def __init__(self, optimizer, k_steps: int = 4, group=None):
        super().__init__(optimizer)
        self.k_steps = max(int(k_steps), 1)
        self._group = group
        self._step_count = 0

    def step(self):
        self._inner.step()
        self._step_count += 1
        if self._step_count % self.k_steps == 0:
            self._average_params()

    @torch.no_grad()
    def _average_params(self):
        from .. import collective
        for p in self._inner._params:
            collective.all_reduce(p.data, op=collective.ReduceOp.AVG,
                                  group=self._group)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()


class DGCMomentumOptimizer(_WrappedOptimizer):
    """Deep Gradient Compression: before the update, each gradient keeps
    only its top ``sparsity`` fraction by magnitude (at least one
    element); the rest accumulates locally with momentum correction and is
    added back at the next step (error feedback). The kept gradient stays
    a dense masked tensor, as in the JAX package."""

    def __init__(self, optimizer, rampup_begin_step: int = 0,
                 sparsity: float = 0.01, momentum: float = 0.9):
        super().__init__(optimizer)
        self.sparsity = float(sparsity)
        self.momentum = float(momentum)
        self.rampup_begin_step = int(rampup_begin_step)
        self._u: Dict[int, Any] = {}   # momentum residual per param
        self._v: Dict[int, Any] = {}   # error feedback per param
        self._steps = 0

    @torch.no_grad()
    def step(self):
        self._steps += 1
        if self._steps > self.rampup_begin_step:
            for p in self._inner._params:
                if p.grad is None:
                    continue
                g = p.grad.detach()
                u = self._u.get(id(p))
                u = g.clone() if u is None else self.momentum * u + g
                v = self._v.get(id(p))
                v = u.clone() if v is None else v + u
                flat = v.abs().reshape(-1)
                k = max(1, int(flat.shape[0] * self.sparsity))
                thresh = torch.sort(flat).values[-k]
                mask = v.abs() >= thresh
                send = torch.where(mask, v, torch.zeros_like(v))
                self._v[id(p)] = torch.where(mask, torch.zeros_like(v), v)
                self._u[id(p)] = torch.where(mask, torch.zeros_like(u), u)
                p.grad = send
        self._inner.step()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()
