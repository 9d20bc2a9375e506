"""``HybridParallelOptimizer`` and ``HybridParallelGradScaler`` (port of
``paddle1_tpu/distributed/meta_parallel/hybrid_optimizer.py``).

The optimizer wraps the inner one so that the ranks of a tensor-parallel
model stay one model: before the update, the gradient of every parameter
that is replicated over the model-parallel group (LayerNorms, biases of
row-parallel layers) is averaged over that group, and a
``ClipGradByGlobalNorm`` takes its norm over the whole model, each
model-parallel shard once and each replicated parameter once. The data
parallel average is ``DataParallel``'s (``fleet.distributed_model``). The
scaler any-reduces ``found_inf`` over the model-parallel group, so every
rank skips the same steps.
"""

from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm
from ..collective import ReduceOp, all_reduce

__all__ = ["HybridParallelOptimizer", "HybridParallelGradScaler"]


def _mp_sharded(p) -> bool:
    return "mp" in tuple(getattr(p, "sharding_axes", None) or ())


class _HybridGlobalNorm:
    """``ClipGradByGlobalNorm`` over a tensor-parallel model: the squared
    norms of the shards summed over the model-parallel group, the
    replicated parameters' counted once."""

    def __init__(self, inner: ClipGradByGlobalNorm, group):
        self._inner, self._group = inner, group

    def __call__(self, params_grads):
        from ...nn.clip import _clipped
        idx = [i for i, (p, g) in enumerate(params_grads) if _clipped(p, g)]
        if not idx:
            return params_grads
        dev = params_grads[idx[0]][1].device
        shard = torch.zeros((), dtype=torch.float32, device=dev)
        repl = torch.zeros((), dtype=torch.float32, device=dev)
        for i in idx:
            p, g = params_grads[i]
            sq = torch.sum(g.float() ** 2)
            if _mp_sharded(p):
                shard = shard + sq
            else:
                repl = repl + sq
        all_reduce(shard, ReduceOp.SUM, self._group)
        norm = torch.sqrt(shard + repl)
        scale = torch.clamp(self._inner.clip_norm /
                            torch.clamp(norm, min=1e-12), max=1.0)
        out = list(params_grads)
        for i in idx:
            p, g = params_grads[i]
            out[i] = (p, g * scale.to(g.dtype))
        return out


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._sharding_enabled = bool(
            strategy is not None and
            (strategy.sharding or
             hcg.get_sharding_parallel_world_size() > 1))
        mp = hcg.get_model_parallel_group()
        if mp.nranks > 1 and isinstance(optimizer._grad_clip,
                                        ClipGradByGlobalNorm):
            optimizer._grad_clip = _HybridGlobalNorm(optimizer._grad_clip,
                                                     mp)

    @property
    def inner_opt(self):
        return self._inner_opt

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @torch.no_grad()
    def step(self):
        mp = self._hcg.get_model_parallel_group()
        if mp.nranks > 1:
            for p in self._inner_opt._params:
                if p.grad is not None and not _mp_sharded(p):
                    all_reduce(p.grad, ReduceOp.AVG, mp)
        return self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._inner_opt._params]

    def clear_grad(self, set_to_zero: bool = False):
        return self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)


class HybridParallelGradScaler:
    """Wraps ``amp.GradScaler``: ``found_inf`` is any-reduced across the
    model-parallel group, so every rank makes the same skip decision."""

    def __init__(self, scaler, hcg):
        self._scaler = scaler
        self._hcg = hcg

    def _sync_found_inf(self):
        mp = self._hcg.get_model_parallel_group()
        if mp.nranks > 1:
            import torch.distributed as dist
            nccl = mp.process_group is not None and \
                dist.get_backend(mp.process_group) == "nccl"
            flag = torch.tensor(1.0 if self._scaler._found_inf else 0.0,
                                device="cuda" if nccl else "cpu")
            all_reduce(flag, ReduceOp.MAX, mp)
            self._scaler._found_inf = bool(float(flag) > 0)

    def unscale_(self, optimizer):
        out = self._scaler.unscale_(optimizer)
        self._sync_found_inf()
        return out

    def step(self, optimizer):
        self._scaler.unscale_(optimizer)
        self._sync_found_inf()
        return self._scaler.step(optimizer)

    def __getattr__(self, item):
        return getattr(self._scaler, item)
