"""Optimizers (port of ``Optimizer``, ``Momentum``, ``Adam`` and ``AdamW``
from ``paddle1_tpu/optimizer/optimizer.py``).

The Paddle constructor (``learning_rate``, ``parameters``,
``weight_decay``, ``grad_clip``) over torch parameters. ``learning_rate``
is a float or an ``optimizer.lr.LRScheduler``: ``get_lr()`` reads the
scheduler's current rate, the caller (or ``ParallelEngine``, once per
step) steps it, and ``state_dict`` carries its state under
``"LR_Scheduler"``. ``grad_clip`` is a callable on ``(param, grad)``
pairs, such as ``nn.ClipGradByGlobalNorm``. Moments are f32
whatever the parameter's dtype, kept per parameter and updated IN PLACE
together with the parameter (the JAX package returns new arrays).

:meth:`Optimizer.apply` is the one update routine: the eager
:meth:`Optimizer.step` calls it with each parameter's ``.grad`` and
``distributed.ParallelEngine`` with its own gradients. ``Adam``/``AdamW``
follow ``AdamW._update`` (``optimizer.py:445-463``); under the
``fused_adam`` flag (``auto`` = CUDA parameters) every parameter goes
through ONE launch of the fused kernel per dtype group
(``ops/fused_adam.py``), otherwise the plain per-tensor update runs. The
bias corrections ``1 - beta^step`` are computed on the parameters' device
from a device step counter, so no step count is baked into a launch.
``Momentum`` follows ``Momentum._update`` (``optimizer.py:268-275``): the
JAX package has no kernel for it, so it runs as PyTorch ``_foreach``
ops, one group per device, dtype, learning-rate scale and decay.

``parameters`` may be Paddle's param groups, dicts of ``"params"`` with
an optional ``"learning_rate"`` and ``"weight_decay"``: they are
flattened as ``paddle1_tpu/optimizer/optimizer.py:58-72`` flattens them,
each group's values written into its parameters' ``optimize_attr``. The
port applies both (the rate as a ``ParamAttr`` rate, the decay in place
of the optimizer's, on the fused path through its ``(decay, scale)``
table); the JAX package records the group's ``weight_decay`` and reads
it nowhere.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.errors import InvalidArgumentError, UnimplementedError
from ..core.flags import flag_active
from ..ops import fused_adam as fadam
from .lr import LRScheduler

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW"]


def _coeff(weight_decay) -> float:
    """A weight decay as a float: None is 0, a regularizer its
    ``coeff``."""
    if weight_decay is None:
        return 0.0
    return float(getattr(weight_decay, "coeff", weight_decay))


def _flatten_groups(parameters):
    """``parameters`` as one list: Paddle's param groups (dicts of
    ``"params"`` and an optional ``"learning_rate"``/``"weight_decay"``)
    flattened, each group's values written into its parameters'
    ``optimize_attr`` (``paddle1_tpu/optimizer/optimizer.py:58-72``)."""
    parameters = list(parameters)
    if not parameters or not isinstance(parameters[0], dict):
        return parameters
    flat = []
    for group in parameters:
        for p in group["params"]:
            if not hasattr(p, "optimize_attr"):
                p.optimize_attr = {"learning_rate": 1.0}
            for key in ("learning_rate", "weight_decay"):
                if key in group:
                    p.optimize_attr[key] = group[key]
            flat.append(p)
    return flat


class Optimizer:
    """Base optimizer over ``parameters`` (a tensor listed twice, a tied
    weight, is kept once). A parameter's name is its Paddle ``name``
    (``f"{full_name}.{attr}"`` for a layer's, as in the JAX package)
    where it has one, else ``param_<i>``, which :meth:`rename` (used by
    ``ParallelEngine``) may replace. Names feed ``apply_decay_param_fun``
    and key the moments in :meth:`state_dict` as ``f"{name}__{slot}"``
    (``paddle1_tpu/optimizer/optimizer.py:211-240``); a name repeated
    within one optimizer (the JAX package's deep-copied encoder layers
    share their first layer's names) keys its k-th repeat
    ``f"{name}_{k}"``, so no moment is lost.

    Each parameter's ``ParamAttr`` fields take part as in
    ``optimizer.py:140-172``: the rate is ``lr *
    p.optimize_attr["learning_rate"]`` (which scales AdamW's decoupled
    decay too), ``p.regularizer(p)`` is added to the gradient after the
    clip, a parameter with ``need_clip=False`` passes the clip, and one
    that is not trainable is not updated. ``multi_precision`` is taken
    as the reference takes it: every slot is f32 whatever the parameter's
    dtype, which is what it asks for; so is ``name``."""

    _slot_names: Tuple[str, ...] = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay: Optional[float] = None,
                 grad_clip: Optional[Callable] = None, name=None,
                 multi_precision: bool = False):
        self._params: List[torch.Tensor] = []
        self._names: List[str] = []
        if parameters is not None:
            seen = set()
            for p in _flatten_groups(parameters):
                if id(p) in seen:
                    continue
                seen.add(id(p))
                self._params.append(p)
                self._names.append(f"param_{len(self._names)}")
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) else \
            float(learning_rate)
        self._weight_decay = _coeff(weight_decay)
        self._grad_clip = grad_clip
        self._slots: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        self._step_t: Optional[torch.Tensor] = None   # device step counter

    # -- learning rate ------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise InvalidArgumentError(
                "Cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- parameters ---------------------------------------------------------

    def rename(self, names: Dict[int, str]) -> None:
        """Name the parameters that have no Paddle name, by identity
        (``{id(param): name}``)."""
        self._names = [names.get(id(p), n)
                       for p, n in zip(self._params, self._names)]

    def param_names(self) -> List[str]:
        """Each parameter's name, in order (see the class)."""
        return [getattr(p, "name", None) or n
                for p, n in zip(self._params, self._names)]

    def _state_keys(self) -> List[str]:
        """The names that key the moments: each parameter's name, its
        k-th repeat ``f"{name}_{k}"``."""
        seen: Dict[str, int] = {}
        keys = []
        for n in self.param_names():
            k = seen.get(n, 0)
            seen[n] = k + 1
            keys.append(n if k == 0 else f"{n}_{k}")
        return keys

    def _slots_for(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        s = self._slots.get(id(p))
        if s is None:
            s = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n in self._slot_names}
            self._slots[id(p)] = s
        return s

    # -- steps --------------------------------------------------------------

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a ``.grad`` and does
        not stop gradients (one frozen after its gradient landed keeps its
        value, as in ``paddle1_tpu/optimizer/optimizer.py:140-141``). Paddle
        tensors (``core/tensor.py``, a ``torch.Tensor`` subclass) are read
        as plain tensors here, so the update pays no re-wrapping per op or
        attribute."""
        with torch._C.DisableTorchFunctionSubclass():
            pg = [(p, p.grad) for p in self._params
                  if p.grad is not None and p.requires_grad]
            self.apply([p for p, _ in pg], [g for _, g in pg])

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor],
              lr: Optional[float] = None) -> None:
        """Update ``params`` in place from ``grads`` (one per parameter,
        any float dtype): the clip, then each parameter's regularizer, then
        the rule at each parameter's rate."""
        if self._grad_clip is not None:
            pairs = self._grad_clip(list(zip(params, grads)))
            params, grads = [p for p, _ in pairs], [g for _, g in pairs]
        grads = [g if getattr(p, "regularizer", None) is None else
                 g + p.regularizer(p).to(g.dtype)
                 for p, g in zip(params, grads)]
        self._step_count += 1
        self._update(list(params), list(grads),
                     self.get_lr() if lr is None else float(lr))

    @staticmethod
    def _lr_scale(p) -> float:
        """``ParamAttr(learning_rate=...)``'s factor of one parameter (or
        its param group's ``learning_rate``)."""
        attr = getattr(p, "optimize_attr", None)
        return 1.0 if not attr else float(attr.get("learning_rate", 1.0))

    def _l2(self, p) -> float:
        """The L2 coefficient of one parameter: its param group's
        ``weight_decay`` where it has one, else the optimizer's."""
        attr = getattr(p, "optimize_attr", None)
        if attr and "weight_decay" in attr:
            return _coeff(attr["weight_decay"])
        return self._weight_decay

    def _update(self, params, grads, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict ---------------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """``{"step": n, "<name>__<slot>": tensor}`` (moments, copied),
        plus ``"LR_Scheduler"``: the scheduler's state, when there is
        one. ``n`` is the device step counter where there is one (a step
        ``ParallelEngine(check_finite=True)`` skipped does not count)."""
        step = self._step_count if self._step_t is None else \
            int(self._step_t.item())
        out: Dict[str, object] = {"step": step}
        for p, name in zip(self._params, self._state_keys()):
            s = self._slots.get(id(p))
            for slot, t in (s or {}).items():
                out[f"{name}__{slot}"] = t.detach().clone()
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state: Dict[str, object]) -> None:
        self._step_count = int(state.get("step", 0))
        self._step_t = None
        if isinstance(self._learning_rate, LRScheduler) and \
                "LR_Scheduler" in state:
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for p, name in zip(self._params, self._state_keys()):
            for slot in self._slot_names:
                v = state.get(f"{name}__{slot}")
                if v is not None:
                    self._slots_for(p)[slot].copy_(
                        torch.as_tensor(v).to(torch.float32))


class Momentum(Optimizer):
    """Heavy-ball momentum: ``v = momentum * v + g``, then
    ``p -= lr * v`` (or, with ``use_nesterov``, ``p -= lr * (g +
    momentum * v)``); ``weight_decay`` is an L2 term added to the
    gradient first (a param group's own where it has one). The velocity
    is f32."""

    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 parameters=None, use_nesterov: bool = False,
                 weight_decay: Optional[float] = None,
                 grad_clip: Optional[Callable] = None,
                 multi_precision: bool = False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _update(self, params, grads, lr):
        groups: Dict[Tuple[torch.device, torch.dtype, float, float],
                     list] = {}
        for p, g in zip(params, grads):
            groups.setdefault((p.device, p.dtype, self._lr_scale(p),
                               self._l2(p)), []).append((p, g))
        for (_, dtype, scale, wd), pgs in groups.items():
            ps = [p for p, _ in pgs]
            gs = [g.to(dtype) for _, g in pgs]
            if wd:
                gs = torch._foreach_add(gs, ps, alpha=wd)
            vs = [self._slots_for(p)["velocity"] for p in ps]
            torch._foreach_mul_(vs, self._momentum)
            torch._foreach_add_(vs, [g.float() for g in gs])
            step = vs if dtype == torch.float32 else \
                [v.to(dtype) for v in vs]
            if self._nesterov:
                step = torch._foreach_add(gs, step, alpha=self._momentum)
            torch._foreach_add_(ps, step, alpha=-lr * scale)


class Adam(Optimizer):
    """Adam, bias-corrected, f32 moments even for bf16 parameters (the
    reference's multi-precision semantics whatever ``multi_precision``
    says, as there); ``weight_decay`` is an L2 term added to the
    gradient. ``lazy_mode`` (sparse rows) is not ported and raises."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: Optional[float] = None,
                 grad_clip: Optional[Callable] = None,
                 lazy_mode: bool = False, multi_precision: bool = False,
                 name=None):
        if lazy_mode:
            raise UnimplementedError(
                f"{type(self).__name__}: lazy_mode is not ported "
                "(ROADMAP Queue 1 item 8)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _decay(self, name: str, p=None) -> float:
        """The decoupled decay coefficient of the parameter ``p`` named
        ``name`` (0 for Adam)."""
        return 0.0

    def _scalars(self, device, lr: float) -> torch.Tensor:
        """``[lr, 1 - beta1^step, 1 - beta2^step]`` (f32) on ``device``,
        from a step counter that lives there."""
        if self._step_t is None or self._step_t.device != device:
            self._step_t = torch.full((), float(self._step_count - 1),
                                      dtype=torch.float32, device=device)
        self._step_t += 1.0
        bc1 = 1.0 - torch.pow(self._beta1, self._step_t)
        bc2 = 1.0 - torch.pow(self._beta2, self._step_t)
        lr_t = torch.full((), lr, dtype=torch.float32, device=device)
        return torch.stack([lr_t, bc1, bc2])

    def _update(self, params, grads, lr):
        names = {id(p): n for p, n in zip(self._params, self.param_names())}
        groups: Dict[Tuple[torch.device, torch.dtype], list] = {}
        for p, g in zip(params, grads):
            groups.setdefault((p.device, p.dtype), []).append((p, g))
        scalars = {}
        for (dev, _), pgs in groups.items():
            if dev not in scalars:
                scalars[dev] = self._scalars(dev, lr)
            ps, gs, m1s, m2s, decays, scales = [], [], [], [], [], []
            for p, g in pgs:
                s = self._slots_for(p)
                g = g.to(p.dtype)
                wd = self._l2(p)
                if wd:   # L2 into the gradient (Adam)
                    g = g + wd * p
                ps.append(p)
                gs.append(g.contiguous())
                m1s.append(s["moment1"])
                m2s.append(s["moment2"])
                decays.append(self._decay(names.get(id(p), ""), p))
                scales.append(self._lr_scale(p))
            if flag_active("fused_adam", dev):
                fadam.fused_adam_(ps, gs, m1s, m2s, scalars[dev], decays,
                                  self._beta1, self._beta2, self._epsilon,
                                  scales)
                continue
            lr_t, bc1, bc2 = scalars[dev][0], scalars[dev][1], scalars[dev][2]
            for p, g, a, b, d, sc in zip(ps, gs, m1s, m2s, decays, scales):
                new_p, new_a, new_b = fadam.fused_adam_ref(
                    p, g, a, b, lr_t, bc1, bc2, d, self._beta1, self._beta2,
                    self._epsilon, sc)
                p.copy_(new_p)
                a.copy_(new_a)
                b.copy_(new_b)


class AdamW(Adam):
    """Adam with decoupled weight decay: the parameter is scaled by
    ``1 - lr * weight_decay`` before the Adam step (``lr`` the
    parameter's own rate); parameters whose name ``apply_decay_param_fun``
    rejects are not decayed, in the eager step and under
    ``ParallelEngine`` alike; a param group's ``weight_decay`` replaces
    ``weight_decay`` for its parameters. ``lr_ratio`` (a function of a
    parameter giving a factor of its rate) is taken and not applied, as
    the JAX package takes it
    (``paddle1_tpu/optimizer/optimizer.py:434-443``); Paddle's reference
    applies it (ROADMAP)."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: float = 0.01,
                 grad_clip: Optional[Callable] = None,
                 lr_ratio: Optional[Callable] = None,
                 apply_decay_param_fun: Optional[Callable[[str], bool]]
                 = None, multi_precision: bool = False,
                 lazy_mode: bool = False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = _coeff(weight_decay)
        self._apply_decay_fn = apply_decay_param_fun

    def _l2(self, p) -> float:
        return 0.0   # AdamW's decay is decoupled (:meth:`_decay`)

    def _decay(self, name: str, p=None) -> float:
        if self._apply_decay_fn is not None and \
                not self._apply_decay_fn(name):
            return 0.0
        attr = getattr(p, "optimize_attr", None)
        if attr and "weight_decay" in attr:
            return _coeff(attr["weight_decay"])
        return self._coeff
