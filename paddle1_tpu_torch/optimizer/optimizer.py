"""Optimizers (port of every optimizer of
``paddle1_tpu/optimizer/optimizer.py``: ``Optimizer``, ``SGD``, ``Momentum``,
``Lars``, ``Ftrl``, ``Adagrad``, ``Adam``, ``AdamW``, ``Adamax``,
``AdaDelta``, ``RMSProp`` and ``Lamb``).

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
ops, one group per device, dtype, learning-rate scale and decay
(:meth:`Optimizer._groups`). So do the others, each after its
``_update`` of ``optimizer.py``: their slots are f32 and their
arithmetic f32 whatever the parameter's dtype, a bf16 parameter written
back rounded (the JAX package computes theirs in the parameter's dtype,
which is the same for f32 parameters). :meth:`Optimizer.minimize` is ``backward`` then
:meth:`~Optimizer.step`; :meth:`~Optimizer.functional_init` and
:meth:`~Optimizer.functional_update` are the JAX package's pure
functions over ``{name: tensor}`` dicts (``optimizer.py:192-208``): the
same rule on copies, with no clip, regularizer or per-parameter rate, as
there.

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

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.errors import InvalidArgumentError, UnimplementedError
from ..core.flags import flag_active
from ..ops import fused_adam as fadam
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "AdaDelta", "RMSProp", "Lamb", "Lars", "Ftrl"]


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

    def _slot_init(self, slot: str) -> float:
        """The value a new slot starts from."""
        return 0.0

    def _slots_for(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        s = self._slots.get(id(p))
        if s is None:
            s = {n: torch.full(p.shape, self._slot_init(n),
                               dtype=torch.float32, device=p.device)
                 for n in self._slot_names}
            self._slots[id(p)] = s
        return s

    def _groups(self, params, grads, decay=None):
        """The parameters by device, dtype, learning-rate scale and L2
        coefficient (and ``decay(p)`` where given): ``(scale, params, f32
        params, f32 gradients with the L2 term added, decay)`` per group.
        The f32 parameters are the parameters themselves where they are
        f32, else copies that :meth:`_write_back` stores."""
        groups: Dict[tuple, list] = {}
        for p, g in zip(params, grads):
            key = (p.device, p.dtype, self._lr_scale(p), self._l2(p),
                   None if decay is None else decay(p))
            groups.setdefault(key, []).append((p, g))
        for (_, dtype, scale, wd, dec), pgs in groups.items():
            ps = [p for p, _ in pgs]
            pf = ps if dtype == torch.float32 else [p.float() for p in ps]
            gs = [g.float() for _, g in pgs]   # read, never written
            if wd:
                gs = torch._foreach_add(gs, pf, alpha=wd)
            yield scale, ps, pf, gs, dec

    @staticmethod
    def _write_back(ps, pf) -> None:
        if pf is not ps:
            for p, q in zip(ps, pf):
                p.copy_(q)

    def _slot_lists(self, ps, *slots) -> List[List[torch.Tensor]]:
        """Each named slot of ``ps``, one list a slot."""
        return [[self._slots_for(p)[n] for p in ps] for n in slots]

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

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then :meth:`step`; returns ``(None,
        [(param, grad)])`` (``optimizer.py:183-188``)."""
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._params]

    # -- functional path ----------------------------------------------------

    def functional_init(self, params: Dict[str, torch.Tensor]):
        """``({name: {slot: f32 tensor}}, step 0)`` for a dict of tensors,
        each slot at the value :meth:`step` starts it from (the JAX
        package starts every slot at 0 here, ``Adagrad``'s
        ``initial_accumulator_value`` included)."""
        return ({k: {n: torch.full(v.shape, self._slot_init(n),
                                   dtype=torch.float32, device=v.device)
                     for n in self._slot_names} for k, v in params.items()},
                torch.zeros((), dtype=torch.int32))

    @torch.no_grad()
    def functional_update(self, params, grads, opt_state, lr):
        """Pure: ``(params, grads, (slots, step), lr) -> (new params,
        (new slots, step + 1))``, dicts of tensors by name. The update
        rule of :meth:`step` on copies (the inputs are not written), with
        no clip, regularizer or per-parameter rate; the names feed
        ``apply_decay_param_fun``. It runs on a shallow copy of this
        optimizer that holds the copies, so this optimizer's own
        parameters, slots and step are neither read nor written."""
        slots, step = opt_state
        step = step + 1
        new_params = {k: v.detach().clone() for k, v in params.items()}
        new_slots = {k: {n: t.detach().clone() for n, t in slots[k].items()}
                     for k in params}
        run = copy.copy(self)
        run._params = list(new_params.values())
        run._names = list(new_params)
        run._slots = {id(new_params[k]): new_slots[k] for k in params}
        run._step_count, run._step_t = int(step), None
        run._update(run._params,
                    [grads[k].to(v.dtype) for k, v in params.items()],
                    float(lr))
        return new_params, (new_slots, step)

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
    and the arithmetic are f32; a bf16 parameter is written back
    rounded."""

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
        for scale, ps, pf, gs, _ in self._groups(params, grads):
            vs, = self._slot_lists(ps, "velocity")
            torch._foreach_mul_(vs, self._momentum)
            torch._foreach_add_(vs, gs)
            step = torch._foreach_add(gs, vs, alpha=self._momentum) \
                if self._nesterov else vs
            torch._foreach_add_(pf, step, alpha=-lr * scale)
            self._write_back(ps, pf)


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


class SGD(Optimizer):
    """``p -= lr * g``, ``weight_decay`` an L2 term added to the gradient
    (``optimizer.py:247-255``)."""

    def _update(self, params, grads, lr):
        for scale, ps, pf, gs, _ in self._groups(params, grads):
            torch._foreach_add_(pf, gs, alpha=-lr * scale)
            self._write_back(ps, pf)


class Lars(Momentum):
    """LARS (``optimizer.py:278-309``): the momentum step at a layer-wise
    rate ``lars_coeff * |p| / (|g| + lars_weight_decay * |p| + epsilon)``
    (1 unless ``lars_weight_decay`` and both norms are positive) on ``g +
    lars_weight_decay * p``, ``weight_decay`` added to ``g`` first.
    ``exclude_from_weight_decay`` is taken and not read, as in the JAX
    package."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=1e-9,
                 weight_decay=None, grad_clip=None,
                 exclude_from_weight_decay=None, name=None):
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip)
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._epsilon = float(epsilon)

    def _update(self, params, grads, lr):
        for scale, ps, pf, gs, _ in self._groups(params, grads):
            vs, = self._slot_lists(ps, "velocity")
            pn = torch.stack(torch._foreach_norm(pf))
            gn = torch.stack(torch._foreach_norm(gs))
            adaptive = (pn > 0) & (gn > 0) if self._lars_wd > 0 else \
                torch.zeros_like(pn, dtype=torch.bool)
            local = torch.where(
                adaptive, self._lars_coeff * pn /
                (gn + self._lars_wd * pn + self._epsilon),
                torch.ones_like(pn))
            d = torch._foreach_add(gs, pf, alpha=self._lars_wd)
            torch._foreach_mul_(d, list(torch.unbind(lr * scale * local)))
            torch._foreach_mul_(vs, self._momentum)
            torch._foreach_add_(vs, d)
            torch._foreach_sub_(pf, vs)
            self._write_back(ps, pf)


class Ftrl(Optimizer):
    """FTRL-proximal (``optimizer.py:312-344``): the squared-gradient and
    linear accumulators, L1 shrinkage; ``l1`` and ``l2`` get the
    reference kernel's 1e-10 added."""

    _slot_names = ("squared", "linear")

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._ftrl_l1 = float(l1) + 1e-10
        self._ftrl_l2 = float(l2) + 1e-10
        self._lr_power = float(lr_power)

    def _update(self, params, grads, lr):
        l1, l2, power = self._ftrl_l1, self._ftrl_l2, self._lr_power
        for scale, ps, pf, gs, _ in self._groups(params, grads):
            lr_p = lr * scale
            sq, lin = self._slot_lists(ps, "squared", "linear")
            new_sq = torch._foreach_addcmul(sq, gs, gs)
            if power == -0.5:
                a, b = torch._foreach_sqrt(new_sq), torch._foreach_sqrt(sq)
            else:
                a = torch._foreach_pow(new_sq, -power)
                b = torch._foreach_pow(sq, -power)
            sigma = torch._foreach_div(torch._foreach_sub(a, b), lr_p)
            y = torch._foreach_add(torch._foreach_div(a, lr_p), 2.0 * l2)
            torch._foreach_add_(lin, gs)
            torch._foreach_sub_(lin, torch._foreach_mul(sigma, pf))
            for p, s_, n_, l_, y_ in zip(pf, sq, new_sq, lin, y):
                x = l1 * torch.sign(l_) - l_
                p.copy_(torch.where(torch.abs(l_) > l1, x / y_,
                                    torch.zeros_like(x)))
                s_.copy_(n_)
            self._write_back(ps, pf)


class Adagrad(Optimizer):
    """``m += g^2``, ``p -= lr * g / (sqrt(m) + epsilon)``; ``m`` starts
    at ``initial_accumulator_value`` (``optimizer.py:347-365``)."""

    _slot_names = ("moment",)

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _slot_init(self, slot):
        return self._init_acc

    def _update(self, params, grads, lr):
        for scale, ps, pf, gs, _ in self._groups(params, grads):
            ms, = self._slot_lists(ps, "moment")
            torch._foreach_addcmul_(ms, gs, gs)
            den = torch._foreach_sqrt(ms)
            torch._foreach_add_(den, self._epsilon)
            torch._foreach_addcdiv_(pf, gs, den, value=-lr * scale)
            self._write_back(ps, pf)


class Adamax(Optimizer):
    """Adam with the infinity norm (``optimizer.py:475-490``): ``u =
    max(beta2 * u, |g|)``, ``p -= lr / (1 - beta1^t) * m / (u +
    epsilon)``."""

    _slot_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _update(self, params, grads, lr):
        b1, b2 = self._beta1, self._beta2
        for scale, ps, pf, gs, _ in self._groups(params, grads):
            ms, us = self._slot_lists(ps, "moment", "inf_norm")
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, gs, alpha=1 - b1)
            torch._foreach_mul_(us, b2)
            torch._foreach_maximum_(us, torch._foreach_abs(gs))
            den = torch._foreach_add(us, self._epsilon)
            lr_t = lr * scale / (1 - b1 ** self._step_count)
            torch._foreach_addcdiv_(pf, ms, den, value=-lr_t)
            self._write_back(ps, pf)


class AdaDelta(Optimizer):
    """AdaDelta (``optimizer.py:493-510``): ``upd = g * sqrt(E[du^2] +
    epsilon) / sqrt(E[g^2] + epsilon)``, ``p -= lr * upd``."""

    _slot_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = float(rho), float(epsilon)

    def _update(self, params, grads, lr):
        rho, eps = self._rho, self._epsilon
        for scale, ps, pf, gs, _ in self._groups(params, grads):
            asg, asu = self._slot_lists(ps, "avg_squared_grad",
                                        "avg_squared_update")
            torch._foreach_mul_(asg, rho)
            torch._foreach_addcmul_(asg, gs, gs, value=1 - rho)
            num = torch._foreach_sqrt(torch._foreach_add(asu, eps))
            den = torch._foreach_sqrt(torch._foreach_add(asg, eps))
            upd = torch._foreach_div(torch._foreach_mul(gs, num), den)
            torch._foreach_mul_(asu, rho)
            torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
            torch._foreach_add_(pf, upd, alpha=-lr * scale)
            self._write_back(ps, pf)


class RMSProp(Optimizer):
    """RMSProp (``optimizer.py:513-536``): ``E[g^2]`` (and, ``centered``,
    ``E[g]``), ``mom = momentum * mom + lr * g / sqrt(E[g^2] - E[g]^2 +
    epsilon)``, ``p -= mom``."""

    _slot_names = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate=0.01, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum = float(momentum)
        self._centered = bool(centered)

    def _update(self, params, grads, lr):
        rho = self._rho
        for scale, ps, pf, gs, _ in self._groups(params, grads):
            ms, mg, mom = self._slot_lists(ps, "mean_square", "mean_grad",
                                           "momentum")
            torch._foreach_mul_(ms, rho)
            torch._foreach_addcmul_(ms, gs, gs, value=1 - rho)
            if self._centered:
                torch._foreach_mul_(mg, rho)
                torch._foreach_add_(mg, gs, alpha=1 - rho)
                den = torch._foreach_addcmul(ms, mg, mg, value=-1.0)
            else:
                den = [m.clone() for m in ms]
            torch._foreach_add_(den, self._epsilon)
            torch._foreach_sqrt_(den)
            torch._foreach_mul_(mom, self._momentum)
            torch._foreach_addcdiv_(mom, gs, den, value=lr * scale)
            torch._foreach_sub_(pf, mom)
            self._write_back(ps, pf)


class Lamb(Optimizer):
    """LAMB (``optimizer.py:539-568``): the Adam direction plus
    ``lamb_weight_decay * p`` (a param group's ``weight_decay`` in its
    place), rescaled by the trust ratio ``|p| / |r|`` (1 unless both are
    positive). ``exclude_from_weight_decay_fn`` is taken and not read, as
    in the JAX package (ROADMAP, "Notes on the reference")."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._lamb_wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _l2(self, p) -> float:
        return 0.0   # the decay is LAMB's own (:meth:`_decay`)

    def _decay(self, p) -> float:
        attr = getattr(p, "optimize_attr", None)
        if attr and "weight_decay" in attr:
            return _coeff(attr["weight_decay"])
        return self._lamb_wd

    def _update(self, params, grads, lr):
        b1, b2, t = self._beta1, self._beta2, self._step_count
        for scale, ps, pf, gs, wd in self._groups(params, grads,
                                                  self._decay):
            m1, m2 = self._slot_lists(ps, "moment1", "moment2")
            torch._foreach_mul_(m1, b1)
            torch._foreach_add_(m1, gs, alpha=1 - b1)
            torch._foreach_mul_(m2, b2)
            torch._foreach_addcmul_(m2, gs, gs, value=1 - b2)
            den = torch._foreach_div(m2, 1 - b2 ** t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self._epsilon)
            r = torch._foreach_div(m1, 1 - b1 ** t)
            torch._foreach_div_(r, den)
            torch._foreach_add_(r, pf, alpha=wd)
            pn = torch.stack(torch._foreach_norm(pf))
            rn = torch.stack(torch._foreach_norm(r))
            trust = torch.where((pn > 0) & (rn > 0), pn / rn,
                                torch.ones_like(pn))
            torch._foreach_mul_(r, list(torch.unbind(lr * scale * trust)))
            torch._foreach_sub_(pf, r)
            self._write_back(ps, pf)
