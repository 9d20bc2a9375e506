"""Pipeline parallelism over the ``pp`` ranks (port of
``paddle1_tpu/distributed/pipeline.py``: ``pipeline_apply``,
``stack_stage_params``).

The JAX package runs every stage of the pipeline in one SPMD program:
the stage weights stacked on a leading axis sharded over ``pp``, one
``lax.scan`` over clock ticks, ``lax.ppermute`` moving each stage's
output to the next stage at every tick, and ``jax.grad`` through the
scan giving the backward pipeline. Here each ``pp`` rank is a process
that holds and runs its own stage, with the same tick schedule
(GPipe's, which gives the JAX scan's numbers):

* forward: at tick t stage s runs micro-batch ``t - s`` (stage 0 takes
  it from ``micro_inputs``, the others from the handoff), and after each
  tick one :func:`collective.shift` moves every stage's output to the
  next stage; the last stage's outputs, in micro-batch order, are then
  broadcast to every ``pp`` rank (the JAX ``psum`` of the masked
  outputs, ``pipeline.py:112-114``);
* backward (one ``torch.autograd.Function``): the ticks in reverse, each
  stage back-propagating a micro-batch through its own graph of the
  forward and shifting its input's gradient to the stage before, and the
  gradient of ``micro_inputs`` (only stage 0 computes it) broadcast to
  every ``pp`` rank, the transpose of the input being replicated. The
  stage's parameter gradients are summed over the micro-batches in f32.
  The last stage takes the outputs' gradient as its own rank computed
  it: the loss after the pipeline is replicated, so its gradient is the
  same on every rank and is not summed.

Every handoff is a collective that every rank of the group makes at every
tick (the ``ppermute`` of the JAX scan), so the ranks cannot wait on each
other in a cycle. Gloo refuses point-to-point transfers of CUDA tensors
(``tools/torch_hybrid_phases.py --gloo-probe``), and two ranks that share
one card run over gloo; the shift is an all-to-all over the tensors'
bytes, which gloo and NCCL both take, and nothing is staged through host
memory by the port. Each stage keeps its micro-batches' activations until
the backward (``recompute`` inside ``stage_fn`` trades them for a second
forward).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..core.errors import InvalidArgumentError
from . import collective

__all__ = ["pipeline_apply", "stack_stage_params"]


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped dict / list /
    tuple trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _flatten(tree) -> tuple:
    """The tensor leaves of a tree, in order, and a function that builds
    the same tree from a list of leaves."""
    leaves: List[torch.Tensor] = []
    _tree_map(leaves.append, tree)

    def unflatten(values: Sequence[torch.Tensor]):
        it = iter(values)
        return _tree_map(lambda _: next(it), tree)
    return leaves, unflatten


def stack_stage_params(per_stage_params):
    """Per-stage parameter trees (dicts, lists or tuples of tensors, one
    per stage) as one tree whose leaves have a leading stage axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


class _Schedule:
    """What one pipelined call carries from its forward to its backward:
    the stage function, the ``pp`` group, the side inputs and, after the
    forward, each micro-batch's leaf input and output on this stage."""

    def __init__(self, stage_fn, unflatten, group, micro_aux):
        self.stage_fn = stage_fn
        self.unflatten = unflatten
        self.group = group
        self.micro_aux = micro_aux
        self.records: list = []
        self.aliases: list = []


def _stage_count(group) -> tuple:
    return (1, 0) if group is None else (group.nranks, group.rank)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, micro_inputs, *params):
        S, s = _stage_count(sched.group)
        M = int(micro_inputs.shape[0])
        sched.aliases = [p.detach().requires_grad_(p.requires_grad)
                         for p in params]
        tree = sched.unflatten(sched.aliases)
        carry_grad = micro_inputs.is_floating_point()
        x_like = micro_inputs[0]
        buf = torch.empty_like(x_like, memory_format=torch.contiguous_format)
        outputs = torch.empty_like(micro_inputs,
                                   memory_format=torch.contiguous_format)
        records = []
        for t in range(M + S - 1):
            m = t - s
            y = None
            if 0 <= m < M:
                x = micro_inputs[m] if s == 0 else buf.clone()
                x = x.detach().requires_grad_(carry_grad)
                aux = None if sched.micro_aux is None else \
                    _tree_map(lambda a: a[m], sched.micro_aux)
                with torch.enable_grad():
                    y = sched.stage_fn(tree, x) if aux is None else \
                        sched.stage_fn(tree, x, aux)
                if tuple(y.shape) != tuple(x_like.shape) or \
                        y.dtype != x_like.dtype:
                    raise InvalidArgumentError(
                        f"pipeline_apply: a stage maps {tuple(x.shape)} "
                        f"{x.dtype} to {tuple(y.shape)} {y.dtype}; every "
                        "stage must keep its input's shape and dtype")
                records.append((x, y))
                if s == S - 1:
                    outputs[m] = y.detach()
            if S > 1 and t < M + S - 2:
                # every rank takes part at every tick; one with nothing to
                # receive passes an empty buffer
                send = y.detach() if y is not None and s < S - 1 else None
                recv = buf if s > 0 and 0 <= t + 1 - s < M else buf[:0]
                collective.shift(send, recv, 1, sched.group)
        sched.records = records
        if S > 1:
            collective.broadcast_bytes(outputs, S - 1, sched.group)
        ctx.sched = sched
        return outputs

    @staticmethod
    def backward(ctx, grad_out):
        sched = ctx.sched
        S, s = _stage_count(sched.group)
        M = int(grad_out.shape[0])
        want = [a for a in sched.aliases if a.requires_grad]
        acc = [torch.zeros_like(a, dtype=torch.float32) for a in want]
        grad_out = grad_out.contiguous()
        gbuf = torch.empty_like(grad_out[0])
        dx = torch.zeros_like(grad_out) if ctx.needs_input_grad[1] \
            else None
        for u in range(M + S - 1):
            m = M - 1 - u + (S - 1 - s)
            gx = None
            if 0 <= m < M:
                x, y = sched.records[m]
                g = grad_out[m] if s == S - 1 else gbuf
                ins = ([x] if x.requires_grad else []) + want
                got = torch.autograd.grad(y, ins, g, allow_unused=True)
                if x.requires_grad:
                    gx, got = got[0], got[1:]
                    if gx is None:
                        gx = torch.zeros_like(x)
                for a, gp in zip(acc, got):
                    if gp is not None:
                        a.add_(gp)
                sched.records[m] = None        # frees the graph
                if s == 0 and dx is not None and gx is not None:
                    dx[m] = gx
            if S > 1 and u < M + S - 2:
                send = gx if s > 0 else None
                m_next = M - 1 - u + (S - 2 - s)
                recv = gbuf if s < S - 1 and 0 <= m_next < M else gbuf[:0]
                collective.shift(send, recv, -1, sched.group)
        if dx is not None and S > 1:
            collective.broadcast_bytes(dx, 0, sched.group)
        grads = iter(acc)
        out = []
        for a in sched.aliases:
            out.append(next(grads).to(a.dtype) if a.requires_grad else None)
        sched.records, sched.aliases = [], []
        return (None, dx) + tuple(out)


def run_pipeline(stage_fn: Callable, params: Sequence[torch.Tensor],
                 micro_inputs: torch.Tensor, micro_aux=None, *,
                 group=None, unflatten=None) -> torch.Tensor:
    """The pipelined forward of this rank's stage over the ``pp`` group
    ``group`` (None: one stage): ``stage_fn(params, x[, aux])`` with
    ``params`` built by ``unflatten`` from the flat list ``params`` (the
    list itself without it). Returns the last stage's outputs ``[M,
    ...]`` on every rank; differentiable in ``micro_inputs`` and
    ``params``."""
    sched = _Schedule(stage_fn, unflatten or list, group, micro_aux)
    return _Pipeline.apply(sched, micro_inputs, *params)


def pipeline_apply(stage_fn: Callable, stacked_params, micro_inputs,
                   axis_name: str = "pp", micro_aux=None, *,
                   group=None) -> torch.Tensor:
    """The pipelined forward: ``stage_fn(params_one_stage, x) -> y`` (or
    ``stage_fn(params, x, aux)`` with ``micro_aux``), every stage keeping
    its input's shape and dtype. ``stacked_params``: a tree whose leaves
    have a leading stage axis of 1 (this rank's stage, as the JAX
    function sees its shard inside ``shard_map``) or of the stage count
    (every stage; this rank takes its own). ``micro_inputs``: ``[n_micro,
    micro_bs, ...]``, the same on every ``pp`` rank. ``micro_aux``: a tree
    of ``[n_micro, ...]`` side inputs, stage s reading micro-batch ``t -
    s``'s at tick t. The stages are the ranks of ``group``, else of the
    group ``env.spmd_axes`` binds to ``axis_name``, else of the hybrid
    group's ``axis_name`` axis (none: one stage). Returns the last
    stage's outputs ``[n_micro, micro_bs, ...]`` in micro-batch order on
    every rank; differentiable in ``micro_inputs`` and the parameters."""
    g = collective.axis_group(axis_name, group)
    if g is not None and g.nranks == 1:
        g = None
    S, s = _stage_count(g)
    leaves, unflatten = _flatten(stacked_params)
    lead = {int(x.shape[0]) for x in leaves}
    if lead == {1}:
        local = [x[0] for x in leaves]
    elif lead == {S}:
        local = [x[s] for x in leaves]
    else:
        raise InvalidArgumentError(
            f"pipeline_apply: stacked stage count must be 1 (this rank's "
            f"stage) or the '{axis_name}' group size {S} (got leading "
            f"dims {sorted(lead)})")
    return run_pipeline(stage_fn, local, micro_inputs, micro_aux, group=g,
                        unflatten=unflatten)
