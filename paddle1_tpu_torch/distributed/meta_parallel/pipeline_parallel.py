"""``PipelineParallel`` (port of
``paddle1_tpu/distributed/meta_parallel/pipeline_parallel.py``): the
reference's ``train_batch``/``eval_batch`` over a ``PipelineLayer``,
with the 1F1B schedule of its ``SectionWorker``.

As in the JAX package, this wrapper runs every stage in one process:
the schedule interleaves the stages' forward and backward segments so
that stage ``s`` never holds more than ``num_stages - s`` micro-batches
in flight (``last_max_in_flight`` records the most each stage held), and
the gradients accumulate on the parameters as sequential accumulation
would give them. Activations cross a stage boundary as detached leaves.
The multi-rank pipeline, one stage a rank, is ``ParallelEngine``'s at
``pp > 1`` (``distributed/pipeline.py``).
"""

from __future__ import annotations

from collections import deque

import torch
from torch import nn

from ...core.errors import InvalidArgumentError
from ..parallel import DataParallel
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def _leaves(s: int, act) -> tuple:
    """Detached leaves of a stage's input; floating ones past stage 0
    carry a gradient back across the boundary."""
    out = []
    for el in _as_tuple(act):
        if isinstance(el, torch.Tensor):
            el = el.detach()
            if s > 0 and el.is_floating_point():
                el.requires_grad_(True)
        out.append(el)
    return tuple(out)


class PipelineParallel(DataParallel):
    """``layers`` (a ``PipelineLayer``) under the hybrid group ``hcg``:
    gradients averaged over its data-parallel group, micro-batches of
    ``strategy.pipeline_configs["micro_batch_size"]`` rows."""

    def __init__(self, layers: nn.Module, hcg, strategy=None):
        if not isinstance(layers, PipelineLayer):
            raise InvalidArgumentError(
                "PipelineParallel expects a PipelineLayer model "
                "(reference pipeline_parallel.py asserts the same)")
        super().__init__(layers, group=hcg.get_data_parallel_group())
        self._hcg = hcg
        cfg = (strategy.pipeline_configs if strategy is not None else
               {"accumulate_steps": 1, "micro_batch_size": 1})
        self.accumulate_steps = cfg.get("accumulate_steps", 1)
        self.micro_batch_size = cfg.get("micro_batch_size", 1)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """``data = [inputs, labels]``: the mean loss over the
        micro-batches after one optimizer step on their summed
        gradients (each micro-batch's loss divided by their number)."""
        inputs, labels = data
        total = inputs.shape[0]
        micro = max(1, self.micro_batch_size)
        if total % micro:
            raise InvalidArgumentError(
                f"batch size {total} must be divisible by "
                f"micro_batch_size {micro} (the reference asserts the "
                f"same in pipeline_parallel.py)")
        n_micro = total // micro
        loss_fn = self._layers._loss_fn
        if loss_fn is None:
            raise InvalidArgumentError(
                "PipelineLayer needs loss_fn for train_batch")
        total_loss = self._run_1f1b(inputs, labels, n_micro, micro,
                                    loss_fn, scaler)
        if scaler is not None:
            scaler.step(optimizer)    # advances the loss scale too
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total_loss / float(n_micro)

    def _run_1f1b(self, inputs, labels, n_micro, micro, loss_fn, scaler):
        layers = self._layers
        S = layers.num_stages
        bounds = layers.segment_parts

        def seg_forward(s, x):
            # recompute_interval by GLOBAL layer index, as forward has it
            for gi in range(bounds[s], bounds[s + 1]):
                x = layers.run_layer(gi, x)
            return x

        input_q = [deque() for _ in range(S)]   # (mb, activation)
        grad_q = [deque() for _ in range(S)]    # (mb, out-grads or None)
        inflight = [{} for _ in range(S)]       # mb -> (leaves, out)
        fwd_done, bwd_done = [0] * S, [0] * S
        self.last_max_in_flight = [0] * S
        for i in range(n_micro):
            input_q[0].append((i, inputs[i * micro:(i + 1) * micro]))
        total_loss = None

        def do_forward(s):
            mb, x = input_q[s].popleft()
            leaves = _leaves(s, x)
            out = seg_forward(s, leaves if len(leaves) > 1 else leaves[0])
            if s == S - 1:
                loss = loss_fn(out, labels[mb * micro:(mb + 1) * micro])
                inflight[s][mb] = (leaves, loss)
                grad_q[s].append((mb, None))    # its backward can run
            else:
                inflight[s][mb] = (leaves, out)
                handoff = tuple(o.detach() if isinstance(o, torch.Tensor)
                                else o for o in _as_tuple(out))
                input_q[s + 1].append(
                    (mb, handoff if len(handoff) > 1 else handoff[0]))
            fwd_done[s] += 1
            self.last_max_in_flight[s] = max(
                self.last_max_in_flight[s], fwd_done[s] - bwd_done[s])

        def do_backward(s):
            nonlocal total_loss
            mb, g = grad_q[s].popleft()
            leaves, out = inflight[s].pop(mb)
            if s == S - 1:
                scaled = out / float(n_micro)
                (scaler.scale(scaled) if scaler is not None
                 else scaled).backward()
                total_loss = out.detach() if total_loss is None \
                    else total_loss + out.detach()
            elif g is not None:
                # only the outputs a gradient arrived for
                pairs = [(o, gg) for o, gg in zip(_as_tuple(out),
                                                  _as_tuple(g))
                         if gg is not None and isinstance(o, torch.Tensor)
                         and o.requires_grad]
                if pairs:
                    torch.autograd.backward([o for o, _ in pairs],
                                            [gg for _, gg in pairs])
            # ALWAYS hand something upstream: an integer or detached
            # boundary would otherwise starve the upstream queue and the
            # schedule deadlock
            if s > 0:
                gs = tuple(l.grad if isinstance(l, torch.Tensor) and
                           l.requires_grad else None for l in leaves)
                grad_q[s - 1].append(
                    (mb, None if all(x is None for x in gs) else gs))
            bwd_done[s] += 1

        # each pass gives every stage one op: backward when a gradient
        # waits (it frees memory), else forward within the 1F1B bound
        # (stage s holds at most S - s micro-batches)
        while any(b < n_micro for b in bwd_done):
            progressed = False
            for s in range(S - 1, -1, -1):
                if grad_q[s] and fwd_done[s] > bwd_done[s]:
                    do_backward(s)
                    progressed = True
                elif input_q[s] and fwd_done[s] < n_micro and \
                        fwd_done[s] - bwd_done[s] < S - s:
                    do_forward(s)
                    progressed = True
            if not progressed:  # pragma: no cover - schedule invariant
                raise RuntimeError("1F1B schedule deadlocked")
        return total_loss

    def eval_batch(self, data, compute_loss: bool = True):
        inputs, labels = data
        out = self._layers(inputs)
        if compute_loss and self._layers._loss_fn is not None:
            return self._layers._loss_fn(out, labels)
        return out
