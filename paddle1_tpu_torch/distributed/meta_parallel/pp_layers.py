"""Pipeline-parallel model description and stage partition (port of
``paddle1_tpu/distributed/meta_parallel/pp_layers.py``: ``LayerDesc``,
``SharedLayerDesc``, ``SegmentLayers``, ``PipelineLayer``).

The model is a flat list of layer descriptors cut into contiguous
stages: ``uniform`` by count, ``parameters`` by parameter volume, or
``layer:<Class>`` at the layers of one class. ``PipelineLayer`` builds
every stage in this process (a shared layer once), tags each parameter
with its ``pp_stage``, and its forward runs the stages in turn;
``PipelineParallel``'s 1F1B schedule runs them through
``segment_parts``. The multi-rank pipeline, one stage a rank, is
``ParallelEngine``'s at ``pp > 1`` (``distributed/pipeline.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from torch import nn

from ...core.errors import InvalidArgumentError
from ...nn.layer_base import Layer, LayerList

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    """A deferred layer constructor: ``layer_func(*inputs, **kwargs)``."""

    def __init__(self, layer_func: Callable, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not callable(layer_func):
            raise InvalidArgumentError("LayerDesc needs a Layer class")

    def build_layer(self) -> nn.Module:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({getattr(self.layer_func, '__name__', '?')})"


class SharedLayerDesc(LayerDesc):
    """A layer shared between stages under the key ``key`` (tied
    embeddings): built once, every place that names the key runs the same
    layer."""

    def __init__(self, key: str, layer_func: Callable, forward_func=None,
                 shared_weight_attr: str = "weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _numel(module: nn.Module) -> int:
    return sum(p.nelement() for p in module.parameters()) or 1


class SegmentLayers:
    """A contiguous partition of ``layers_desc`` into ``num_parts`` stages:
    ``do_segment()`` gives the ``num_parts + 1`` boundaries. ``method``:
    ``uniform`` (by count, the remainder to the first stages),
    ``parameters`` (greedy boundaries on the prefix sum of each layer's
    parameter count) or ``layer:<Class>`` (boundaries at the layers of
    that class, whose number the stages must divide)."""

    # parameter counts by constructor, so that N identical blocks build
    # one sample, dropped at once
    _count_cache: dict = {}

    def __init__(self, layers_desc: Sequence, num_parts: int,
                 method: str = "uniform"):
        self.descs = list(layers_desc)
        self.num_parts = num_parts
        self.method = method
        if len(self.descs) < num_parts:
            raise InvalidArgumentError(
                f"{len(self.descs)} layers cannot fill {num_parts} stages")

    def do_segment(self) -> List[int]:
        n, parts = len(self.descs), self.num_parts
        if self.method == "uniform":
            base, rem = divmod(n, parts)
            bounds = [0]
            for i in range(parts):
                bounds.append(bounds[-1] + base + (1 if i < rem else 0))
            return bounds
        if self.method == "parameters":
            weights = [self._param_count(d) for d in self.descs]
            target = (sum(weights) or 1) / parts
            bounds, acc = [0], 0.0
            for i, w in enumerate(weights):
                acc += w
                if (len(bounds) < parts and acc >= target * len(bounds) and
                        n - (i + 1) >= parts - len(bounds)):
                    bounds.append(i + 1)
            while len(bounds) < parts:
                bounds.append(bounds[-1] + 1)
            bounds.append(n)
            return bounds
        if self.method.startswith("layer:"):
            target = self.method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.descs)
                     if getattr(getattr(d, "layer_func", d), "__name__", "")
                     == target]
            if not marks:
                raise InvalidArgumentError(
                    f"segment method 'layer:{target}' matched no layers")
            if len(marks) % parts:
                raise InvalidArgumentError(
                    f"'layer:{target}' matched {len(marks)} layers, not "
                    f"divisible into {parts} stages (the reference "
                    "SegmentLayers asserts the same)")
            per = len(marks) // parts
            return [0] + [marks[i * per] for i in range(1, parts)] + [n]
        raise InvalidArgumentError(f"Unknown segment method {self.method}")

    @classmethod
    def _param_count(cls, desc) -> int:
        if isinstance(desc, nn.Module):
            return _numel(desc)
        if isinstance(desc, LayerDesc):
            key = (desc.layer_func, repr(desc.inputs), repr(desc.kwargs))
            if key not in cls._count_cache:
                try:
                    cls._count_cache[key] = _numel(desc.build_layer())
                except Exception:   # noqa: BLE001 (the JAX package's rule)
                    cls._count_cache[key] = 1
            return cls._count_cache[key]
        return 1


class _FnLayer(Layer):
    """A plain callable of the descriptor list as a layer."""

    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class PipelineLayer(Layer):
    """The stage-partitioned model. ``layers``: ``LayerDesc``s, shared
    descriptors, built layers or callables; ``num_stages`` defaults to the
    hybrid group's pipeline degree (1 without one). ``segment_parts`` are
    the stage boundaries, ``run_function`` every built layer in order,
    and each parameter carries ``pp_stage``. ``forward`` runs the stages
    in turn, every ``recompute_interval``-th layer (by global index)
    rematerialized in training mode."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0, **kwargs):
        super().__init__()
        from ..topology import get_hybrid_communicate_group
        self._loss_fn = loss_fn
        hcg = get_hybrid_communicate_group()
        self._num_stages = num_stages if num_stages is not None else (
            hcg.get_pipe_parallel_world_size() if hcg is not None else 1)
        self._descs = list(layers)
        self.segment_parts = SegmentLayers(self._descs, self._num_stages,
                                           seg_method).do_segment()
        self.recompute_interval = recompute_interval
        self._shared_layers = {}
        built: List[nn.Module] = []
        self._stage_of_layer: List[int] = []
        for stage in range(self._num_stages):
            lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
            for d in self._descs[lo:hi]:
                if isinstance(d, SharedLayerDesc):
                    if d.layer_name not in self._shared_layers:
                        self._shared_layers[d.layer_name] = d.build_layer()
                    lyr = self._shared_layers[d.layer_name]
                elif isinstance(d, LayerDesc):
                    lyr = d.build_layer()
                elif isinstance(d, nn.Module):
                    lyr = d
                elif callable(d):
                    lyr = _FnLayer(d)
                else:
                    raise InvalidArgumentError(f"Bad pipeline desc: {d!r}")
                built.append(lyr)
                self._stage_of_layer.append(stage)
                for p in lyr.parameters():
                    p.pp_stage = stage
        self.run_function = LayerList(built)

    def get_stage_from_index(self, idx: int) -> int:
        return self._stage_of_layer[idx]

    def stage_layers(self, stage: int) -> List[nn.Module]:
        return [l for l, s in zip(self.run_function, self._stage_of_layer)
                if s == stage]

    @property
    def num_stages(self) -> int:
        return self._num_stages

    def run_layer(self, idx: int, x):
        """Layer ``idx`` (global index) on ``x`` (a tuple is spread into
        its arguments), rematerialized where ``recompute_interval`` says."""
        lyr = self.run_function[idx]
        args = x if isinstance(x, tuple) else (x,)
        if (self.recompute_interval > 0 and idx % self.recompute_interval
                == 0 and self.training):
            from ..fleet.utils.recompute import recompute
            return recompute(lyr, *args)
        return lyr(*args)

    def forward(self, x):
        for i in range(len(self.run_function)):
            x = self.run_layer(i, x)
        return x
