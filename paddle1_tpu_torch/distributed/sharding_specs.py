"""Parameter and batch layouts over the hybrid mesh (port of
``paddle1_tpu/distributed/sharding_specs.py``: ``param_partition_specs``,
``zero_shard_spec``, ``data_partition_spec``, ``describe_layout``).

A spec is a tuple with one entry a dimension: the mesh axis name the
dimension is cut over, a tuple of names, or None (replicated) — the
tuples the JAX package's ``PartitionSpec``s hold. The JAX engine hands
them to GSPMD; ``ParallelEngine`` reads them to cut each rank's shard:
the ``mp`` entries of a parameter's spec (from ``sharding_axes``,
``text.models.apply_megatron_sharding``) say which dimension its
model-parallel shard takes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["param_partition_specs", "zero_shard_spec",
           "data_partition_spec", "describe_layout"]

Spec = Tuple


def describe_layout(tree) -> Dict[str, str]:
    """``{path: spec}`` of a state tree (a dict, list or tuple, nested)
    whose leaves carry a spec: a tensor's ``sharding_axes`` where it has
    one (the JAX package reads each array's sharding). Leaves without one
    are skipped."""
    out: Dict[str, str] = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}[{k!r}]", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{path}[{i}]", v)
        else:
            axes = getattr(node, "sharding_axes", None)
            if axes is not None:
                out[path] = str(tuple(axes))
    walk("", tree)
    return out


def param_partition_specs(layer: torch.nn.Module, zero_stage: int = 0,
                          zero_axis: str = "sharding",
                          zero_axis_size: int = 1) -> Dict[str, Spec]:
    """``{name: spec}`` over the layer's state (structured names, a tied
    weight under each of its names, as the JAX package's
    ``state_dict()``). The model-parallel axes come from each parameter's
    ``sharding_axes``; ZeRO stage 3 also cuts the largest dimension that
    is not cut yet and divides by ``zero_axis_size`` over ``zero_axis``
    (stages 1-2 cut only slots and gradients: :func:`zero_shard_spec`)."""
    specs: Dict[str, Spec] = {}
    for name, p in layer.state_dict(keep_vars=True).items():
        axes = list(getattr(p, "sharding_axes", None) or
                    [None] * p.dim())
        while len(axes) < p.dim():
            axes.append(None)
        if zero_stage >= 3 and zero_axis not in axes and p.dim():
            free = [i for i, a in enumerate(axes)
                    if a is None and p.shape[i] % max(zero_axis_size, 1) == 0]
            if free:
                big = max(free, key=lambda i: p.shape[i])
                axes[big] = zero_axis
        specs[name] = tuple(axes)
    return specs


def zero_shard_spec(param_spec: Optional[Spec], shape,
                    zero_axis: str = "sharding",
                    zero_axis_size: int = 1) -> Spec:
    """The spec of a ZeRO (stage >= 1) optimizer slot: the parameter's
    spec with its largest free dimension that divides by
    ``zero_axis_size`` cut over ``zero_axis``; dimensions that do not
    divide stay replicated."""
    axes = list(param_spec) if param_spec else []
    shape = tuple(shape)
    while len(axes) < len(shape):
        axes.append(None)
    if zero_axis in axes or not shape:
        return tuple(axes)
    free = [i for i, a in enumerate(axes)
            if a is None and shape[i] % max(zero_axis_size, 1) == 0]
    if not free:
        return tuple(axes)
    big = max(free, key=lambda i: shape[i])
    axes[big] = zero_axis
    return tuple(axes)


def data_partition_spec(batch_axes=("dp", "sharding"),
                        seq_axis: Optional[str] = None) -> Spec:
    """A batch tensor's spec: the batch dimension over the data axes (dp
    and, in hybrid ZeRO, sharding), the sequence dimension over
    ``seq_axis`` where given. A single axis stands alone, not in a
    1-tuple, as ``PartitionSpec`` keeps it."""
    batch = tuple(batch_axes)
    entry = batch[0] if len(batch) == 1 else batch
    if seq_axis:
        return (entry, seq_axis)
    return (entry,)
