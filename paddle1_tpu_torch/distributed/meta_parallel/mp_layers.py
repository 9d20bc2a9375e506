"""Tensor-(model-)parallel layers (port of
``paddle1_tpu/distributed/meta_parallel/mp_layers.py``:
``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``, ``ParallelCrossEntropy``), and
:func:`shard_tagged_layers`, which turns the dense layers
``text.models.apply_megatron_sharding`` tagged into the same thing.

The JAX module has two paths (its docstring): GSPMD, where each layer
holds the whole weight tagged with mesh axes and XLA inserts the
collectives, and explicit SPMD under ``shard_map``, where each rank holds
its shard and the layer calls the Megatron pairs. One process runs a
rank here, so the port takes the explicit path: a layer holds its
model-parallel shard and calls ``collective._c_identity`` (f),
``_mp_allreduce`` (g), ``_c_concat`` and ``_c_split`` over its group (the
``mp_group`` given, else the hybrid group's). With a group of one rank
every pair is the identity and the layer is its dense self.

The weights are drawn whole, as the dense layer draws them (every rank
the same values from the same seed), and each rank keeps its slice: the
parallel layers on n ranks compute what the dense layer with those
weights computes.

* ``ColumnParallelLinear``: ``y_r = f(x) @ W[:, cols_r] + b[cols_r]``,
  gathered over the group with ``gather_output``.
* ``RowParallelLinear``: ``y = g(x_r @ W[rows_r, :]) + b``, the bias
  added once after the reduction; ``x`` split first unless
  ``input_is_parallel``.
* ``VocabParallelEmbedding``: a rank looks up the ids in its vocabulary
  range (the others give zero rows) and g sums the ranks.
* ``ParallelCrossEntropy``: softmax cross entropy over vocabulary-sharded
  logits (max and sum reduced over the group), one loss per row
  ``[..., 1]``, the same on every rank; its backward is this rank's
  slice of ``softmax - onehot``.
"""

from __future__ import annotations

import functools
import inspect
import types
from typing import Optional

import torch

from ...core.errors import InvalidArgumentError, UnimplementedError
from ...nn import functional as F
from ...nn.initializer import XavierUniform
from ...nn.layer_base import Layer
from .. import collective
from ..collective import _c_concat, _c_identity, _c_split, _mp_allreduce

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "shard_tagged_layers", "column_parallel_linear",
           "row_parallel_linear", "vocab_parallel_embedding",
           "parallel_cross_entropy"]


def _group(mp_group) -> Optional[collective.Group]:
    """The model-parallel group: ``mp_group``, else the hybrid group's
    (None: one rank)."""
    if mp_group is not None:
        return mp_group
    from ..topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _split(n: int, g: Optional[collective.Group], what: str):
    """``(start, size)`` of this rank's part of ``n``."""
    k = 1 if g is None else g.nranks
    if n % k:
        raise InvalidArgumentError(
            f"{what}: {n} does not divide over {k} model-parallel ranks")
    r = 0 if g is None else g.rank
    return r * (n // k), n // k


@torch.no_grad()
def _keep_slice(p: torch.nn.Parameter, dim: int, start: int, size: int):
    """Cut ``p`` to ``[start, start + size)`` along ``dim`` in place (its
    identity, name and attributes kept)."""
    p.data = p.data.narrow(dim, start, size).clone()


# ---------------------------------------------------------------------------
# the functional forms


def column_parallel_linear(x, weight, bias, group, gather_output=False):
    """``f(x) @ weight + bias`` over a column shard; gathered with
    ``gather_output``."""
    y = F.linear(_c_identity(x, group), weight, bias)
    return _c_concat(y, group) if gather_output else y


def row_parallel_linear(x, weight, bias, group, input_is_parallel=True):
    """``g(x_r @ weight) + bias`` over a row shard (``x`` split first
    unless ``input_is_parallel``)."""
    if not input_is_parallel:
        x = _c_split(x, group)
    y = _mp_allreduce(F.linear(x, weight, None), group)
    return y if bias is None else y + bias


def vocab_parallel_embedding(x, weight, start, group, padding_idx=None):
    """The rows of the ids in ``[start, start + rows)`` from this rank's
    shard, zero rows for the others (and for ``padding_idx``), summed
    over the group."""
    ids = x.long()
    local = ids - start
    keep = (local >= 0) & (local < weight.shape[0])
    if padding_idx is not None and padding_idx >= 0:
        keep = keep & (ids != padding_idx)
    out = torch.nn.functional.embedding(
        torch.where(keep, local, torch.zeros_like(local)), weight)
    out = out * keep.unsqueeze(-1).to(out.dtype)
    return _mp_allreduce(out, group)


class _ParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, g):
        per = logits.shape[-1]
        start = g.rank * per
        lg = logits.float()
        m = lg.max(-1, keepdim=True).values
        collective.all_reduce(m, collective.ReduceOp.MAX, g)
        e = torch.exp(lg - m)
        denom = e.sum(-1, keepdim=True)
        collective.all_reduce(denom, collective.ReduceOp.SUM, g)
        local = label.long() - start
        keep = (local >= 0) & (local < per)
        safe = torch.where(keep, local, torch.zeros_like(local))
        picked = torch.gather(lg - m, -1, safe.unsqueeze(-1)).squeeze(-1)
        picked = torch.where(keep, picked, torch.zeros_like(picked))
        collective.all_reduce(picked, collective.ReduceOp.SUM, g)
        loss = (torch.log(denom.squeeze(-1)) - picked).unsqueeze(-1)
        ctx.save_for_backward(e / denom, safe, keep)
        ctx.dtype = logits.dtype
        return loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, dloss):
        soft, safe, keep = ctx.saved_tensors
        grad = soft.clone()
        hit = torch.zeros_like(grad).scatter_(
            -1, safe.unsqueeze(-1), keep.unsqueeze(-1).to(grad.dtype))
        grad = (grad - hit) * dloss.float()
        return grad.to(ctx.dtype), None, None


def parallel_cross_entropy(logits, label, group):
    """Per-row softmax cross entropy ``[..., 1]`` of vocabulary-sharded
    ``logits`` (this rank's columns are ``[rank * per, (rank + 1) *
    per)``) against global ``label`` ids."""
    g = collective._mp_group(group)
    if g is None:
        logp = torch.log_softmax(logits.float(), -1)
        return (-torch.gather(logp, -1, label.long().unsqueeze(-1))
                ).to(logits.dtype)
    return _ParallelCE.apply(logits, label, g)


# ---------------------------------------------------------------------------
# the layers


class VocabParallelEmbedding(Layer):
    """Embedding with the vocabulary split over the model-parallel group
    (reference mp_layers.py:29)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._group = _group(mp_group)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierUniform(), device=device,
            generator=generator)
        self._start, per = _split(num_embeddings, self._group,
                                  "VocabParallelEmbedding")
        _keep_slice(self.weight, 0, self._start, per)
        self.weight.sharding_axes = ("mp", None)
        self.weight._mp_local = True

    def forward(self, x):
        return vocab_parallel_embedding(x, self.weight, self._start,
                                        self._group)


class ColumnParallelLinear(Layer):
    """Linear with the output dimension split over the model-parallel
    group (reference mp_layers.py:85)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = True, mp_group=None,
                 fuse_matmul_bias: bool = False, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._group = _group(mp_group)
        self._in_features = in_features
        self._out_features = out_features
        self.gather_output = gather_output
        start, per = _split(out_features, self._group,
                            "ColumnParallelLinear")
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform(), device=device,
            generator=generator)
        _keep_slice(self.weight, 1, start, per)
        self.weight.sharding_axes = (None, "mp")
        self.weight._mp_local = True
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True,
                                              device=device)
            _keep_slice(self.bias, 0, start, per)
            self.bias.sharding_axes = ("mp",)
            self.bias._mp_local = True
        else:
            self.bias = None

    def forward(self, x):
        return column_parallel_linear(x, self.weight, self.bias,
                                      self._group, self.gather_output)


class RowParallelLinear(Layer):
    """Linear with the input dimension split over the model-parallel
    group (reference mp_layers.py:143); the bias is whole, added once."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = False, mp_group=None,
                 fuse_matmul_bias: bool = False, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._group = _group(mp_group)
        self._in_features = in_features
        self._out_features = out_features
        self.input_is_parallel = input_is_parallel
        start, per = _split(in_features, self._group, "RowParallelLinear")
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform(), device=device,
            generator=generator)
        _keep_slice(self.weight, 0, start, per)
        self.weight.sharding_axes = ("mp", None)
        self.weight._mp_local = True
        self.bias = self.create_parameter([out_features], is_bias=True,
                                          device=device) \
            if has_bias else None

    def forward(self, x):
        return row_parallel_linear(x, self.weight, self.bias, self._group,
                                   self.input_is_parallel)


class ParallelCrossEntropy(Layer):
    """Softmax cross entropy over vocabulary-sharded logits (reference
    parallel_cross_entropy): ``[..., 1]`` losses."""

    def __init__(self, mp_group=None, name=None):
        super().__init__()
        self._group = _group(mp_group)

    def forward(self, logits, label):
        return parallel_cross_entropy(logits, label, self._group)


# ---------------------------------------------------------------------------
# the dense layers apply_megatron_sharding tagged


def _axes(p) -> tuple:
    return tuple(getattr(p, "sharding_axes", None) or ())


def _bind(module, fn, **kw) -> None:
    """Make ``fn(module, ...)`` the module's forward (an instance
    attribute; the group rides in the partial, not on the module, so a
    deep copy of the model copies no process group)."""
    module.forward = types.MethodType(functools.partial(fn, **kw), module)


def _column_forward(self, x, group=None, gather=False):
    return column_parallel_linear(x, self.weight, self.bias, group, gather)


def _row_forward(self, x, group=None, split=False):
    return row_parallel_linear(x, self.weight, self.bias, group, not split)


def _vocab_forward(self, x, group=None, start=0):
    return vocab_parallel_embedding(x, self.weight, start, group,
                                    self._padding_idx)


def shard_tagged_layers(model: torch.nn.Module,
                        group: collective.Group) -> int:
    """Cut every parameter whose ``sharding_axes`` names ``"mp"`` to this
    rank's shard of ``group`` and make the layers that hold them compute
    with the Megatron pairs (a tied weight is cut once). A ``Linear``
    whose weight is ``(None, "mp")`` becomes column-parallel (its bias cut
    too where tagged ``("mp",)``), ``("mp", None)`` row-parallel; an
    ``Embedding`` ``("mp", None)`` vocabulary-parallel; another layer
    holding a tagged parameter of its own (BERT's MLM head over the tied
    embedding) has it cut along its ``"mp"`` axis and its forward bound
    with ``mp_group=group``, which that forward must take. Where an attention
    layer's heads do not divide over the group, its q/k/v outputs are
    gathered and its output projection splits its input (Megatron's
    ``gather_output``/``input_is_parallel=False``), so each head stays
    whole. Returns the number of parameters cut; a layer whose forward
    takes no ``mp_group`` raises."""
    from ...nn.layer_common import Embedding, Linear
    from ...nn.layer_transformer import MultiHeadAttention
    n = group.nranks
    whole_heads = set()
    for m in model.modules():
        if isinstance(m, MultiHeadAttention) and m.num_heads % n:
            whole_heads.update({id(m.q_proj), id(m.k_proj), id(m.v_proj),
                                id(m.out_proj)})
    cut, done = 0, set()

    def keep(p, dim, what):
        nonlocal cut
        if id(p) in done or getattr(p, "_mp_local", False):
            return
        start, per = _split(p.shape[dim], group, what)
        _keep_slice(p, dim, start, per)
        p._mp_local = True
        done.add(id(p))
        cut += 1

    for name, m in model.named_modules():
        own = {k: p for k, p in m.named_parameters(recurse=False)
               if "mp" in _axes(p)}
        if isinstance(m, Linear) and "weight" in own:
            axes = _axes(m.weight)
            if axes == (None, "mp"):
                keep(m.weight, 1, name + ".weight")
                if m.bias is not None and _axes(m.bias) == ("mp",):
                    keep(m.bias, 0, name + ".bias")
                _bind(m, _column_forward, group=group,
                      gather=id(m) in whole_heads)
            elif axes == ("mp", None):
                keep(m.weight, 0, name + ".weight")
                _bind(m, _row_forward, group=group,
                      split=id(m) in whole_heads)
            else:
                raise UnimplementedError(
                    f"{name}: a Linear weight tagged {axes} has no "
                    "model-parallel form (column: (None, 'mp'), row: "
                    "('mp', None))")
            continue
        if isinstance(m, Embedding) and "weight" in own:
            if _axes(m.weight) != ("mp", None):
                raise UnimplementedError(
                    f"{name}: an Embedding weight tagged "
                    f"{_axes(m.weight)}; only ('mp', None) is ported")
            start, _ = _split(m._num_embeddings, group, name + ".weight")
            keep(m.weight, 0, name + ".weight")
            _bind(m, _vocab_forward, group=group, start=start)
            continue
        if not own or isinstance(m, (VocabParallelEmbedding,
                                     ColumnParallelLinear,
                                     RowParallelLinear)):
            continue
        if "mp_group" not in inspect.signature(type(m).forward).parameters:
            raise UnimplementedError(
                f"{name} ({type(m).__name__}) holds model-parallel tagged "
                f"parameters {sorted(own)} and its forward takes no "
                "mp_group: the port cuts Linear, Embedding and layers whose "
                "forward computes with their shard given mp_group")
        for k, p in own.items():
            keep(p, _axes(p).index("mp"), f"{name}.{k}")
        _bind(m, type(m).forward, mp_group=group)
    return cut
