"""Transformer layers (port of ``paddle1_tpu/nn/layer_transformer.py``,
its whole ``__all__``: ``MultiHeadAttention``, the encoder and decoder
layers and stacks, and the encoder-decoder ``Transformer``).

``MultiHeadAttention`` takes the JAX package's attention ``dropout``
(applied in training mode only) and keeps boolean or integer masks
boolean, so ``scaled_dot_product_attention`` can prove a padding mask and
route the flash kernels. ``need_weights`` puts None in the weights slot
of its result (the fused path has no weights), and ``fuse_qkv`` keeps the
three projections, as the JAX package does (``layer_transformer.py:218,
249``). ``TransformerEncoderLayer`` has the JAX
constructor (dropout 0.1 by default, activation, attn/act dropout,
pre- or post-norm); the serving ``CausalLM`` builds it with dropout 0.

``MultiHeadAttention`` keeps the reference's two incremental-decoding
caches (``layer_transformer.py:104-176``), the ones the decoder and
``nn.decode`` carry:

* ``Cache(k, v)`` — the keys and values so far, ``[B, N, heads, dim]``;
  each call concatenates its new ones along the sequence axis (axis 1)
  and returns the grown cache. ``gen_cache`` starts it empty, float32 as
  the JAX package's (under ``auto_cast`` the concatenation promotes the
  16-bit new rows to float32, as ``jnp.concatenate`` does).
* ``StaticCache(k, v)`` — the projected keys and values of a fixed
  memory (the encoder's output), made once by
  ``gen_cache(memory, memory, type=StaticCache)`` and read by every
  step's cross-attention in place of projecting the memory again.

and the JAX package's two serving caches:

* ``GenCache(k, v, pos)`` — dense ``[slots, max_seq, heads, dim]`` K/V
  written at a per-slot cursor ``pos`` ([slots] int32).
* ``PagedCache(k, v, table, pos)`` — global ``[pages, page_size, heads,
  dim]`` pools shared by every slot, a ``[slots, max_pages_per_slot]``
  page table and the same cursor. Table rows point at the parking page 0
  beyond a slot's allocation, so free slots only write parking garbage.

Unlike the JAX package, whose arrays are immutable (the engine donates
them through every step), the port writes new K/V rows into the cache
tensors IN PLACE and returns the same tensors in the advanced cache:
no per-step copy of the pools. Shapes never change, so a later PR can
capture the decode step in a CUDA graph.

Attention routes as in the JAX package (``functional/attention.py``):
the flash kernels take an encoder's self-attention and the decoder's
cross-attention where dropout is 0, both lengths are multiples of 128 and
the mask is absent or a ``[B|1, 1, 1, Nk]`` padding mask; the decoder's
self-attention under its ``[L, L]`` causal mask, and any step of
incremental decoding (one query), take the dense composition.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import threading
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError
from . import functional as F
from .layer_base import Layer, LayerList
from .layer_common import Dropout, Linear
from .layer_norm_act import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


# the sequence group while a block runs on its slice of a cut sequence
# (TransformerEncoder under ParallelEngine's sp binding; per thread)
_cut = threading.local()


@contextlib.contextmanager
def _sequence_cut(group):
    prev = getattr(_cut, "group", None)
    _cut.group = group
    try:
        yield
    finally:
        _cut.group = prev


def _paged_rows(table, pos, window, page_size):
    """Where slot s's new window lands in the pools: logical position i
    lives at page ``table[s, i // ps]``, offset ``i % ps``. Positions past
    capacity clamp to the last mapped row (the JAX package's
    ``min(idx, table.shape[1] * ps - 1)``). Returns ``(pages, offsets)``,
    both [S, W], shared by the K and the V write."""
    idx = pos.long()[:, None] + torch.arange(window, device=pos.device)
    idx = idx.clamp(max=table.shape[1] * page_size - 1)
    return torch.gather(table.long(), 1, idx // page_size), idx % page_size


def _slot_write(cache, new, pos):
    """Per-slot write: row s gets its new [L, H, D] block at cursor
    ``pos[s]``, the start clamped so the block stays inside the row (the
    clamp ``dynamic_update_slice`` applies in the JAX package)."""
    n, cap = new.shape[1], cache.shape[1]
    start = pos.long().clamp(0, cap - n)
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(n, device=cache.device)
    cache[rows, cols] = new.to(cache.dtype)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    GenCache = collections.namedtuple("GenCache", ["k", "v", "pos"])
    PagedCache = collections.namedtuple("PagedCache",
                                        ["k", "v", "table", "pos"])

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, fuse_qkv: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise InvalidArgumentError(
                "embed_dim must be divisible by num_heads")
        self.dropout = float(dropout)
        self.need_weights = bool(need_weights)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=resolve_device(device), generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        # heads of head_dim: all of them, or this rank's under model
        # parallelism (distributed.meta_parallel.shard_tagged_layers cuts
        # the projections to whole heads)
        b, n = x.shape[0], x.shape[1]
        return torch.reshape(x, (b, n, -1, self.head_dim))

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            return q, cache.k, cache.v, cache
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            return q, k, v, self.Cache(k, v)
        new_tokens = query.shape[1]
        if isinstance(cache, self.PagedCache):
            pg, off = _paged_rows(cache.table, cache.pos, new_tokens,
                                  cache.k.shape[1])
            cache.k[pg, off] = k.to(cache.k.dtype)
            cache.v[pg, off] = v.to(cache.v.dtype)
            cache = self.PagedCache(cache.k, cache.v, cache.table,
                                    cache.pos + new_tokens)
            k, v = cache.k, cache.v
        elif isinstance(cache, self.GenCache):
            _slot_write(cache.k, k, cache.pos)
            _slot_write(cache.v, v, cache.pos)
            cache = self.GenCache(cache.k, cache.v, cache.pos + new_tokens)
            k, v = cache.k, cache.v
        elif cache is not None:
            raise InvalidArgumentError(
                f"unsupported cache type {type(cache).__name__}: "
                "MultiHeadAttention takes Cache, StaticCache, GenCache and "
                "PagedCache")
        return q, k, v, cache

    def _device(self):
        return self.q_proj.weight.device

    def gen_cache(self, key, value=None, type=Cache):
        """``type=StaticCache``: the projected keys and values of ``key``
        / ``value`` (``value`` None: ``key``), ``[B, N, heads, dim]``;
        ``type=Cache`` (the default): an empty float32 cache ``[B, 0,
        heads, dim]`` for ``key``'s batch."""
        if type is MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(key if value is None
                                              else value))
            return self.StaticCache(k, v)
        shape = (int(key.shape[0]), 0, self.num_heads, self.head_dim)
        return self.Cache(
            torch.zeros(shape, dtype=torch.float32, device=self._device()),
            torch.zeros(shape, dtype=torch.float32, device=self._device()))

    def gen_slot_cache(self, slots, max_seq, dtype=torch.float32):
        """Dense serving decode cache: ``slots`` sequences, each owning a
        ``[max_seq, heads, dim]`` K/V row written at its own cursor."""
        shape = (int(slots), int(max_seq), self.num_heads, self.head_dim)
        dev = self._device()
        return self.GenCache(torch.zeros(shape, dtype=dtype, device=dev),
                             torch.zeros(shape, dtype=dtype, device=dev),
                             torch.zeros(int(slots), dtype=torch.int32,
                                         device=dev))

    def gen_paged_cache(self, pages, page_size, dtype=torch.float32):
        """Block-paged serving decode cache: global K/V pools of ``pages``
        pages. ``table``/``pos`` are 1-element placeholders — the engine
        owns the real page table and cursors."""
        shape = (int(pages), int(page_size), self.num_heads, self.head_dim)
        dev = self._device()
        return self.PagedCache(torch.zeros(shape, dtype=dtype, device=dev),
                               torch.zeros(shape, dtype=dtype, device=dev),
                               torch.zeros((1, 1), dtype=torch.int32,
                                           device=dev),
                               torch.zeros(1, dtype=torch.int32, device=dev))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        if attn_mask is not None and not attn_mask.is_floating_point():
            attn_mask = attn_mask.to(torch.bool)   # int keep-mask
        seq_group = getattr(_cut, "group", None)
        if cache is not None or key is not query or value is not query:
            seq_group = None   # only self-attention is cut
        if seq_group is not None:
            # self-attention on a slice of a cut sequence: Ulysses over
            # the sequence group, the mask over the whole sequence
            from ..distributed import sequence_parallel as sqp
            q, k, v = sqp._ulysses_heads(q, k, v, seq_group)
        if isinstance(cache, self.PagedCache):
            # masking is positional (keys <= cursor); attn_mask is
            # ignored by contract — the paged engine passes None
            out = F.paged_attention(q, cache.k, cache.v, cache.table,
                                    cache.pos)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training)
        if seq_group is not None:
            out = sqp._heads_to_seq(out, seq_group)
        b, n = out.shape[0], out.shape[1]
        out = self.out_proj(torch.reshape(out, (b, n, -1)))
        outs = [out]
        if self.need_weights:
            outs.append(None)   # weights unavailable on the fused path
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    """Encoder block with the JAX forward (``layer_transformer.py:256-296``):
    ``x = x + dropout1(attn(norm1?(x)))``, then
    ``x = x + dropout2(linear2(dropout(act(linear1(norm2?(x))))))``, the
    norms applied before (``normalize_before``) or after each residual.
    ``attn_dropout`` and ``act_dropout`` default to ``dropout``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = bool(normalize_before)
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=dev,
                  generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)

    def gen_slot_cache(self, slots, max_seq, dtype=torch.float32):
        return self.self_attn.gen_slot_cache(slots, max_seq, dtype)

    def gen_paged_cache(self, pages, page_size, dtype=torch.float32):
        return self.self_attn.gen_paged_cache(pages, page_size, dtype)


class TransformerEncoder(Layer):
    """``encoder_layer`` and ``num_layers - 1`` deep copies of it (the
    JAX package's construction: every layer starts from the same weights,
    and the copies keep its parameters' names), then ``norm`` (a layer, or
    None) on the output (``layer_transformer.py:308-316``).

    ``enable_recompute = True`` (``ParallelEngine(recompute=True)`` sets
    it) rematerializes per block in training mode: each layer runs under
    ``fleet.utils.recompute``, so only the block inputs stay alive for
    the backward (``layer_transformer.py:334-344`` of the JAX
    package).

    ``ParallelEngine`` at ``pp > 1`` tags the encoder with its ``pp``
    group (``pipeline_group``) and micro-batch count
    (``pipeline_microbatches``), and holds on each rank only that stage's
    blocks (the others are :class:`BlockElsewhere` placeholders). Inside
    the engine's step (its ``pp`` binding of ``env.spmd_axes``) the
    forward runs the block stack as a pipeline over the ``pp`` ranks
    (:meth:`_forward_pipelined`; ``layer_transformer.py:370-455``).

    Under a binding of ``sp`` to a group of n > 1 ranks (``ParallelEngine``
    with a ``batch_spec`` that cuts the sequence over ``sp``) the forward
    takes this rank's contiguous slice of the sequence at entry (its
    backward all-gathers the slices' cotangents), runs every block on
    ``[B, S / n, H]`` with self-attention as Ulysses over the group and the
    mask over the whole sequence (:func:`sequence_parallel._ulysses_heads`;
    under ``enable_recompute`` the recomputation runs the same way), and
    gathers the output whole before ``norm`` (its backward keeps this
    rank's slice of the cotangent). The heads after it, replicated, see the
    whole sequence as on one rank."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm
        self.enable_recompute = False
        self.pipeline_group = None
        self.pipeline_microbatches = None

    def forward(self, src, src_mask=None, cache=None):
        g = self.pipeline_group
        if cache is None:
            from ..distributed import env
            if g is not None and env.current_spmd_axis("pp") is g:
                out = self._forward_pipelined(src, src_mask)
                return self.norm(out) if self.norm is not None else out
            sp = env.current_spmd_axis("sp")
            if sp is not None and sp.nranks > 1:
                out = self._forward_cut(src, src_mask, sp)
                return self.norm(out) if self.norm is not None else out
        output = src
        new_caches = []
        remat = self.enable_recompute and self.training
        for i, mod in enumerate(self.layers):
            if cache is None and remat:
                from ..distributed.fleet.utils.recompute import recompute
                output = recompute(mod, output, src_mask)
            elif cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def _forward_cut(self, src, src_mask, group):
        """The block stack on this rank's slice of the sequence over
        ``group`` (see the class), gathered whole at the end."""
        from ..distributed import sequence_parallel as sqp
        x = sqp._seq_slice(src, group)
        remat = self.enable_recompute and self.training
        for mod in self.layers:
            blk = _CutBlock(mod, group)
            if remat:
                from ..distributed.fleet.utils.recompute import recompute
                x = recompute(blk, x, src_mask)
            else:
                x = blk(x, src_mask)
        return sqp._seq_gather(x, group)

    def _forward_pipelined(self, src, src_mask=None):
        """The block stack as a pipeline over the ``pp`` ranks: the batch
        cut into ``pipeline_microbatches`` micro-batches (a per-example
        mask cut with them, a broadcastable one given to each), and this
        rank's ``num_layers // pp`` blocks as its stage
        (``distributed.pipeline.run_pipeline``). Raises where the blocks
        or the batch do not divide (``layer_transformer.py:395-409``)."""
        from ..distributed.pipeline import run_pipeline
        g = self.pipeline_group
        n_stages = g.nranks
        n_micro = int(self.pipeline_microbatches or n_stages)
        if self.num_layers % n_stages:
            raise InvalidArgumentError(
                f"pipelined encoder: {self.num_layers} blocks not "
                f"divisible into {n_stages} stages")
        bps = self.num_layers // n_stages
        b = src.shape[0]
        if b % n_micro:
            raise InvalidArgumentError(
                f"pipelined encoder: batch {b} not divisible by "
                f"{n_micro} microbatches")
        mb = b // n_micro
        micro_x = src.reshape((n_micro, mb) + tuple(src.shape[1:]))
        micro_mask = None
        if src_mask is not None:
            if src_mask.dim() >= 1 and src_mask.shape[0] == b:
                micro_mask = src_mask.reshape(
                    (n_micro, mb) + tuple(src_mask.shape[1:]))
            else:
                micro_mask = src_mask[None].expand(
                    (n_micro,) + tuple(src_mask.shape))
        stage = _PipelineStage(
            [self.layers[i] for i in range(g.rank * bps,
                                           (g.rank + 1) * bps)],
            self.enable_recompute and self.training)
        names, params = zip(*stage.named_parameters())

        def stage_fn(tree, x, mask=None):
            return torch.func.functional_call(stage, tree, (x, mask))
        out = run_pipeline(stage_fn, list(params), micro_x, micro_mask,
                           group=g,
                           unflatten=lambda vals: dict(zip(names, vals)))
        return out.reshape((b,) + tuple(out.shape[2:]))

    def gen_cache(self, src):
        """One empty :attr:`MultiHeadAttention.Cache` a layer."""
        return [layer.gen_cache(src) for layer in self.layers]

    def gen_slot_cache(self, slots, max_seq, dtype=torch.float32):
        return [layer.gen_slot_cache(slots, max_seq, dtype)
                for layer in self.layers]

    def gen_paged_cache(self, pages, page_size, dtype=torch.float32):
        return [layer.gen_paged_cache(pages, page_size, dtype)
                for layer in self.layers]


class _PipelineStage(torch.nn.Module):
    """A rank's blocks of a pipelined encoder, run in order (each under
    ``fleet.utils.recompute`` with ``remat``): the stage function's
    module, which ``functional_call`` binds to the step's tensors."""

    def __init__(self, blocks, remat: bool):
        super().__init__()
        self.blocks = torch.nn.ModuleList(blocks)
        self.remat = remat

    def forward(self, x, mask=None):
        for blk in self.blocks:
            if self.remat:
                from ..distributed.fleet.utils.recompute import recompute
                x = recompute(blk, x, mask)
            else:
                x = blk(x, mask)
        return x


class _CutBlock(torch.nn.Module):
    """A block run on a slice of a sequence cut over ``group``: its
    self-attention is Ulysses over the group (``_sequence_cut``), in the
    forward and in a recomputation inside the backward alike."""

    def __init__(self, block, group):
        super().__init__()
        self.block = block
        self.group = group

    def forward(self, x, mask=None):
        with _sequence_cut(self.group):
            return self.block(x, mask)


class BlockElsewhere(torch.nn.Module):
    """The place of a pipelined encoder's block that another ``pp`` rank
    holds (``ParallelEngine`` at ``pp > 1``): it has no tensors, and
    running it raises."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def forward(self, *args, **kwargs):
        raise InvalidArgumentError(
            f"this encoder block is held by pp stage {self.stage}; "
            "ParallelEngine.sync_model() gathers the stages")


class TransformerDecoderLayer(Layer):
    """Decoder block with the JAX forward (``layer_transformer.py:
    463-530``): self-attention under ``tgt_mask``, cross-attention on
    ``memory`` under ``memory_mask``, then the feed-forward, each a
    residual with its dropout and norm (before or after, as
    ``normalize_before`` says). With ``cache`` (``(Cache, StaticCache)``,
    from :meth:`gen_cache`) the self-attention grows its cache and the
    cross-attention reads the memory's projections; it returns ``(out,
    (new Cache, StaticCache))``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = bool(normalize_before)
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=dev,
                  generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)
        self.norm3 = LayerNorm(d_model, device=dev)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static = self.cross_attn(tgt, memory, memory, memory_mask,
                                          cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, static))

    def gen_cache(self, memory):
        """``(Cache, StaticCache)``: an empty self-attention cache and the
        cross-attention's projections of ``memory``."""
        incremental = self.self_attn.gen_cache(
            memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    """``decoder_layer`` and ``num_layers - 1`` deep copies of it, then
    ``norm`` on the output (``layer_transformer.py:532-562``)."""

    def __init__(self, decoder_layer: TransformerDecoderLayer,
                 num_layers: int, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] +
            [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One ``(Cache, StaticCache)`` a layer; ``do_zip``: the list of
        Caches and the list of StaticCaches instead."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    """Encoder-decoder transformer (``layer_transformer.py:564-608``; the
    defaults are Transformer-base): a ``TransformerEncoder`` and a
    ``TransformerDecoder`` of the given depths, each with a final
    LayerNorm only when ``normalize_before``; ``custom_encoder`` /
    ``custom_decoder`` replace them."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, custom_encoder=None, custom_decoder=None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        kw = dict(device=dev, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, device=dev) if normalize_before \
                else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, device=dev) if normalize_before \
                else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The additive causal mask ``[length, length]``: 0 on and below
        the diagonal, -inf above, float32 on the model's device."""
        from ..core.tensor import to_tensor
        params = self.parameters()
        m = np.triu(np.full((length, length), -np.inf, np.float32), 1)
        return to_tensor(m, place=params[0].device if params else None)
