"""Seq2seq decoding (port of ``paddle1_tpu/nn/decode.py``, its whole
``__all__``): ``dynamic_decode``, ``BeamSearchDecoder``, ``BasicDecoder``,
the helpers, and the token samplers.

``dynamic_decode`` is the JAX package's eager loop: each step runs the
decoder's cell on the device, and the host reads one boolean (every entry
finished?) before the next. ``BeamSearchDecoder`` keeps its states split
``[B, beam, ...]`` between steps and merges them ``[B * beam, ...]``
around the cell; states are nested lists, tuples and namedtuples of
tensors (a Transformer decoder's ``[(Cache, StaticCache)] * L``), mapped
leaf by leaf (:func:`_map_structure`) through the merge, the split, the
beam gather and ``impute_finished``. The beam step is a log-softmax, the
finished beams' one frozen candidate (the end token at score 0), and a
top-k over ``beam x vocab`` scores whose ties take the lowest flat index
first, as ``jax.lax.top_k`` does (a stable descending sort).

Token sampling: ``greedy_logits_array`` and ``sample_logits_array`` have
the JAX package's semantics (``temperature <= 0`` is a per-row argmax of
the raw logits; ``top_k > 0`` keeps the values ``>=`` the k-th largest,
ties included, before the draw). Draws come from explicit
``torch.Generator``s (Philox on CUDA) through the Gumbel-max trick, one
``[V]`` uniform draw per sampled row. JAX's threefry keys cannot be
reproduced, so sampled tokens agree with the JAX package in distribution,
not in bits; within the port a row's draw depends only on its own
generator's state.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from ..core.tensor import _wrap, to_tensor

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode",
           "DecodeHelper", "TrainingHelper", "GreedyEmbeddingHelper",
           "SampleEmbeddingHelper", "BasicDecoder",
           "sample_logits_array", "greedy_logits_array"]

GeneratorArg = Union[torch.Generator, Sequence[Optional[torch.Generator]],
                     None]


def greedy_logits_array(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis (first index on ties)."""
    return torch.argmax(logits, dim=-1)


def _uniform(logits: torch.Tensor, generator: GeneratorArg) -> torch.Tensor:
    """``[..., V]`` uniforms in (0, 1). One generator draws the whole
    batch; a sequence gives row r its own generator (None = the row needs
    no draw and gets a constant)."""
    if generator is None or isinstance(generator, torch.Generator):
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
    else:
        rows = logits.reshape(-1, logits.shape[-1])
        if len(generator) != rows.shape[0]:
            raise ValueError(f"{len(generator)} generators for "
                             f"{rows.shape[0]} rows")
        half = torch.full((rows.shape[-1],), 0.5, device=logits.device)
        u = torch.stack([
            half if g is None else torch.rand(
                rows.shape[-1], generator=g, device=logits.device,
                dtype=torch.float32)
            for g in generator]).reshape(logits.shape)
    tiny = torch.finfo(torch.float32).tiny
    return u.clamp(min=tiny, max=1.0 - 2 ** -24)


def sample_logits_array(logits: torch.Tensor, generator: GeneratorArg,
                        temperature=1.0, top_k=0) -> torch.Tensor:
    """Temperature/top-k sampling over the last axis of ``logits``.

    ``temperature``/``top_k`` may be Python scalars or tensors
    broadcastable to ``logits.shape[:-1]`` (the engine's per-slot form).
    ``generator``: one ``torch.Generator`` for the batch, or one per row
    (None for rows that are greedy)."""
    t_static = isinstance(temperature, (int, float))
    if t_static and temperature <= 0 and isinstance(top_k, int):
        return greedy_logits_array(logits)
    batch = logits.shape[:-1]
    v = logits.shape[-1]
    t = torch.as_tensor(temperature, dtype=logits.dtype,
                        device=logits.device).broadcast_to(batch)
    scaled = logits / t.clamp(min=1e-6)[..., None]
    if isinstance(top_k, int) and top_k <= 0:
        masked = scaled
    else:
        tk = torch.as_tensor(top_k, dtype=torch.long,
                             device=logits.device).broadcast_to(batch)
        srt = torch.sort(logits, dim=-1).values
        kth = torch.gather(srt, -1, (v - tk).clamp(0, v - 1)[..., None])
        neg = torch.finfo(logits.dtype).min
        masked = torch.where((tk[..., None] > 0) & (logits < kth),
                             torch.full((), neg, dtype=logits.dtype,
                                        device=logits.device), scaled)
    gumbel = -torch.log(-torch.log(_uniform(logits, generator)))
    sampled = torch.argmax(masked + gumbel.to(masked.dtype), dim=-1)
    if t_static:  # statically > 0: the greedy branch is dead
        return sampled
    return torch.where(t <= 0, greedy_logits_array(logits), sampled)


# -- nested structures -------------------------------------------------------

def _map_structure(fn, *structs):
    """``fn`` over the leaves (tensors) of parallel nested lists, tuples,
    namedtuples and dicts, the structure kept."""
    s0 = structs[0]
    if isinstance(s0, (list, tuple)):
        mapped = [_map_structure(fn, *elems) for elems in zip(*structs)]
        if isinstance(s0, tuple) and hasattr(s0, "_fields"):
            return type(s0)(*mapped)
        return type(s0)(mapped)
    if isinstance(s0, dict):
        return {k: _map_structure(fn, *(s[k] for s in structs)) for k in s0}
    return fn(*structs)


def _flatten_structure(s, out=None):
    out = [] if out is None else out
    if isinstance(s, (list, tuple)):
        for e in s:
            _flatten_structure(e, out)
    elif isinstance(s, dict):
        for k in s:
            _flatten_structure(s[k], out)
    else:
        out.append(s)
    return out


def _first_leaf(s):
    return _flatten_structure(s)[0]


def _as_tensor(v, dtype, device=None):
    if isinstance(v, torch.Tensor):
        return v
    return to_tensor(np.asarray(v, dtype), place=device)


# -- the decoder interface ---------------------------------------------------

class Decoder:
    """What ``dynamic_decode`` drives: ``initialize``, ``step``,
    ``finalize`` and ``tracks_own_finished``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a ``cell`` (``paddle1_tpu/nn/decode.py:149-293``).

    ``cell(inputs, states, **kwargs) -> (outputs, new_states)`` on merged
    ``[B * beam, ...]`` tensors; ``output_fn`` maps its outputs to vocab
    logits, ``embedding_fn`` the chosen ids to the next step's inputs (the
    ids themselves when absent). At the start only beam 0 is live (the
    others at -1e9), so the first top-k picks distinct tokens.

    ``candidates``: the last step's best ``2 * beam`` candidates in rank
    order, ``(scores, flat indices)`` of ``[B, 2 * beam]`` over ``beam x
    vocab`` (views of the step's sort; the first ``beam`` are the step's
    choices), for a caller that inspects the ranking."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[B, ...]`` → ``[B * beam, ...]``, each row repeated ``beam``
        times in place (the encoder's output in the beam layout), over a
        nested structure."""
        return _map_structure(
            lambda a: torch.repeat_interleave(a, beam_size, dim=0), x)

    def _split_batch_beams(self, x):
        return x.reshape(x.shape[0] // self.beam_size, self.beam_size,
                         *x.shape[1:])

    def _merge_batch_beams(self, x):
        # explicit sizes: an empty Cache ([B, beam, 0, heads, dim], the
        # first step's) has no -1 to infer; the JAX package's reshape
        # raises there (ROADMAP Queue 3, notes on the reference)
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])

    def _expand_to_beam_size(self, x):
        return torch.repeat_interleave(x.unsqueeze(1), self.beam_size, dim=1)

    def _gather_by_parent(self, x, parents):
        """``x [B, beam, ...]`` gathered along the beam axis by ``parents
        [B, beam]``."""
        idx = parents.reshape(*parents.shape, *(1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(*parents.shape, *x.shape[2:]))

    def initialize(self, initial_cell_states):
        first = _first_leaf(initial_cell_states)
        b, k, dev = int(first.shape[0]), self.beam_size, first.device
        cell_states = _map_structure(self._expand_to_beam_size,
                                     initial_cell_states)
        start = torch.full((b, k), self.start_token, dtype=torch.int64,
                           device=dev)
        inputs = self.embedding_fn(start) if self.embedding_fn else start
        lp = torch.full((b, k), -1e9, dtype=torch.float32, device=dev)
        lp[:, 0] = 0.0
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        state = self.StateWrapper(cell_states, lp, finished,
                                  torch.zeros((b, k), dtype=torch.int64,
                                              device=dev))
        return inputs, state, finished

    def _beam_search_step(self, time, logits, next_cell_states, beam_state):
        k, end = self.beam_size, self.end_token
        b, _, v = logits.shape
        step_lp = torch.log_softmax(logits, dim=-1)
        fin = beam_state.finished
        # a finished beam's one candidate: the end token at score 0
        noend = torch.full((v,), -1e9, dtype=step_lp.dtype,
                           device=step_lp.device)
        if -v <= end < v:   # an id past the vocabulary ends no beam
            noend[end] = 0.0
        step_lp = torch.where(fin[..., None], noend, step_lp)
        flat = (beam_state.log_probs[..., None] + step_lp).reshape(b, -1)
        # jax.lax.top_k's order: the larger score first, on a tie the lower
        # flat index
        top_sc, top_ix = torch.sort(flat, dim=-1, descending=True,
                                    stable=True)
        self.candidates = (top_sc[:, :2 * k], top_ix[:, :2 * k])
        top_sc, top_ix = top_sc[:, :k], top_ix[:, :k]
        parents = torch.div(top_ix, v, rounding_mode="floor")
        tokens = top_ix % v
        par_fin = torch.gather(fin, 1, parents)
        par_len = torch.gather(beam_state.lengths, 1, parents)
        next_fin = par_fin | (tokens == end)
        next_len = par_len + (~par_fin).to(torch.int64)
        next_cell_states = _map_structure(
            lambda s: self._gather_by_parent(s, parents), next_cell_states)
        return (self.OutputWrapper(top_sc, tokens, parents),
                self.StateWrapper(next_cell_states, top_sc, next_fin,
                                  next_len))

    def step(self, time, inputs, states, **kwargs):
        merged_inputs = _map_structure(self._merge_batch_beams, inputs)
        merged_states = _map_structure(self._merge_batch_beams,
                                       states.cell_states)
        cell_outputs, next_cell_states = self.cell(merged_inputs,
                                                   merged_states, **kwargs)
        cell_outputs = _map_structure(self._split_batch_beams, cell_outputs)
        next_cell_states = _map_structure(self._split_batch_beams,
                                          next_cell_states)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        out, state = self._beam_search_step(time, cell_outputs,
                                            next_cell_states, states)
        ids = out.predicted_ids
        next_inputs = self.embedding_fn(ids) if self.embedding_fn else ids
        return out, state, next_inputs, state.finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """The final beams' token sequences, traced back through the
        parents (``F.gather_tree``)."""
        from .functional.common import gather_tree
        return gather_tree(outputs.predicted_ids, outputs.parent_ids), \
            final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` until every entry is finished, or until the step
    that passes ``max_step_num`` (``paddle1_tpu/nn/decode.py:296-348``:
    the loop breaks after that step, not before it). The steps' outputs
    are stacked over time, ``decoder.finalize`` runs on the time-major
    stack, and the result is batch-major unless ``output_time_major``.
    ``impute_finished`` keeps a finished entry's states as they were.
    Returns ``(outputs, states)`` as Paddle tensors, and the lengths too
    with ``return_length``."""
    inputs, states, finished = decoder.initialize(inits)
    lengths = torch.zeros_like(finished, dtype=torch.int64)
    acc = []
    step = 0
    while not bool(finished.all()):
        outputs, next_states, next_inputs, next_finished = decoder.step(
            step, inputs, states, **kwargs)
        if not decoder.tracks_own_finished:
            next_finished = next_finished | finished
            lengths = lengths + (~finished).to(torch.int64)
            if impute_finished:
                next_states = _map_structure(
                    lambda old, new: _where_mask(finished, old, new),
                    states, next_states)
        else:
            lengths = getattr(next_states, "lengths", lengths)
        acc.append(outputs)
        inputs, states, finished = next_inputs, next_states, next_finished
        step += 1
        if max_step_num is not None and step > max_step_num:
            break
    if not acc:
        raise InvalidArgumentError(
            "dynamic_decode made no steps: every entry was finished at "
            "initialization (check sequence_length / max_step_num)")
    final_outputs = _map_structure(lambda *ts: torch.stack(ts, 0), *acc)
    final_states = states
    try:
        final_outputs, final_states = decoder.finalize(
            final_outputs, final_states, lengths)
    except NotImplementedError:
        pass
    if not output_time_major:
        final_outputs = _map_structure(lambda t: t.transpose(0, 1),
                                       final_outputs)
    # Paddle tensors, as the reference returns, whatever the cell made
    final_outputs, final_states = _map_structure(
        _wrap, (final_outputs, final_states))
    if return_length:
        return final_outputs, final_states, _wrap(lengths)
    return final_outputs, final_states


def _where_mask(mask, a, b):
    """``a`` where ``mask`` ([B] or [B, beam], broadcast over the trailing
    dims), else ``b``."""
    return torch.where(mask.reshape(*mask.shape, *(1,) * (a.dim() -
                                                          mask.dim())), a, b)


# -- the helpers -------------------------------------------------------------

class DecodeHelper:
    """What ``BasicDecoder`` asks of a helper: ``initialize``, ``sample``
    and ``next_inputs``."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing: step ``t`` reads ``inputs[:, t]`` (``[t]`` when
    ``time_major``; past the last step, the last), and an entry is
    finished once ``t`` reaches its ``sequence_length``."""

    def __init__(self, inputs, sequence_length, time_major=False):
        self.inputs = inputs
        first = _first_leaf(inputs)
        self.sequence_length = _as_tensor(sequence_length, np.int64,
                                          first.device)
        self.time_major = time_major
        self._axis = 0 if time_major else 1
        self._T = int(first.shape[self._axis])

    def _slice(self, time):
        t = min(time, self._T - 1)
        return _map_structure(lambda x: x.select(self._axis, t), self.inputs)

    def initialize(self):
        return self._slice(0), self.sequence_length <= 0

    def sample(self, time, outputs, states):
        return torch.argmax(outputs, dim=-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        return self.sequence_length <= time + 1, self._slice(time + 1), \
            states


class GreedyEmbeddingHelper(DecodeHelper):
    """Argmax sampling fed back through ``embedding_fn``; an entry is
    finished on ``end_token``."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = _as_tensor(start_tokens, np.int64)
        self.end_token = int(end_token)

    def initialize(self):
        b = int(self.start_tokens.shape[0])
        return (self.embedding_fn(self.start_tokens),
                torch.zeros(b, dtype=torch.bool,
                            device=self.start_tokens.device))

    def sample(self, time, outputs, states):
        return greedy_logits_array(outputs)

    def next_inputs(self, time, outputs, states, sample_ids):
        return sample_ids == self.end_token, self.embedding_fn(sample_ids), \
            states


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Draws from ``softmax(logits / softmax_temperature)`` (1 when None).
    With ``seed``, step ``t`` draws from a generator seeded ``seed + t``
    (reproducible, as the JAX package's ``key(seed + t)``); else from
    ``generator`` (the device's default generator when None)."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.softmax_temperature = softmax_temperature
        self.seed = seed
        self.generator = generator

    def sample(self, time, outputs, states):
        gen = self.generator
        if self.seed is not None:
            gen = torch.Generator(outputs.device).manual_seed(
                int(self.seed) + int(time))
        temp = self.softmax_temperature
        return sample_logits_array(outputs, gen,
                                   1.0 if temp is None else temp)


class BasicDecoder(Decoder):
    """A cell and a helper as one decode step: run the cell, project with
    ``output_fn``, sample, and let the helper choose the next inputs; a
    step's outputs are ``(cell_outputs, sample_ids)``."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("cell_outputs", "sample_ids"))

    def __init__(self, cell, helper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        initial_inputs, initial_finished = self.helper.initialize()
        return initial_inputs, initial_cell_states, initial_finished

    def step(self, time, inputs, states, **kwargs):
        cell_outputs, cell_states = self.cell(inputs, states, **kwargs)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        sample_ids = self.helper.sample(time, cell_outputs, cell_states)
        finished, next_inputs, next_states = self.helper.next_inputs(
            time, cell_outputs, cell_states, sample_ids)
        return (self.OutputWrapper(cell_outputs, sample_ids), next_states,
                next_inputs, finished)
