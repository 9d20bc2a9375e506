"""Generative serving: KV-cache decode with slot-based continuous batching
and per-token streaming (port of ``paddle1_tpu/serving/generate.py``).

Design, as in the JAX package:

* **Prefill/decode split.** Prefill runs the whole prompt, padded to its
  prompt-length bucket (``serve_gen_prefill_buckets``), in one causal
  pass. Decode advances EVERY active slot by one window per step; its
  shapes are pinned to ``[slots]`` state and (paged) a fixed
  ``[slots, pages_per_slot]`` page table, so ragged arrivals and any
  active-slot pattern run the same shapes (a later PR can capture the
  step in a CUDA graph; this one runs eagerly).
* **Device-resident KV cache**, dense (``[slots, max_seq, heads, dim]``
  per layer) or block-paged (``[pages, page_size, heads, dim]`` pools +
  page table, ``serve_gen_paged``), written IN PLACE at a per-slot
  cursor, in ``cache_dtype`` (``"float32"``, ``"bfloat16"``,
  ``"float16"`` or a ``torch.dtype``). Paged decode attention is the
  hand-written CUDA kernel (``ops/paged_attention.py``); every LayerNorm
  is the CUDA LayerNorm kernel (``ops/layer_norm.py``).
* **Slot-based continuous batching.** New requests claim free slots
  between decode steps as finished ones release theirs; a slot's rows
  are never read by another slot.
* **Speculative decoding** (``spec_tokens=k``). The decode window is
  ``[fed token, draft_1..draft_k]`` in one forward, so rows 1 and 2 run
  once per layer per window whatever k is. Row i's sample is produced
  iff every earlier draft equals the sample of its row (the chain
  verify, on the device); drafts come from a per-request
  :class:`~.speculate.NGramSpeculator`. Rejected drafts' K/V rows land
  past the new cursor and the next window overwrites them before any
  mask shows them.
* **int8 decode weights** (``int8=True``). Every Linear weight is stored
  on the device as per-output-channel int8 codes + f32 scales
  (``quantization.quantize_weights_int8``) and dequantized inside each
  prefill and decode step in plain torch ops; the model then runs on the
  dequantized weights through ``torch.func.functional_call``. The
  matmuls stay ``torch.matmul``, as the JAX package leaves them to XLA.
* **The sampling schedule.** A sampled token is drawn by the Gumbel-max
  trick from one ``[V]`` uniform draw of a ``torch.Generator`` (Philox
  on the card) seeded afresh for each (request seed, token index) pair:
  :meth:`GenerationEngine.resume_key` mixes the two with splitmix64.
  The draw for token i therefore depends only on (seed, i), never on
  the slot, the neighbours, how many drafts a window verified, or where
  the stream was interrupted; so speculative == non-speculative,
  resumed == uninterrupted, parked and re-admitted == never parked, and
  alone == batched, greedy and sampled. (The JAX package's threefry
  keys follow the same schedule through ``fold_in``; the two give other
  bits, so sampled tokens agree with it in distribution only.) A
  sequential per-request generator was the alternative: under
  speculation it would advance W times per window but keep only the
  accepted draws, and a resumed stream would have to replay every
  earlier draw.
* **Per-token streaming** with a bounded per-stream buffer as
  backpressure, admission/deadline/shed/drain with token accounting:
  ``tokens_generated == tokens_streamed + tokens_dropped`` and
  ``unaccounted == 0`` in every drain report; paged mode adds
  ``kv_pages_owed == 0``.
* **KV-pressure preemption** (``GenerationServer(preempt=True)``, paged
  only): a decode-time page fault parks the lowest-priority stream (its
  pages released the same tick) and re-admits it later from ``prompt +
  tokens already emitted`` at the next token's draw; admission defers
  prefills above ``serve_gen_pressure_ceiling``. ``resume_tokens=`` is
  the same replay entered by a client (mid-stream failover).
* **Chaos points** ``gen_slot_wedge``, ``gen_slow_step`` and
  ``gen_page_pressure`` (``core.chaos``), and the SIGTERM drain through
  ``core.health``.

Left out (see ROADMAP): the cost/HBM census (``decode_cost``,
``prefill_cost``) and CUDA-graph capture of the decode step.

Quickstart::

    lm = CausalLM(vocab_size=32000, d_model=512, nhead=8,
                  num_layers=12, max_seq=512)           # on cuda
    eng = GenerationEngine(lm, slots=16, max_seq=512, eos_id=2,
                           paged=True, page_size=16, spec_tokens=4)
    srv = GenerationServer(eng).start()
    stream = srv.submit(prompt_ids, max_new_tokens=128, temperature=0.8,
                        top_k=40, seed=7)
    for tok in stream:          # per-token, as they decode
        print(tok)
    srv.drain()                 # unaccounted == 0, kv_pages_owed == 0
"""

from __future__ import annotations

import bisect
import collections
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import chaos as core_chaos
from ..core import flags as core_flags
from ..core import health as core_health
from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError
from ..nn import (Embedding, Linear, MultiHeadAttention, TransformerEncoder,
                  TransformerEncoderLayer)
from ..nn.decode import greedy_logits_array, sample_logits_array
from ..nn.layer_base import Layer
from ..obs import events as obs_events
from .engine import resolve_buckets
from .errors import (DeadlineExceeded, KVPoolExhausted, ServerClosed,
                     ServerOverloaded, SlotWedged, StreamCancelled)
from .metrics import ServingMetrics
from .paging import PARKING_PAGE, PagePool
from .speculate import NGramSpeculator

__all__ = ["CausalLM", "GenerationEngine", "GenerationServer",
           "TokenStream", "eager_generate"]

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _cache_dtype(d) -> torch.dtype:
    """The JAX package's dtype strings (``"float32"``, ``"bfloat16"``,
    ``"float16"``) or a ``torch.dtype`` → the KV cache's torch dtype."""
    out = convert_dtype(d)
    if out not in (torch.float32, torch.bfloat16, torch.float16):
        raise InvalidArgumentError(
            f"cache_dtype must be float32, bfloat16 or float16, got {d!r}")
    return out


def token_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator that draws token ``index`` (0 = the prefill's
    token) of the stream seeded ``seed``: one ``[V]`` uniform draw of it
    samples that token (see the module docstring)."""
    g = torch.Generator(device=device)
    g.manual_seed(GenerationEngine.resume_key(seed, index))
    return g


# ---------------------------------------------------------------------------
# reference model


class CausalLM(Layer):
    """Small decoder-only transformer LM: token + learned position
    embeddings, a post-norm ``TransformerEncoder`` under a causal mask,
    and a vocabulary head. The generation engine's reference model; any
    module with ``gen_slot_cache`` / ``gen_paged_cache`` and
    ``forward(ids, cache=, positions=, attn_mask=)`` returning
    ``(logits, new_cache)`` when a cache is passed can be served. The
    eager concat-cache path (``empty_cache``) drives :func:`eager_generate`.

    Weights are drawn on the CPU from ``generator`` (Paddle's
    initializers) and moved to ``device`` (default ``cuda``)."""

    def __init__(self, vocab_size: int, d_model: int = 64, nhead: int = 4,
                 dim_feedforward: int = 128, num_layers: int = 2,
                 max_seq: int = 256, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.max_seq = int(max_seq)
        self.embed = Embedding(self.vocab_size, d_model, device=dev,
                               generator=generator)
        self.pos_embed = Embedding(self.max_seq, d_model, device=dev,
                                   generator=generator)
        layer = TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                        dropout=0.0, device=dev,
                                        generator=generator)
        self.encoder = TransformerEncoder(layer, num_layers)
        self.head = Linear(d_model, self.vocab_size, device=dev,
                           generator=generator)

    def gen_slot_cache(self, slots, max_seq, dtype="float32"):
        return self.encoder.gen_slot_cache(slots, max_seq,
                                           _cache_dtype(dtype))

    def gen_paged_cache(self, pages, page_size, dtype="float32"):
        return self.encoder.gen_paged_cache(pages, page_size,
                                            _cache_dtype(dtype))

    def empty_cache(self, batch):
        """Eager incremental-decode cache (the concat-based ``Cache``
        path :func:`eager_generate` drives)."""
        w = self.embed.weight
        return self.encoder.gen_cache(
            torch.zeros((int(batch), 1), dtype=w.dtype, device=w.device))

    def forward(self, ids, cache=None, positions=None, attn_mask=None):
        b, n = ids.shape[0], ids.shape[1]
        off = 0
        if cache is not None and isinstance(cache[0],
                                            MultiHeadAttention.Cache):
            off = int(cache[0].k.shape[1])
        if positions is None:
            positions = torch.arange(off, off + n,
                                     device=ids.device).expand(b, n)
        x = self.embed(ids) + self.pos_embed(positions.long())
        paged = (cache is not None and len(cache) > 0 and
                 isinstance(cache[0], MultiHeadAttention.PagedCache))
        if not paged and attn_mask is None and n > 1:
            # causal over the (cached + new) keys: the no-cache forward
            # and the eager concat-cache prefill (a paged decode derives
            # its masking from the cursor instead)
            j = torch.arange(off + n, device=ids.device)[None, :]
            i = torch.arange(n, device=ids.device)[:, None]
            attn_mask = (j <= off + i)[None, None]
        out = self.encoder(x, attn_mask, cache)
        if cache is None:
            return self.head(out)
        h, new_caches = out
        return self.head(h), new_caches


# ---------------------------------------------------------------------------
# token stream


class TokenStream:
    """Per-request streaming handle: iterate tokens as they decode.

    The engine side ``_put``s tokens and ``_finish``es the stream
    (first-wins); the client iterates (``for tok in stream``), collects
    (``result()``), or ``cancel()``s. The buffer of *unconsumed* tokens
    is bounded (``serve_gen_stream_buffer``): when full, the scheduler
    parks the slot until the client drains it.

    ``finish_reason``: ``"eos"`` | ``"length"`` | ``"deadline"`` |
    ``"budget"`` (server token budget cut the stream short — typed) |
    ``"cancelled"`` | ``"error"``.
    """

    def __init__(self, buffer_cap: int):
        self._cond = threading.Condition()
        self._cap = int(buffer_cap)
        self._buf: collections.deque = collections.deque()
        self._all: List[int] = []
        self._done = False
        self._exc: Optional[BaseException] = None
        self._cancel_requested = False
        self.finish_reason: Optional[str] = None

    # -- engine side --------------------------------------------------------

    def _writable(self) -> bool:
        return len(self._buf) < self._cap

    def _put(self, tok: int) -> bool:
        with self._cond:
            if self._done:
                return False
            self._buf.append(int(tok))
            self._all.append(int(tok))
            self._cond.notify_all()
        return True

    def _finish(self, reason: str,
                exc: Optional[BaseException] = None) -> bool:
        with self._cond:
            if self._done:
                return False
            self._done = True
            self.finish_reason = reason
            self._exc = exc
            self._cond.notify_all()
        return True

    # -- client side --------------------------------------------------------

    def cancel(self) -> None:
        """Ask the scheduler to release this request's slot at the next
        step boundary; no further tokens stream. Idempotent."""
        with self._cond:
            self._cancel_requested = True
            self._cond.notify_all()

    def done(self) -> bool:
        return self._done

    @property
    def tokens(self) -> List[int]:
        """Every token streamed so far (a snapshot copy)."""
        with self._cond:
            return list(self._all)

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        with self._cond:
            while True:
                if self._buf:
                    tok = self._buf.popleft()
                    self._cond.notify_all()
                    return tok
                if self._done:
                    # buffered tokens drain first; a typed failure
                    # surfaces after everything generated before it
                    if self._exc is not None and \
                            self.finish_reason != "cancelled":
                        raise self._exc
                    raise StopIteration
                self._cond.wait()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream finishes; the full token list. Raises
        the stream's typed error. Drains the bounded buffer while waiting,
        so a parked slot resumes — don't mix it with iteration."""
        with self._cond:
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while not self._done:
                if self._buf:
                    self._buf.clear()
                    self._cond.notify_all()
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise DeadlineExceeded(
                        f"TokenStream not finished within {timeout}s — "
                        "the request is still decoding (reader deadline "
                        "only; the stream stays accounted)")
                self._cond.wait(rem)
            if self._exc is not None:
                raise self._exc
            return list(self._all)


class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "top_k", "seed",
                 "stream", "deadline", "t_enq", "truncated_by_budget",
                 "slot", "n_generated", "t_first", "spec",
                 "priority", "resumed", "emitted", "preempted")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 temperature: float, top_k: int, seed: int,
                 deadline_s: Optional[float], stream: TokenStream,
                 truncated_by_budget: bool, priority: int = 0,
                 resumed: int = 0):
        # `prompt` includes any previously emitted tokens a failover
        # replays (`resumed` = how many of its tail are replayed output,
        # not client prompt); `emitted` tracks the tokens THIS server
        # produced, so a park's re-admission can extend the replay
        self.prompt = prompt
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.stream = stream
        self.t_enq = time.monotonic()
        self.deadline = (self.t_enq + deadline_s if deadline_s else None)
        self.truncated_by_budget = truncated_by_budget
        self.slot = -1
        self.priority = int(priority)
        self.resumed = int(resumed)
        self.n_generated = int(resumed)
        self.emitted: List[int] = []
        self.preempted = 0
        self.t_first = 0.0
        self.spec = None  # per-request speculator (engine.spec_tokens > 0)


# ---------------------------------------------------------------------------
# engine


class GenerationEngine:
    """Device state and steps of the decode loop.

    Owns the per-layer KV cache (dense or paged) and the per-slot
    cursor/token/sampling state. :meth:`prefill` runs one prompt (padded
    to its length bucket) into a slot and samples the first token;
    :meth:`decode` advances EVERY active slot by one window (the fed
    token plus ``spec_tokens`` drafts). Slot scheduling lives in
    :class:`GenerationServer`; the engine is purely the device side. The
    engine runs on the model's device.
    """

    def __init__(self, model, slots: Optional[int] = None,
                 max_seq: Optional[int] = None, prefill_buckets=None,
                 eos_id: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 cache_dtype="float32",
                 paged: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 pages: Optional[int] = None,
                 prefix_cache: Optional[int] = None,
                 spec_tokens: Optional[int] = None,
                 int8: Optional[bool] = None):
        self.metrics = metrics
        self.slots = int(slots if slots is not None
                         else core_flags.flag("serve_gen_slots"))
        self.max_seq = int(max_seq if max_seq is not None
                           else core_flags.flag("serve_gen_max_seq"))
        if self.slots < 1 or self.max_seq < 2:
            raise InvalidArgumentError(
                f"need slots >= 1 and max_seq >= 2, got "
                f"{self.slots}/{self.max_seq}")
        self.paged = bool(core_flags.flag("serve_gen_paged")
                          if paged is None else paged)
        self.spec_tokens = int(core_flags.flag("serve_gen_spec_tokens")
                               if spec_tokens is None else spec_tokens)
        if self.spec_tokens < 0:
            raise InvalidArgumentError(
                f"spec_tokens must be >= 0, got {self.spec_tokens}")
        # decode window: the fed token + k drafts verified per step. Every
        # window write spans `window` rows, so sequences stop
        # `decode_margin` short of max_seq (enforced at admission)
        self.window = 1 + self.spec_tokens
        self.decode_margin = self.window - 1
        if self.max_seq <= self.decode_margin + 1:
            raise InvalidArgumentError(
                f"max_seq={self.max_seq} leaves no room under a "
                f"speculative window of {self.window} (margin "
                f"{self.decode_margin}) — shrink serve_gen_spec_tokens")
        self.int8 = bool(core_flags.flag("serve_gen_int8")
                         if int8 is None else int8)
        self.cache_dtype = _cache_dtype(cache_dtype)
        self.prefill_buckets = self._resolve_prefill_buckets(
            prefill_buckets, self.max_seq)
        self.eos_id = None if eos_id is None else int(eos_id)
        needed_cache = "gen_paged_cache" if self.paged \
            else "gen_slot_cache"
        if not hasattr(model, needed_cache):
            raise InvalidArgumentError(
                "GenerationEngine needs a model with the generation "
                f"contract: {needed_cache}(...) and "
                "forward(ids, cache=, positions=, attn_mask=) -> "
                f"(logits, new_cache); got {type(model).__name__}")
        model_cap = getattr(model, "max_seq", None)
        if model_cap is not None and int(model_cap) < self.max_seq:
            raise InvalidArgumentError(
                f"engine max_seq={self.max_seq} exceeds the model's "
                f"positional capacity (model.max_seq={int(model_cap)}) — "
                "build the model with max_seq >= the engine's")
        model.eval()
        self._model = model
        self.device = next(iter(model.parameters())).device
        # int8: the per-channel codes and scales the steps dequantize
        # (None: the model runs on its own weights)
        self._params = None
        if self.int8:
            from ..quantization import quantize_weights_int8
            with torch.no_grad():
                self._params = quantize_weights_int8(
                    {k: v.detach() for k, v in model.state_dict().items()})
        self._lock = threading.Lock()
        self.decode_dispatch_count = 0
        self.prefill_dispatch_counts: Dict[int, int] = {}

        dev = self.device
        if self.paged:
            self.page_size = int(
                page_size if page_size is not None
                else core_flags.flag("serve_gen_kv_page_size"))
            if self.page_size < 1:
                raise InvalidArgumentError(
                    f"page_size must be >= 1, got {self.page_size}")
            self.pages_per_slot = -(-self.max_seq // self.page_size)
            n_pages = int(pages if pages is not None
                          else core_flags.flag("serve_gen_kv_pages"))
            if n_pages <= 0:
                # auto: worst case every slot dense, + the parking page
                n_pages = self.slots * self.pages_per_slot + 1
            prefix_entries = int(
                prefix_cache if prefix_cache is not None
                else core_flags.flag("serve_gen_prefix_cache"))
            self.pool = PagePool(n_pages, self.page_size, prefix_entries)
            cache = model.gen_paged_cache(n_pages, self.page_size,
                                          self.cache_dtype)
            # host-authoritative page table, mirrored to the device on
            # change; rows are parking-filled beyond a slot's chain
            self._table_np = np.full(
                [self.slots, self.pages_per_slot], PARKING_PAGE, np.int32)
        else:
            self.pool = None
            self.page_size = 0
            self.pages_per_slot = 0
            cache = model.gen_slot_cache(self.slots, self.max_seq,
                                         self.cache_dtype)
            self._table_np = np.zeros([1, 1], np.int32)
        self._kv = [(c.k, c.v) for c in cache]
        self._table = torch.from_numpy(self._table_np).to(dev)
        self._slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        # K+V bytes of ONE page across every layer (paged sizing gauge)
        self._page_bytes = sum(
            k[0].numel() * k.element_size() + v[0].numel() * v.element_size()
            for k, v in self._kv) if self.paged else 0
        # host mirrors: page-capacity math, window delivery and sampling
        # decisions never pay a device readback
        self._host_len = np.zeros([self.slots], np.int64)
        self._host_temps = np.zeros([self.slots], np.float32)
        self._host_topks = np.zeros([self.slots], np.int32)
        # per slot: the request's seed and the index of the token its
        # next window's row 0 draws (the sampling schedule's counter)
        self._host_seeds = np.zeros([self.slots], np.int64)
        self._host_index = np.zeros([self.slots], np.int64)
        self._warming = False
        self.last_page_faults: Dict[int, KVPoolExhausted] = {}
        self._evictions_published = 0
        self._lengths = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self._tokens = torch.zeros(self.slots, dtype=torch.long, device=dev)
        self._temps = torch.zeros(self.slots, dtype=torch.float32, device=dev)
        self._topks = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        # f32 logits of the last step: window row 0 of every slot
        # ([slots, vocab]) and the prefill's last real position ([vocab]);
        # references kept for inspection, never copied
        self.last_logits: Optional[torch.Tensor] = None
        self.last_prefill_logits: Optional[torch.Tensor] = None

    @staticmethod
    def _resolve_prefill_buckets(buckets, max_seq):
        out = resolve_buckets(buckets, max_seq,
                              spec_flag="serve_gen_prefill_buckets")
        if out[-1] > max_seq:
            raise InvalidArgumentError(
                f"prefill bucket {out[-1]} exceeds serve_gen_max_seq="
                f"{max_seq} — a prompt that long could never decode")
        return out

    @staticmethod
    def resume_key(seed: int, start_index: int = 0) -> int:
        """The generator seed that draws token ``start_index + 1`` of the
        request seeded ``seed`` (the port's counterpart of the JAX
        package's key data): splitmix64 of the request seed, XORed with
        the token index and mixed again. Prefilling ``prompt + the
        start_index tokens already emitted`` and drawing from here on
        continues the stream bit-identically (greedy draws nothing)."""
        base = _mix64(int(seed) & 0x7FFFFFFF)
        return _mix64(base ^ int(start_index)) & 0x7FFFFFFFFFFFFFFF

    def _sync_table(self) -> None:
        self._table = torch.from_numpy(self._table_np).to(self.device)

    # -- device bodies ------------------------------------------------------

    def _apply_model(self, ids, caches, positions, attn_mask):
        """Run the model; under int8 on the weights dequantized from the
        stored codes (fresh f32 tensors every call, as the JAX package
        dequantizes inside each trace)."""
        if not self.int8:
            return self._model(ids, cache=caches, positions=positions,
                               attn_mask=attn_mask)
        from ..quantization import dequantize_weights
        return torch.func.functional_call(
            self._model, dequantize_weights(self._params), (ids,),
            dict(cache=caches, positions=positions, attn_mask=attn_mask))

    def _decode_body(self, active: torch.Tensor, drafts: torch.Tensor,
                     ndrafts: torch.Tensor, gens, temps, topks):
        """One decode window for every slot: ``[fed token, drafts]``
        through the model in one forward, a sample per row, then the
        chain verify: row i's sample is produced iff every earlier draft
        equals its row's sample. ``active`` gates advancement: inactive
        slots keep their token and cursor (their writes land on the
        parking page, or past the cursor). Returns ``(toks, flags)``,
        both ``[slots, window]``."""
        S, M, W = self.slots, self.max_seq, self.window
        pos = torch.clamp(self._lengths, max=M - W)
        ids = torch.cat([self._tokens[:, None], drafts], dim=1)
        positions = pos.long()[:, None] + torch.arange(W, device=self.device)
        if self.paged:
            caches = [MultiHeadAttention.PagedCache(k, v, self._table, pos)
                      for k, v in self._kv]
            logits, _ = self._apply_model(ids, caches, positions, None)
        else:
            caches = [MultiHeadAttention.GenCache(k, v, pos)
                      for k, v in self._kv]
            # window row i attends keys j <= pos + i
            mask = (torch.arange(M, device=self.device)[None, None, None, :]
                    <= positions[:, None, :, None])
            logits, _ = self._apply_model(ids, caches, positions, mask)
        lg = logits.float()                                  # [S, W, V]
        self.last_logits = lg[:, 0]
        if temps is None:
            toks = greedy_logits_array(lg)
        else:
            v = lg.shape[-1]
            toks = sample_logits_array(
                lg.reshape(S * W, v), gens,
                temps[:, None].expand(S, W).reshape(-1),
                topks if isinstance(topks, int)
                else topks[:, None].expand(S, W).reshape(-1)).reshape(S, W)
        # flags[:, i + 1] = flags[:, i] & (i < nd) & (draft_i == toks_i)
        k = W - 1
        match = (drafts == toks[:, :k]) & (
            torch.arange(k, device=self.device)[None, :] < ndrafts[:, None])
        flags = torch.cat([active[:, None], active[:, None] & (
            torch.cumprod(match.to(torch.int32), dim=1) > 0)], dim=1)
        n_prod = flags.sum(dim=1)
        last = torch.gather(toks, 1, torch.clamp(n_prod - 1, min=0)[:, None])
        self._tokens = torch.where(n_prod > 0, last[:, 0], self._tokens)
        self._lengths = torch.clamp(self._lengths + n_prod.to(torch.int32),
                                    max=M - self.decode_margin)
        return toks, flags

    def _prefill_body(self, bucket, ids, length, slot, gen, temperature,
                      top_k, row_pages):
        """The whole padded prompt in one causal pass, K/V written into
        the slot's cache rows — dense: the slot's first ``bucket`` rows;
        paged: a per-row scatter steered by ``row_pages`` (the target
        page per prompt position). Shared prefix pages and padding rows
        target the parking page, so a reused page is never rewritten.
        The first token is sampled from the last REAL position."""
        L = bucket
        small = []
        for k_arr, _ in self._kv:
            h, d = k_arr.shape[2], k_arr.shape[3]
            small.append(MultiHeadAttention.GenCache(
                torch.zeros((1, L, h, d), dtype=k_arr.dtype,
                            device=self.device),
                torch.zeros((1, L, h, d), dtype=k_arr.dtype,
                            device=self.device),
                torch.zeros(1, dtype=torch.int32, device=self.device)))
        positions = torch.arange(L, device=self.device)[None]
        causal = torch.ones(L, L, dtype=torch.bool,
                            device=self.device).tril()[None, None]
        logits, filled = self._apply_model(ids[None], small, positions,
                                           causal)
        if self.paged:
            off = torch.arange(L, device=self.device) % self.page_size
            for (k_arr, v_arr), c in zip(self._kv, filled):
                k_arr[row_pages, off] = c.k[0]
                v_arr[row_pages, off] = c.v[0]
        else:
            for (k_arr, v_arr), c in zip(self._kv, filled):
                k_arr[slot, :L] = c.k[0]
                v_arr[slot, :L] = c.v[0]
        last = logits[0, length - 1].float()
        self.last_prefill_logits = last
        return sample_logits_array(last, gen, temperature, top_k)

    # -- host-side dispatch -------------------------------------------------

    def check_kv_invariants(self, extra_holders=()) -> None:
        """Debug sweep: verify the page pool's refcounts against the
        engine's live slot chains (+ any ``extra_holders`` page lists,
        e.g. chaos-held pages). Raises typed KVPageAccountingError. No-op
        when unpaged."""
        if not self.paged:
            return
        holders = [c for c in self._slot_pages if c]
        holders.extend(list(x) for x in extra_holders if x)
        self.pool.check_invariants(holders)

    def bucket_for(self, prompt_len: int) -> int:
        if prompt_len < 1:
            raise InvalidArgumentError(
                f"need a prompt of >= 1 token, got {prompt_len}")
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise InvalidArgumentError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket {self.prefill_buckets[-1]} (buckets "
            f"{list(self.prefill_buckets)}) — raise "
            "serve_gen_prefill_buckets/serve_gen_max_seq")

    def _release_slot_pages(self, slot: int) -> None:
        """Drop the slot's page refs and park its table row (paged)."""
        if not self.paged:
            return
        pages = self._slot_pages[slot]
        if pages:
            self.pool.release(pages)
            self._slot_pages[slot] = []
        if (self._table_np[slot] != PARKING_PAGE).any():
            self._table_np[slot, :] = PARKING_PAGE
            self._sync_table()

    def _alloc_prefill_pages(self, slot: int,
                             prompt: np.ndarray) -> np.ndarray:
        """Claim the slot's prefill page chain (prefix-shared head +
        private tail) and return the per-row scatter targets. Shared
        pages' rows target parking, so only the FIRST request ever writes
        a shared page. Raises KVPoolExhausted (after releasing anything
        claimed) when the pool cannot serve."""
        P = int(np.shape(prompt)[0])
        ps = self.page_size
        prompt_i32 = np.asarray(prompt, np.int32).reshape(-1)
        self._release_slot_pages(slot)
        shared: List[int] = []
        if not self._warming:
            shared = self.pool.lookup_prefix(prompt_i32)
        n_needed = (P - 1) // ps + 1
        n_shared = min(len(shared), n_needed)
        if n_shared < len(shared):
            self.pool.release(shared[n_shared:])
            shared = shared[:n_shared]
        try:
            private = self.pool.alloc(n_needed - n_shared)
        except KVPoolExhausted:
            self.pool.release(shared)
            raise
        chain = shared + private
        if not self._warming:
            self.pool.register_prefix(prompt_i32, chain)
        self._slot_pages[slot] = chain
        self._table_np[slot, :] = PARKING_PAGE
        self._table_np[slot, :len(chain)] = chain
        self._sync_table()
        if self.metrics is not None:
            self.metrics.counter("gen_kv_prefix_hits_total").inc(n_shared)
        row_pages = np.full([self.bucket_for(P)], PARKING_PAGE, np.int32)
        for i in range(n_shared * ps, P):
            row_pages[i] = chain[i // ps]
        return row_pages

    def prefill(self, slot: int, prompt: np.ndarray, temperature: float,
                top_k: int, seed: int, start_index: int = 0) -> int:
        """Run one prompt into ``slot``; returns the first generated token
        (host int). A sampled request draws it from
        ``token_generator(seed, start_index)``.

        ``start_index > 0`` is the failover/preemption replay path:
        ``prompt`` then carries the client prompt PLUS the first
        ``start_index`` tokens already emitted, and the returned token is
        token ``start_index + 1`` of the original stream, bit-identical
        to an uninterrupted run."""
        P = int(np.shape(prompt)[0])
        bucket = self.bucket_for(P)
        if P + 1 > self.max_seq - self.decode_margin:
            raise InvalidArgumentError(
                f"prompt of {P} tokens leaves no room to generate within "
                f"serve_gen_max_seq={self.max_seq} (speculative window "
                f"margin {self.decode_margin})")
        if self.paged:
            row_pages = self._alloc_prefill_pages(slot, prompt)
        else:
            row_pages = np.zeros([bucket], np.int32)
        ids = np.zeros([bucket], np.int64)
        ids[:P] = np.asarray(prompt, np.int64)
        gen = (token_generator(seed, start_index, self.device)
               if temperature > 0 else None)
        with self._lock:
            self.prefill_dispatch_counts[bucket] = \
                self.prefill_dispatch_counts.get(bucket, 0) + 1
        with torch.inference_mode():
            first = self._prefill_body(
                bucket, torch.from_numpy(ids).to(self.device), P, slot, gen,
                float(temperature), int(top_k),
                torch.from_numpy(row_pages).long().to(self.device))
            first = int(first)
            self._lengths[slot] = P
            self._tokens[slot] = first
            self._temps[slot] = float(temperature)
            self._topks[slot] = int(top_k)
        self._host_len[slot] = P
        self._host_temps[slot] = float(temperature)
        self._host_topks[slot] = int(top_k)
        self._host_seeds[slot] = int(seed)
        self._host_index[slot] = int(start_index) + 1
        return first

    def ensure_page_capacity(self, active_mask: np.ndarray
                             ) -> Dict[int, BaseException]:
        """Page-fault handler, run on the host BEFORE each decode step
        (paged mode): any active slot whose next ``window`` writes would
        spill past its mapped chain gets fresh pages appended to its
        table row. Returns ``{slot: KVPoolExhausted}`` for slots the pool
        could not extend; the caller masks those out and finishes (or,
        under preemption, parks) them."""
        if not self.paged:
            return {}
        failed: Dict[int, BaseException] = {}
        faulted = 0
        for s in range(self.slots):
            if not bool(active_mask[s]):
                continue
            need = min((int(self._host_len[s]) + self.window - 1)
                       // self.page_size + 1, self.pages_per_slot)
            have = len(self._slot_pages[s])
            if need <= have:
                continue
            try:
                fresh = self.pool.alloc(need - have)
            except KVPoolExhausted as e:
                failed[s] = e
                continue
            self._table_np[s, have:have + len(fresh)] = fresh
            self._slot_pages[s].extend(fresh)
            faulted += len(fresh)
        if faulted:
            self._sync_table()
            if self.metrics is not None:
                self.metrics.counter("gen_kv_page_faults_total").inc(faulted)
        return failed

    def decode(self, active_mask: np.ndarray,
               drafts: Optional[np.ndarray] = None,
               ndrafts: Optional[np.ndarray] = None):
        """One decode step for the whole slot batch; returns
        ``(tokens, accepted)``, both ``[slots, window]`` host arrays.
        ``tokens[s, i]`` is the sample of window row i; ``accepted[s, i]``
        marks the rows that are real output (a prefix: column 0 for every
        live slot, further columns where speculation accepted drafts).
        ``drafts``: ``[slots, spec_tokens]`` proposals, ``ndrafts``:
        ``[slots]`` how many of each row are real. One readback of the
        samples and flags per step."""
        self.last_page_faults = self.ensure_page_capacity(active_mask)
        active_mask = np.asarray(active_mask, bool).copy()
        for s in self.last_page_faults:
            active_mask[s] = False
        k, W = self.spec_tokens, self.window
        if drafts is None:
            drafts = np.zeros([self.slots, k], np.int64)
        if ndrafts is None:
            ndrafts = np.zeros([self.slots], np.int64)
        drafts = np.asarray(drafts, np.int64).reshape(self.slots, k)
        ndrafts = np.asarray(ndrafts, np.int64).reshape(self.slots)
        sampled = active_mask & (self._host_temps > 0)
        gens = [token_generator(int(self._host_seeds[s]),
                                int(self._host_index[s]) + i, self.device)
                if sampled[s] else None
                for s in range(self.slots) for i in range(W)]
        with self._lock:
            self.decode_dispatch_count += 1
        with torch.inference_mode():
            dev = self.device
            active = torch.from_numpy(active_mask).to(dev)
            d_t = torch.from_numpy(drafts).to(dev)
            nd_t = torch.from_numpy(ndrafts).to(dev)
            if sampled.any():
                topks = self._topks if (self._host_topks[sampled] > 0).any() \
                    else 0
                toks, flags = self._decode_body(active, d_t, nd_t, gens,
                                                self._temps, topks)
            else:
                toks, flags = self._decode_body(active, d_t, nd_t, None,
                                                None, None)
            # the ONE intended readback: samples and flags together
            out = torch.cat([toks, flags.long()], dim=1).cpu().numpy()
        toks_np, flags_np = out[:, :W], out[:, W:].astype(bool)
        n_prod = flags_np.sum(axis=1).astype(np.int64)
        self._host_len += n_prod
        np.minimum(self._host_len, self.max_seq - self.decode_margin,
                   out=self._host_len)
        self._host_index += n_prod
        return toks_np, flags_np

    def publish_kv_metrics(self) -> None:
        """Mirror the page pool's host accounting as gauges/counters
        (paged mode; no-op otherwise)."""
        if not self.paged or self.metrics is None:
            return
        st = self.pool.stats()
        self.metrics.gauge("gen_kv_pages_in_use").set(st["pages_in_use"])
        self.metrics.gauge("gen_kv_pages_free").set(st["pages_free"])
        self.metrics.gauge("gen_kv_pages_cached").set(st["pages_cached"])
        self.metrics.gauge("gen_kv_page_bytes").set(self._page_bytes)
        ev = self.metrics.counter("gen_kv_page_evictions_total")
        ev.inc(st["evictions"] - self._evictions_published)
        self._evictions_published = st["evictions"]

    def release(self, slot: int) -> None:
        """Free a slot: reset its cursor and — in paged mode — return its
        page refs to the pool in the SAME call."""
        with torch.inference_mode():
            self._lengths[slot] = 0
        self._host_len[slot] = 0
        self._host_temps[slot] = 0.0
        self._host_topks[slot] = 0
        self._host_seeds[slot] = 0
        self._host_index[slot] = 0
        self._release_slot_pages(slot)

    def warm_up(self) -> int:
        """Run every prefill bucket once plus one decode step, so the
        first requests do not pay kernel builds, library loads and
        per-shape first-call costs (the JAX package compiles the same
        set). Returns the number of steps run. Slot state is reset after;
        the prefix registry is bypassed."""
        self._warming = True
        try:
            n = 0
            for b in self.prefill_buckets:
                self.prefill(0, np.zeros([min(b, self.max_seq - self.window)],
                                         np.int32), 0.0, 0, 0)
                n += 1
            self.decode(np.zeros([self.slots], bool))
            n += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self._warming = False
        self.release(0)
        with torch.inference_mode():
            self._tokens.zero_()
        return n


# ---------------------------------------------------------------------------
# server


class GenerationServer:
    """Streaming front end over a :class:`GenerationEngine`: admission
    control, per-request deadlines/token budgets, KV-pressure preemption
    (``preempt``), graceful drain. One loop thread owns all slot
    scheduling (iteration-level continuous batching: it admits new
    prompts into free slots between decode steps)."""

    def __init__(self, model, slots: Optional[int] = None,
                 max_seq: Optional[int] = None, prefill_buckets=None,
                 eos_id: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 stream_buffer: Optional[int] = None,
                 warmup: bool = False,
                 metrics: Optional[ServingMetrics] = None,
                 preempt: Optional[bool] = None):
        self.metrics = metrics if metrics is not None else ServingMetrics()
        if isinstance(model, GenerationEngine):
            if (slots is not None or max_seq is not None
                    or prefill_buckets is not None):
                raise InvalidArgumentError(
                    "slots/max_seq/prefill_buckets cannot be applied to a "
                    "pre-built GenerationEngine — pass them to "
                    "GenerationEngine(), or hand the raw model over")
            self.engine = model
            self.engine.metrics = self.metrics
            if eos_id is not None:
                self.engine.eos_id = int(eos_id)
        else:
            self.engine = GenerationEngine(
                model, slots=slots, max_seq=max_seq,
                prefill_buckets=prefill_buckets, eos_id=eos_id,
                metrics=self.metrics)
        self.token_budget = int(
            token_budget if token_budget is not None
            else core_flags.flag("serve_gen_token_budget"))
        dl = deadline_ms if deadline_ms is not None \
            else core_flags.flag("serve_deadline_ms")
        self.default_deadline_ms = float(dl) if dl else None
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else core_flags.flag("serve_queue_depth"))
        self.stream_buffer = int(
            stream_buffer if stream_buffer is not None
            else core_flags.flag("serve_gen_stream_buffer"))
        # KV-pressure graceful degradation (preempt/park/re-admit instead
        # of KVPoolExhausted): only meaningful under paging
        self.preempt = bool(core_flags.flag("serve_gen_preempt")
                            if preempt is None else preempt) \
            and self.engine.paged
        self._warmup = bool(warmup)
        self._q: "queue.Queue[_GenRequest]" = queue.Queue(self.queue_depth)
        self._drain_event = threading.Event()
        self._admit_lock = threading.Lock()
        self._accepting = False          # guarded-by: self._admit_lock
        self._loop: Optional[_GenerationLoop] = None
        self._seed_counter = 0           # guarded-by: self._admit_lock

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "GenerationServer":
        if self._loop is not None and self._loop.is_alive():
            return self
        self._drain_event.clear()
        supervised = core_health.supervised()
        core_health.beat()
        core_health.add_drain_callback(self._drain_event.set)
        if core_health.drain_requested():
            self._drain_event.set()
        if not supervised and threading.current_thread() is \
                threading.main_thread():
            from .server import install_standalone_sigterm_drain
            install_standalone_sigterm_drain()
        if self._warmup:
            n = self.engine.warm_up()
            self.metrics.counter("warmup_steps_total").inc(n)
        self._loop = _GenerationLoop(self.engine, self._q, self.metrics,
                                     self._drain_event,
                                     preempt=self.preempt)
        self._loop.start()
        with self._admit_lock:
            self._accepting = True
        return self

    @property
    def running(self) -> bool:
        return (self._loop is not None and self._loop.is_alive()
                and self._accepting)

    def __enter__(self) -> "GenerationServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.drain()
        return False

    # -- request path -------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               seed: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               priority: int = 0,
               resume_tokens: Optional[Sequence[int]] = None
               ) -> TokenStream:
        """Enqueue one prompt; returns its :class:`TokenStream`. Sheds
        with :class:`ServerOverloaded` (bounded queue) or raises
        :class:`ServerClosed` (draining/stopped) synchronously.
        ``temperature <= 0`` is greedy; ``seed`` pins the sampled draws
        (a request's tokens are identical whether it decodes alone or in
        a full batch).

        ``priority`` (0 = highest) steers KV-pressure preemption under
        ``preempt``: lower-priority streams yield pages first.
        ``resume_tokens`` is the mid-stream failover replay path: the
        tokens a previous server already emitted for this (prompt, seed)
        stream are prefilled (not re-delivered) and the stream continues
        from token ``len(resume_tokens) + 1``, bit-identical to the
        uninterrupted run. ``max_new_tokens`` counts the ORIGINAL target
        (resumed tokens included)."""
        if not self._accepting or self._drain_event.is_set():
            raise ServerClosed(
                "generation server is draining/stopped — not admitting")
        if self._loop is None or not self._loop.is_alive():
            raise ServerClosed(
                "generation server not started (or its loop died: "
                f"{self._loop.fatal!r})" if self._loop is not None
                else "generation server not started — call start()")
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids).astype(np.int64).reshape(-1)
        if prompt.size < 1:
            raise InvalidArgumentError("submit needs >= 1 prompt token")
        resume = np.asarray([] if resume_tokens is None else resume_tokens,
                            np.int64).reshape(-1)
        full = np.concatenate([prompt, resume]) if resume.size else prompt
        self.engine.bucket_for(full.size)  # typed on oversize NOW
        # room counts from the ORIGINAL prompt: a resumed stream caps at
        # the same total token the uninterrupted run would
        room = (self.engine.max_seq - int(prompt.size)
                - self.engine.decode_margin)
        if room < 1 or room <= resume.size:
            raise InvalidArgumentError(
                f"prompt of {prompt.size} (+{resume.size} resumed) tokens "
                f"leaves no room to generate within max_seq="
                f"{self.engine.max_seq} (speculative window margin "
                f"{self.engine.decode_margin})")
        asked = int(max_new_tokens) if max_new_tokens is not None \
            else self.token_budget
        if asked < 1:
            raise InvalidArgumentError(
                f"max_new_tokens must be >= 1, got {asked}")
        # the server-side budget/capacity cap: a stream cut short by it
        # fails typed mid-stream instead of silently truncating
        max_new = min(asked, self.token_budget, room)
        truncated = max_new < asked
        if resume.size >= max_new:
            raise InvalidArgumentError(
                f"resume_tokens already carries {resume.size} of a "
                f"{max_new}-token stream — nothing left to generate "
                "(the stream had finished; don't re-admit it)")
        if resume.size and seed is None:
            raise InvalidArgumentError(
                "resume_tokens needs the original seed — a replayed "
                "continuation is only bit-identical on the same "
                "(seed, token index) schedule")
        if seed is None:
            with self._admit_lock:
                self._seed_counter += 1
                seed = self._seed_counter
        dl = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        stream = TokenStream(self.stream_buffer)
        req = _GenRequest(full.astype(np.int32), max_new,
                          float(temperature), int(top_k), int(seed),
                          dl / 1e3 if dl else None, stream, truncated,
                          priority=int(priority), resumed=int(resume.size))
        with self._admit_lock:
            if not self._accepting or self._drain_event.is_set():
                raise ServerClosed(
                    "generation server is draining/stopped — not "
                    "admitting")
            self.metrics.counter("requests_total").inc()
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self.metrics.counter("shed_total").inc()
                raise ServerOverloaded(
                    f"generation queue depth {self.queue_depth} exhausted "
                    "— request shed (scale out, raise serve_queue_depth, "
                    "or slow the client)") from None
        lo = self._loop
        if self._drain_event.is_set() and lo is not None \
                and lo.drained.is_set():
            # lost the admission race against a lockless drain latch
            # (SIGTERM/health callback): nothing will read the queue
            lo._fail_queued(ServerClosed(
                "generation server drained while the request was being "
                "admitted"))
        return stream

    def generate(self, prompt_ids, **kw) -> List[int]:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(prompt_ids, **kw).result()

    # -- drain --------------------------------------------------------------

    def wait(self, poll_s: float = 0.1,
             timeout: Optional[float] = None) -> dict:
        """Serve until a drain is requested (SIGTERM, ``core.health.
        request_drain()``, or ``timeout``), then drain and report."""
        t0 = time.monotonic()
        while not self._drain_event.is_set():
            if timeout is not None and time.monotonic() - t0 >= timeout:
                break
            core_health.beat()
            time.sleep(poll_s)
        return self.drain()

    def drain(self, timeout: float = 30.0) -> dict:
        """Graceful shutdown: stop admitting, flush every accepted stream
        — finish decoding what's owed within ``timeout``, fail the rest
        typed — and report. ``unaccounted`` (requests), ``tokens_owed``
        and (paged) ``kv_pages_owed`` are all 0 by construction; the
        report proves it."""
        with self._admit_lock:
            self._accepting = False
            self._drain_event.set()
        drained = True
        if self._loop is not None:
            drained = self._loop.drained.wait(timeout)
            if not drained:
                self._loop.abort(DeadlineExceeded(
                    f"generation drain timed out after {timeout}s"))
                self._loop.drained.wait(max(timeout, 1.0))
            self._loop.join(timeout=max(timeout, 1.0))
            self._loop._fail_queued(ServerClosed(
                "generation server drained while the request was being "
                "admitted"))
        core_health.remove_drain_callback(self._drain_event.set)
        c = self.metrics.snapshot()["counters"]
        report = {
            "drained": bool(drained),
            "fatal": (repr(self._loop.fatal) if self._loop is not None
                      and self._loop.fatal is not None else None),
            "accepted": (c.get("requests_total", 0)
                         - c.get("shed_total", 0)),
            "completed": c.get("streams_completed_total", 0),
            "deadline_failed": c.get("deadline_expired_total", 0),
            "cancelled": c.get("streams_cancelled_total", 0),
            "errors": c.get("errors_total", 0),
            "shed": c.get("shed_total", 0),
            "tokens_generated": c.get("tokens_generated_total", 0),
            "tokens_streamed": c.get("tokens_streamed_total", 0),
            "tokens_dropped": c.get("tokens_dropped_total", 0),
            "decode_dispatches": self.engine.decode_dispatch_count,
            "prefill_dispatch_counts": dict(
                self.engine.prefill_dispatch_counts),
        }
        report["unaccounted"] = (
            report["accepted"] - report["completed"]
            - report["deadline_failed"] - report["cancelled"]
            - report["errors"])
        report["tokens_owed"] = (
            report["tokens_generated"] - report["tokens_streamed"]
            - report["tokens_dropped"])
        if self.engine.paged:
            # pages held by anything but the (intentionally warm) prefix
            # cache after drain = a leak
            st = self.engine.pool.stats()
            report["kv_pages_owed"] = st["pages_in_use"] - st["pages_cached"]
        return report

    stop = drain


class _GenerationLoop(threading.Thread):
    """The scheduler thread: admits prompts into free slots, runs one
    decode step per iteration for every active slot, delivers tokens,
    enforces deadlines/budgets, sheds KV pressure and answers chaos."""

    _POLL_S = 0.02

    def __init__(self, engine: GenerationEngine, q: "queue.Queue",
                 metrics: ServingMetrics, drain_event: threading.Event,
                 preempt: bool = False):
        super().__init__(name="p1t-torch-generation-loop", daemon=True)
        self.engine = engine
        self.q = q
        self.metrics = metrics
        self.drain = drain_event
        self.drained = threading.Event()
        self.fatal: Optional[BaseException] = None
        self._abort_exc: Optional[BaseException] = None
        self._by_slot: Dict[int, _GenRequest] = {}
        self._free: List[int] = list(range(engine.slots))
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._preempt = bool(preempt) and engine.paged
        self._ceiling = float(core_flags.flag("serve_gen_pressure_ceiling"))
        # admission-deferred (pressure-gated) requests, FIFO-preserving
        self._pending: collections.deque = collections.deque()
        # preempted/parked live streams awaiting replay re-admission
        self._parked: List[_GenRequest] = []
        # gen_page_pressure chaos: pages the scheduler itself holds
        self._chaos_pages: List[int] = []
        self._chaos_release_tick = 0
        self._tick = 0
        self._debug_refcount = bool(core_flags.flag("debug_kv_refcount"))

    def abort(self, exc: BaseException) -> None:
        """A drain that ran out of patience: fail everything still in
        flight typed at the next loop boundary."""
        self._abort_exc = exc

    # -- resolution helpers (only this thread calls them) -------------------

    def _deliver(self, req: _GenRequest, tok: int) -> None:
        m = self.metrics
        m.counter("tokens_generated_total").inc()
        if req.stream._put(tok):
            m.counter("tokens_streamed_total").inc()
        else:
            m.counter("tokens_dropped_total").inc()
        req.n_generated += 1
        req.emitted.append(int(tok))

    def _finish(self, req: _GenRequest, reason: str,
                exc: Optional[BaseException] = None) -> None:
        if req.stream._finish(reason, exc):
            m = self.metrics
            if reason in ("eos", "length"):
                m.counter("streams_completed_total").inc()
                m.record_response()
            elif reason == "cancelled":
                m.counter("streams_cancelled_total").inc()
            elif reason in ("deadline", "budget"):
                m.counter("deadline_expired_total").inc()
            else:
                m.counter("errors_total").inc()
            fresh = req.n_generated - req.resumed
            if fresh > 0 and req.t_first:
                dt = max(time.monotonic() - req.t_first, 1e-9)
                m.histogram("tokens_per_s").observe(fresh / dt)
        if req.slot >= 0:
            self.engine.release(req.slot)
            bisect.insort(self._free, req.slot)
            del self._by_slot[req.slot]
            req.slot = -1

    def _fail_queued(self, exc: BaseException) -> None:
        while True:
            try:
                req = self.q.get_nowait()
            except queue.Empty:
                return
            if req.stream._finish("error", exc):
                self.metrics.counter("errors_total").inc()

    def _fail_inflight(self, exc: BaseException) -> None:
        for slot in list(self._by_slot):
            self._finish(self._by_slot[slot], "error", exc)
        # parked (preempted) and pressure-deferred requests are owed a
        # typed answer too: they were accepted
        for req in self._parked:
            self._finish(req, "error", exc)
        self._parked = []
        while self._pending:
            self._finish(self._pending.popleft(), "error", exc)

    # -- scheduling ---------------------------------------------------------

    def _next_request(self) -> Optional[_GenRequest]:
        """Pressure-deferred requests re-try before fresh arrivals (FIFO
        is preserved: a deferral pushes back to the deque head)."""
        if self._pending:
            return self._pending.popleft()
        try:
            return self.q.get_nowait()
        except queue.Empty:
            return None

    def _admissible(self, req: _GenRequest) -> Optional[bool]:
        """Pressure gate (``preempt``): True = admit now, False = defer
        (the pool is too full — never a failure), None = this request
        could never fit the whole pool even alone (the ONLY admission
        shape that still fails typed)."""
        eng = self.engine
        if not self._preempt or not eng.paged:
            return True
        ps = eng.page_size
        orig_p = len(req.prompt) - req.resumed
        worst = min(-(-(orig_p + req.max_new) // ps), eng.pages_per_slot)
        total = eng.pool.num_pages - 1
        if worst > total:
            return None
        pf = len(req.prompt) + len(req.emitted)
        need = (pf - 1) // ps + 1
        st = eng.pool.stats()
        if need > st["pages_free"] + st["pages_cached"]:
            return False  # not even eviction could serve the prefill
        live = st["pages_in_use"] - st["pages_cached"]
        if live > 0 and live + need > self._ceiling * total:
            return False  # defer: keep decode-growth headroom
        return True

    def _park(self, req: _GenRequest, why: str) -> None:
        """Preempt a live stream: release its pages THIS tick, park the
        request, re-admit later via the bit-identical replay path."""
        slot = req.slot
        self.engine.release(slot)
        bisect.insort(self._free, slot)
        del self._by_slot[slot]
        req.slot = -1
        req.spec = None
        req.preempted += 1
        self._parked.append(req)
        m = self.metrics
        m.counter("gen_preemptions_total").inc()
        m.gauge("gen_parked_streams").set(len(self._parked))
        obs_events.emit("gen_stream_preempt", slot=slot,
                        tokens=req.n_generated, priority=req.priority,
                        why=why)

    def _handle_fault(self, slot: int, exc: BaseException) -> None:
        """A decode page fault the pool could not serve. Preempt off:
        fail that stream typed. Preempt on: the pool already LRU-evicted
        every cached prefix; now preempt strictly-lower-priority victims
        (longest deadline slack first) until the fault fits, else park
        the faulting stream itself. Nothing client-visible either way."""
        req = self._by_slot.get(slot)
        if req is None:
            return
        if not self._preempt:
            self._finish(req, "error", exc)
            return
        eng = self.engine
        need = max((int(eng._host_len[slot]) + eng.window - 1)
                   // eng.page_size + 1 - len(eng._slot_pages[slot]), 1)
        now = time.monotonic()

        def slack(r: _GenRequest) -> float:
            return float("inf") if r.deadline is None else r.deadline - now
        victims = sorted(
            (r for s, r in self._by_slot.items()
             if s != slot and r.priority > req.priority),
            key=lambda r: (r.priority, slack(r)), reverse=True)
        while victims and eng.pool.free_pages < need:
            self._park(victims.pop(0),
                       "preempted by higher-priority page fault")
        if eng.pool.free_pages < need:
            # no (more) eligible victims: the faulting stream yields
            self._park(req, "parked under KV pressure")

    def _readmit_parked(self, now: float) -> None:
        """Re-admit parked streams (before fresh arrivals: they are
        older) from ``prompt + everything already emitted`` at the next
        token's draw: the continuation is bit-identical to never having
        been preempted. Cancels/deadlines apply while parked too."""
        if not self._parked:
            return
        # snapshot: _admit_one can park a request straight back (a pool
        # miss at prefill); it lands on the emptied self._parked
        work = self._parked
        self._parked = []
        keep: List[_GenRequest] = []
        for req in work:
            if req.stream._cancel_requested:
                self._finish(req, "cancelled", StreamCancelled(
                    f"cancelled after {req.n_generated} tokens (while "
                    "parked)"))
                continue
            if req.deadline is not None and now > req.deadline:
                self._finish(req, "deadline", DeadlineExceeded(
                    f"wall deadline exceeded after {req.n_generated} "
                    "tokens (while parked under KV pressure)"))
                continue
            if not self._free:
                keep.append(req)
                continue
            ok = self._admissible(req)
            if ok is None:
                self._finish(req, "error", KVPoolExhausted(
                    "parked stream can never fit the page pool alone — "
                    "raise serve_gen_kv_pages"))
                continue
            if not ok:
                keep.append(req)
                continue
            if self._admit_one(req):
                self.metrics.counter("gen_preempt_readmits_total").inc()
        self._parked = keep + self._parked
        self.metrics.gauge("gen_parked_streams").set(len(self._parked))

    def _admit_one(self, req: _GenRequest) -> bool:
        """Claim the lowest free slot and prefill (fresh admission and
        parked/resumed replay share this path)."""
        slot = self._free.pop(0)
        req.slot = slot
        self._by_slot[slot] = req
        prior = req.resumed + len(req.emitted)
        pp = req.prompt if not req.emitted else np.concatenate(
            [req.prompt, np.asarray(req.emitted, np.int32)])
        try:
            t0 = time.monotonic()
            first = self.engine.prefill(slot, pp, req.temperature,
                                        req.top_k, req.seed,
                                        start_index=prior)
            self.metrics.histogram("prefill_ms").observe(
                (time.monotonic() - t0) * 1e3)
            if not req.t_first:
                self.metrics.histogram("queue_ms").observe(
                    (t0 - req.t_enq) * 1e3)
        except KVPoolExhausted as e:
            # raced the admission estimate: under preemption park it
            # (never a client-visible failure); otherwise typed
            bisect.insort(self._free, slot)
            del self._by_slot[slot]
            req.slot = -1
            if self._preempt:
                req.preempted += 1
                self._parked.append(req)
                self.metrics.counter("gen_preemptions_total").inc()
                return False
            self._finish(req, "error", e)
            return False
        except Exception as e:  # noqa: broad-except — typed per stream
            self._finish(req, "error", e)
            return False
        if not req.t_first:
            req.t_first = time.monotonic()
        if self.engine.spec_tokens > 0:
            req.spec = NGramSpeculator(
                pp, self.engine.spec_tokens,
                n=int(core_flags.flag("serve_gen_spec_ngram")))
            req.spec.observe(first)
        self._deliver(req, first)
        self._maybe_complete(req, first)
        return True

    def _admit(self) -> None:
        """Claim free slots for queued prompts (runs between decode
        steps, so a late request joins the RUNNING batch). A drain keeps
        admitting — queued requests were accepted and are owed an answer
        — while ``submit`` has already stopped new arrivals. Under
        preemption, parked streams re-admit first and fresh admissions
        are pressure-gated (deferred, never failed)."""
        self._readmit_parked(time.monotonic())
        while self._free:
            req = self._next_request()
            if req is None:
                return
            now = time.monotonic()
            if req.stream._cancel_requested:
                self._finish(req, "cancelled", StreamCancelled(
                    "cancelled before decoding started"))
                continue
            if req.deadline is not None and now > req.deadline:
                self._finish(req, "deadline", DeadlineExceeded(
                    f"request expired after "
                    f"{(now - req.t_enq) * 1e3:.1f}ms in queue — never "
                    "prefilled into a slot"))
                continue
            ok = self._admissible(req)
            if ok is None:
                self._finish(req, "error", KVPoolExhausted(
                    f"request needs more pages than the whole pool holds "
                    f"({self.engine.pool.num_pages - 1} usable) — raise "
                    "serve_gen_kv_pages or lower max_new_tokens"))
                continue
            if not ok:
                self._pending.appendleft(req)
                self.metrics.counter("gen_admission_deferrals_total").inc()
                return
            self._admit_one(req)

    def _maybe_complete(self, req: _GenRequest, tok: int) -> None:
        eos = self.engine.eos_id
        if eos is not None and tok == eos:
            self._finish(req, "eos")
        elif req.n_generated >= req.max_new:
            if req.truncated_by_budget:
                self._finish(req, "budget", DeadlineExceeded(
                    f"token budget exhausted after {req.n_generated} "
                    "tokens (server cap serve_gen_token_budget/max_seq "
                    "room below the requested max_new_tokens) — stream "
                    "truncated"))
            else:
                self._finish(req, "length")

    def _sweep(self) -> None:
        """Client cancels + wall deadlines, checked at step boundaries."""
        now = time.monotonic()
        for slot in list(self._by_slot):
            req = self._by_slot[slot]
            if req.stream._cancel_requested:
                self._finish(req, "cancelled", StreamCancelled(
                    f"cancelled after {req.n_generated} tokens"))
            elif req.deadline is not None and now > req.deadline:
                self._finish(req, "deadline", DeadlineExceeded(
                    f"wall deadline exceeded mid-stream after "
                    f"{req.n_generated} tokens"))

    # -- main loop ----------------------------------------------------------

    def run(self) -> None:
        try:
            self._run_loop()
        except BaseException as e:  # noqa: broad-except — the loop thread
            # must record ANY death and resolve every stream typed rather
            # than leave clients blocked mid-iteration
            self.fatal = e
            err = RuntimeError(f"generation loop died: {e!r}")
            self._fail_inflight(err)
            self._fail_queued(err)
            self.drain.set()
            try:
                core_health.report_unhealthy(f"generation loop died: {e!r}")
            except Exception:  # noqa: broad-except — best-effort marker
                pass
            if not isinstance(e, Exception):
                raise
        finally:
            self.drained.set()
            self._fail_queued(ServerClosed(
                "generation server drained while the request was being "
                "admitted"))

    def _maybe_release_chaos_pages(self) -> None:
        """Let go of gen_page_pressure chaos holds once their tick window
        passed (or at once under drain/abort, so parked streams complete
        and kv_pages_owed lands at 0)."""
        if self._chaos_pages and (
                self._tick >= self._chaos_release_tick
                or self.drain.is_set() or self._abort_exc is not None):
            self.engine.pool.release(self._chaos_pages)
            self._chaos_pages = []

    def _run_loop(self) -> None:
        m = self.metrics
        eng = self.engine
        slots = eng.slots
        while True:
            core_health.beat()
            self._tick += 1
            if eng.paged:
                self._maybe_release_chaos_pages()
            if self._abort_exc is not None:
                self._fail_inflight(self._abort_exc)
                self._fail_queued(self._abort_exc)
                break
            self._sweep()
            self._admit()
            if not self._by_slot:
                m.gauge("slot_occupancy").set(0.0)
                if (self.drain.is_set() and self.q.empty()
                        and not self._parked and not self._pending):
                    break
                time.sleep(self._POLL_S)
                continue
            if eng.paged and core_chaos.enabled() \
                    and core_chaos.check_gen_pressure():
                # claim every free page and squat for ~25 ticks: the
                # deterministic trigger for the preemption path
                free = eng.pool.free_pages
                if free:
                    self._chaos_pages.extend(eng.pool.alloc(free))
                self._chaos_release_tick = self._tick + 25
                obs_events.emit("gen_page_pressure",
                                pages_held=len(self._chaos_pages))
            wedged, slow = core_chaos.check_gen_step(list(self._by_slot))
            if slow:
                time.sleep(float(core_flags.flag("serve_chaos_slow_s")))
            if wedged is not None and wedged in self._by_slot:
                req = self._by_slot[wedged]
                self._finish(req, "error", SlotWedged(
                    f"decode slot {wedged} wedged after {req.n_generated} "
                    "tokens (chaos gen_slot_wedge) — stream failed, slot "
                    "released, cohabitants unaffected"))
            if not self._by_slot:
                continue
            active = np.zeros([slots], bool)
            for slot, req in self._by_slot.items():
                active[slot] = req.stream._writable()
            m.gauge("slot_occupancy").set(len(self._by_slot) / slots)
            if not active.any():
                time.sleep(self._POLL_S)  # every stream is parked
                continue
            drafts = np.zeros([slots, eng.spec_tokens], np.int64)
            nd = np.zeros([slots], np.int64)
            if eng.spec_tokens > 0:
                for slot, req in self._by_slot.items():
                    if active[slot] and req.spec is not None:
                        d = req.spec.propose()
                        nd[slot] = d.size
                        drafts[slot, :d.size] = d
            t0 = time.monotonic()
            toks, flags = eng.decode(active, drafts, nd)
            m.histogram("decode_step_ms").observe(
                (time.monotonic() - t0) * 1e3)
            # a page fault the pool could not serve: preempt off = that
            # stream fails typed; preempt on = shed pressure instead
            for slot, exc in eng.last_page_faults.items():
                self._handle_fault(slot, exc)
            for slot in list(self._by_slot):
                if not active[slot]:
                    continue
                req = self._by_slot[slot]
                n_acc = int(flags[slot].sum())
                if eng.spec_tokens > 0 and nd[slot] > 0:
                    self._spec_proposed += int(nd[slot])
                    self._spec_accepted += max(n_acc - 1, 0)
                    m.counter("gen_spec_proposed_total").inc(int(nd[slot]))
                    m.counter("gen_spec_accepted_total").inc(
                        max(n_acc - 1, 0))
                    m.gauge("gen_spec_accept_ratio").set(
                        self._spec_accepted / max(self._spec_proposed, 1))
                # flags[slot] is a prefix: every accepted row is a real
                # token, delivered in order; eos/length can retire the
                # request mid-window (the extras are discarded)
                for i in range(n_acc):
                    tok = int(toks[slot, i])
                    if req.spec is not None:
                        req.spec.observe(tok)
                    self._deliver(req, tok)
                    self._maybe_complete(req, tok)
                    if req.slot < 0:
                        break
            eng.publish_kv_metrics()
            if self._debug_refcount:
                eng.check_kv_invariants(extra_holders=(self._chaos_pages,))


def eager_generate(model, prompt_ids, max_new_tokens, eos_id=None,
                   temperature=0.0, top_k=0, seed=0):
    """Reference eager decode (one sequence, incremental concat cache):
    prefill the prompt, then sample a token per step from the engine's
    schedule (:func:`token_generator`), so sampled outputs are comparable
    token for token with the engine. Returns the token list."""
    w = next(iter(model.parameters()))
    prompt = torch.as_tensor(np.asarray(prompt_ids, np.int64).reshape(1, -1),
                             device=w.device)
    out: List[int] = []
    with torch.inference_mode():
        cache = model.empty_cache(1)
        logits, cache = model(prompt, cache=cache)
        for i in range(int(max_new_tokens)):
            last = logits[0, -1].float()
            gen = (token_generator(seed, i, w.device)
                   if temperature > 0 else None)
            tok = int(sample_logits_array(last, gen, float(temperature),
                                          int(top_k)))
            out.append(tok)
            if eos_id is not None and tok == eos_id:
                break
            if len(out) >= int(max_new_tokens):
                break
            logits, cache = model(
                torch.tensor([[tok]], dtype=torch.long, device=w.device),
                cache=cache)
    return out
