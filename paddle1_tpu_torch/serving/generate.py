"""Generative serving: KV-cache decode with slot-based continuous batching
and per-token streaming (port of ``paddle1_tpu/serving/generate.py``).

Design, as in the JAX package:

* **Prefill/decode split.** Prefill runs the whole prompt, padded to its
  prompt-length bucket (``serve_gen_prefill_buckets``), in one causal
  pass. Decode advances EVERY active slot by one token per step; its
  shapes are pinned to ``[slots]`` state and (paged) a fixed
  ``[slots, pages_per_slot]`` page table, so ragged arrivals and any
  active-slot pattern run the same shapes (a later PR can capture the
  step in a CUDA graph; this one runs eagerly).
* **Device-resident KV cache**, dense (``[slots, max_seq, heads, dim]``
  per layer) or block-paged (``[pages, page_size, heads, dim]`` pools +
  page table, ``serve_gen_paged``), written IN PLACE at a per-slot
  cursor. Paged decode attention is the hand-written CUDA kernel
  (``ops/paged_attention.py``); every LayerNorm is the CUDA LayerNorm
  kernel (``ops/layer_norm.py``).
* **Slot-based continuous batching.** New requests claim free slots
  between decode steps as finished ones release theirs; a slot's rows
  are never read by another slot.
* **Sampling on device** with one ``torch.Generator`` per request, seeded
  from the request's seed: each produced token consumes exactly one draw,
  so a request's tokens depend only on (seed, token index), never on its
  slot or its neighbours.
* **Per-token streaming** with a bounded per-stream buffer as
  backpressure, admission/deadline/shed/drain with token accounting:
  ``tokens_generated == tokens_streamed + tokens_dropped`` and
  ``unaccounted == 0`` in every drain report; paged mode adds
  ``kv_pages_owed == 0``.

Left out of this slice (see ROADMAP): speculative decoding, int8
weights, chaos/health hooks, KV-pressure preemption, mid-stream failover
replay, the cost/HBM census and CUDA-graph capture of the decode step.

Quickstart::

    lm = CausalLM(vocab_size=32000, d_model=512, nhead=8,
                  num_layers=12, max_seq=512)           # on cuda
    eng = GenerationEngine(lm, slots=16, max_seq=512, eos_id=2,
                           paged=True, page_size=16)
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

from ..core import flags as core_flags
from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError
from ..nn import (Embedding, Linear, MultiHeadAttention, TransformerEncoder,
                  TransformerEncoderLayer)
from ..nn.decode import greedy_logits_array, sample_logits_array
from ..nn.layer_base import Layer
from .engine import resolve_buckets
from .errors import (DeadlineExceeded, KVPoolExhausted, ServerClosed,
                     ServerOverloaded, StreamCancelled)
from .metrics import ServingMetrics
from .paging import PARKING_PAGE, PagePool

__all__ = ["CausalLM", "GenerationEngine", "GenerationServer",
           "TokenStream"]


# ---------------------------------------------------------------------------
# reference model


class CausalLM(Layer):
    """Small decoder-only transformer LM: token + learned position
    embeddings, a post-norm ``TransformerEncoder`` under a causal mask,
    and a vocabulary head. The generation engine's reference model; any
    module with ``gen_slot_cache`` / ``gen_paged_cache`` and
    ``forward(ids, cache=, positions=, attn_mask=)`` returning
    ``(logits, new_cache)`` when a cache is passed can be served.

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

    def gen_slot_cache(self, slots, max_seq, dtype=torch.float32):
        return self.encoder.gen_slot_cache(slots, max_seq, dtype)

    def gen_paged_cache(self, pages, page_size, dtype=torch.float32):
        return self.encoder.gen_paged_cache(pages, page_size, dtype)

    def forward(self, ids, cache=None, positions=None, attn_mask=None):
        b, n = ids.shape[0], ids.shape[1]
        if positions is None:
            positions = torch.arange(n, device=ids.device).expand(b, n)
        x = self.embed(ids) + self.pos_embed(positions.long())
        paged = (cache is not None and len(cache) > 0 and
                 isinstance(cache[0], MultiHeadAttention.PagedCache))
        if not paged and attn_mask is None and n > 1:
            # causal over the new tokens: the no-cache forward (a paged
            # decode derives its masking from the cursor instead)
            attn_mask = torch.ones(n, n, dtype=torch.bool,
                                   device=ids.device).tril()[None, None]
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
                 "slot", "n_generated", "t_first")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 temperature: float, top_k: int, seed: int,
                 deadline_s: Optional[float], stream: TokenStream,
                 truncated_by_budget: bool):
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
        self.n_generated = 0
        self.t_first = 0.0


# ---------------------------------------------------------------------------
# engine


class GenerationEngine:
    """Device state and steps of the decode loop.

    Owns the per-layer KV cache (dense or paged) and the per-slot
    cursor/token/sampling state. :meth:`prefill` runs one prompt (padded
    to its length bucket) into a slot and samples the first token;
    :meth:`decode` advances EVERY active slot by one token. Slot
    scheduling lives in :class:`GenerationServer`; the engine is purely
    the device side. The engine runs on the model's device.
    """

    def __init__(self, model, slots: Optional[int] = None,
                 max_seq: Optional[int] = None, prefill_buckets=None,
                 eos_id: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 cache_dtype: torch.dtype = torch.float32,
                 paged: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 pages: Optional[int] = None,
                 prefix_cache: Optional[int] = None):
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
        # one token per decode step (no speculative window in this port)
        self.window = 1
        self.decode_margin = 0
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
                                          cache_dtype)
            # host-authoritative page table, mirrored to the device on
            # change; rows are parking-filled beyond a slot's chain
            self._table_np = np.full(
                [self.slots, self.pages_per_slot], PARKING_PAGE, np.int32)
        else:
            self.pool = None
            self.page_size = 0
            self.pages_per_slot = 0
            cache = model.gen_slot_cache(self.slots, self.max_seq,
                                         cache_dtype)
            self._table_np = np.zeros([1, 1], np.int32)
        self._kv = [(c.k, c.v) for c in cache]
        self._table = torch.from_numpy(self._table_np).to(dev)
        self._slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        # K+V bytes of ONE page across every layer (paged sizing gauge)
        self._page_bytes = sum(
            k[0].numel() * k.element_size() + v[0].numel() * v.element_size()
            for k, v in self._kv) if self.paged else 0
        # host mirrors: page-capacity math and sampling decisions never
        # pay a device readback
        self._host_len = np.zeros([self.slots], np.int64)
        self._host_temps = np.zeros([self.slots], np.float32)
        self._host_topks = np.zeros([self.slots], np.int32)
        self._warming = False
        self.last_page_faults: Dict[int, KVPoolExhausted] = {}
        self._evictions_published = 0
        self._lengths = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self._tokens = torch.zeros(self.slots, dtype=torch.long, device=dev)
        self._temps = torch.zeros(self.slots, dtype=torch.float32, device=dev)
        self._topks = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        # one sampling generator per occupied sampled slot
        self._gens: List[Optional[torch.Generator]] = [None] * self.slots
        # f32 logits of the last step ([slots, vocab] decode, [vocab]
        # prefill): a reference kept for inspection, never copied
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

    def _sync_table(self) -> None:
        self._table = torch.from_numpy(self._table_np).to(self.device)

    # -- device bodies ------------------------------------------------------

    def _decode_body(self, active: torch.Tensor, gens, temps, topks):
        """One decode step for every slot. ``active`` gates advancement:
        inactive slots keep their token and cursor (their writes land on
        the parking page, or rewrite the same row with the same value)."""
        S, M, W = self.slots, self.max_seq, self.window
        pos = torch.clamp(self._lengths, max=M - W)
        ids = self._tokens[:, None]
        positions = pos.long()[:, None] + torch.arange(W, device=self.device)
        if self.paged:
            caches = [MultiHeadAttention.PagedCache(k, v, self._table, pos)
                      for k, v in self._kv]
            logits, _ = self._model(ids, cache=caches, positions=positions)
        else:
            caches = [MultiHeadAttention.GenCache(k, v, pos)
                      for k, v in self._kv]
            # window row i attends keys j <= pos + i
            mask = (torch.arange(M, device=self.device)[None, None, None, :]
                    <= positions[:, None, :, None])
            logits, _ = self._model(ids, cache=caches, positions=positions,
                                    attn_mask=mask)
        lg = logits[:, 0].float()                       # [S, V]
        self.last_logits = lg
        if temps is None:
            toks = greedy_logits_array(lg)
        else:
            toks = sample_logits_array(lg, gens, temps, topks)
        self._tokens = torch.where(active, toks, self._tokens)
        self._lengths = torch.where(
            active, torch.clamp(self._lengths + 1, max=M - self.decode_margin),
            self._lengths)
        return toks

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
        logits, filled = self._model(ids[None], cache=small,
                                     positions=positions, attn_mask=causal)
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

    def check_kv_invariants(self) -> None:
        """Debug sweep: verify the page pool's refcounts against the
        engine's live slot chains. Raises typed KVPageAccountingError.
        No-op when unpaged."""
        if self.paged:
            self.pool.check_invariants([c for c in self._slot_pages if c])

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
                top_k: int, seed: int) -> int:
        """Run one prompt into ``slot``; returns the first generated token
        (host int). Sampled requests get a generator seeded from ``seed``
        whose first draw picks this token."""
        P = int(np.shape(prompt)[0])
        bucket = self.bucket_for(P)
        if P + 1 > self.max_seq - self.decode_margin:
            raise InvalidArgumentError(
                f"prompt of {P} tokens leaves no room to generate within "
                f"serve_gen_max_seq={self.max_seq}")
        if self.paged:
            row_pages = self._alloc_prefill_pages(slot, prompt)
        else:
            row_pages = np.zeros([bucket], np.int32)
        ids = np.zeros([bucket], np.int64)
        ids[:P] = np.asarray(prompt, np.int64)
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed) & 0x7FFFFFFF)
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
        self._gens[slot] = gen
        return first

    def ensure_page_capacity(self, active_mask: np.ndarray
                             ) -> Dict[int, BaseException]:
        """Page-fault handler, run on the host BEFORE each decode step
        (paged mode): any active slot whose next write would spill past
        its mapped chain gets a fresh page appended to its table row.
        Returns ``{slot: KVPoolExhausted}`` for slots the pool could not
        extend; the caller masks those out and finishes them."""
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

    def decode(self, active_mask: np.ndarray):
        """One decode step for the whole slot batch; returns
        ``(tokens, accepted)``, both ``[slots, 1]`` host arrays
        (``accepted`` marks the slots that produced a real token). One
        readback of the sampled tokens per step."""
        self.last_page_faults = self.ensure_page_capacity(active_mask)
        active_mask = np.asarray(active_mask, bool).copy()
        for s in self.last_page_faults:
            active_mask[s] = False
        sampled = active_mask & (self._host_temps > 0)
        gens = [self._gens[s] if sampled[s] else None
                for s in range(self.slots)]
        with self._lock:
            self.decode_dispatch_count += 1
        with torch.inference_mode():
            active = torch.from_numpy(active_mask).to(self.device)
            if sampled.any():
                topks = self._topks if (self._host_topks[sampled] > 0).any() \
                    else 0
                toks = self._decode_body(active, gens, self._temps, topks)
            else:
                toks = self._decode_body(active, gens, None, None)
            toks_np = toks.cpu().numpy()  # the ONE intended readback
        self._host_len += active_mask.astype(np.int64)
        np.minimum(self._host_len, self.max_seq - self.decode_margin,
                   out=self._host_len)
        return toks_np[:, None], active_mask[:, None]

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
        self._gens[slot] = None
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
                self.prefill(0, np.zeros([min(b, self.max_seq - 1)],
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
    control, per-request deadlines/token budgets, graceful drain. One
    loop thread owns all slot scheduling (iteration-level continuous
    batching: it admits new prompts into free slots between decode
    steps)."""

    def __init__(self, model, slots: Optional[int] = None,
                 max_seq: Optional[int] = None, prefill_buckets=None,
                 eos_id: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 stream_buffer: Optional[int] = None,
                 warmup: bool = False,
                 metrics: Optional[ServingMetrics] = None):
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
        if self._warmup:
            n = self.engine.warm_up()
            self.metrics.counter("warmup_steps_total").inc(n)
        self._loop = _GenerationLoop(self.engine, self._q, self.metrics,
                                     self._drain_event)
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
               deadline_ms: Optional[float] = None) -> TokenStream:
        """Enqueue one prompt; returns its :class:`TokenStream`. Sheds
        with :class:`ServerOverloaded` (bounded queue) or raises
        :class:`ServerClosed` (draining/stopped) synchronously.
        ``temperature <= 0`` is greedy; ``seed`` pins the sampled draws
        (a request's tokens are identical whether it decodes alone or in
        a full batch)."""
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
        self.engine.bucket_for(prompt.size)  # typed on oversize NOW
        room = (self.engine.max_seq - int(prompt.size)
                - self.engine.decode_margin)
        if room < 1:
            raise InvalidArgumentError(
                f"prompt of {prompt.size} tokens leaves no room to "
                f"generate within max_seq={self.engine.max_seq}")
        asked = int(max_new_tokens) if max_new_tokens is not None \
            else self.token_budget
        if asked < 1:
            raise InvalidArgumentError(
                f"max_new_tokens must be >= 1, got {asked}")
        # the server-side budget/capacity cap: a stream cut short by it
        # fails typed mid-stream instead of silently truncating
        max_new = min(asked, self.token_budget, room)
        truncated = max_new < asked
        if seed is None:
            with self._admit_lock:
                self._seed_counter += 1
                seed = self._seed_counter
        dl = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        stream = TokenStream(self.stream_buffer)
        req = _GenRequest(prompt.astype(np.int32), max_new,
                          float(temperature), int(top_k), int(seed),
                          dl / 1e3 if dl else None, stream, truncated)
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
        return stream

    def generate(self, prompt_ids, **kw) -> List[int]:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(prompt_ids, **kw).result()

    # -- drain --------------------------------------------------------------

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
    enforces deadlines/budgets."""

    _POLL_S = 0.02

    def __init__(self, engine: GenerationEngine, q: "queue.Queue",
                 metrics: ServingMetrics, drain_event: threading.Event):
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
            if req.n_generated > 0 and req.t_first:
                dt = max(time.monotonic() - req.t_first, 1e-9)
                m.histogram("tokens_per_s").observe(req.n_generated / dt)
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

    # -- scheduling ---------------------------------------------------------

    def _admit_one(self, req: _GenRequest) -> None:
        """Claim the lowest free slot and prefill."""
        slot = self._free.pop(0)
        req.slot = slot
        self._by_slot[slot] = req
        try:
            t0 = time.monotonic()
            first = self.engine.prefill(slot, req.prompt, req.temperature,
                                        req.top_k, req.seed)
            self.metrics.histogram("prefill_ms").observe(
                (time.monotonic() - t0) * 1e3)
            self.metrics.histogram("queue_ms").observe(
                (t0 - req.t_enq) * 1e3)
        except Exception as e:  # noqa: broad-except — typed per stream
            self._finish(req, "error", e)
            return
        req.t_first = time.monotonic()
        self._deliver(req, first)
        self._maybe_complete(req, first)

    def _admit(self) -> None:
        """Claim free slots for queued prompts (runs between decode
        steps, so a late request joins the RUNNING batch). A drain keeps
        admitting — queued requests were accepted and are owed an answer
        — while ``submit`` has already stopped new arrivals."""
        while self._free:
            try:
                req = self.q.get_nowait()
            except queue.Empty:
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
            if not isinstance(e, Exception):
                raise
        finally:
            self.drained.set()
            self._fail_queued(ServerClosed(
                "generation server drained while the request was being "
                "admitted"))

    def _run_loop(self) -> None:
        m = self.metrics
        eng = self.engine
        slots = eng.slots
        while True:
            if self._abort_exc is not None:
                self._fail_inflight(self._abort_exc)
                self._fail_queued(self._abort_exc)
                break
            self._sweep()
            self._admit()
            if not self._by_slot:
                m.gauge("slot_occupancy").set(0.0)
                if self.drain.is_set() and self.q.empty():
                    break
                time.sleep(self._POLL_S)
                continue
            active = np.zeros([slots], bool)
            for slot, req in self._by_slot.items():
                active[slot] = req.stream._writable()
            m.gauge("slot_occupancy").set(len(self._by_slot) / slots)
            if not active.any():
                time.sleep(self._POLL_S)  # every stream is parked
                continue
            t0 = time.monotonic()
            toks, flags = eng.decode(active)
            m.histogram("decode_step_ms").observe(
                (time.monotonic() - t0) * 1e3)
            # a page fault the pool could not serve: that stream fails
            # typed; cohabitants decoded normally
            for slot, exc in eng.last_page_faults.items():
                req = self._by_slot.get(slot)
                if req is not None:
                    self._finish(req, "error", exc)
            for slot in list(self._by_slot):
                if not flags[slot, 0]:
                    continue
                req = self._by_slot[slot]
                tok = int(toks[slot, 0])
                self._deliver(req, tok)
                self._maybe_complete(req, tok)
            eng.publish_kv_metrics()
