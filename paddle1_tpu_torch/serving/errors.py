"""Typed serving errors (a copy of the subset of
``paddle1_tpu/serving/errors.py`` the generation slice raises): callers
distinguish *shed* (back off / retry elsewhere), *expired* (the answer
is late, not wrong) and *closed* (the worker is draining) without
string-matching messages."""

from __future__ import annotations

from ..core.errors import (ExecutionTimeoutError, PreconditionNotMetError,
                           ResourceExhaustedError, UnavailableError)

__all__ = ["ServerOverloaded", "DeadlineExceeded", "ServerClosed",
           "StreamCancelled", "KVPoolExhausted", "KVPageAccountingError"]


class ServerOverloaded(ResourceExhaustedError):
    """Admission control shed the request: the bounded queue is full.
    Raised synchronously by ``submit`` — nothing was enqueued."""


class DeadlineExceeded(ExecutionTimeoutError):
    """The request's deadline expired while it was still queued (it was
    never dispatched — delivered through the request's future), or a
    reader's ``result(timeout=...)`` ran out while the future was still
    unresolved (the request itself may yet complete; first-wins
    resolution keeps the accounting straight either way)."""


class ServerClosed(UnavailableError):
    """The server is draining or stopped and no longer admits work."""


class KVPoolExhausted(ResourceExhaustedError):
    """The paged KV pool (``serve_gen_kv_pages``) has no free page even
    after evicting every evictable cached prefix: the live sequences'
    tokens genuinely exceed pool capacity. Raised at prefill admission
    (the request never claimed a slot) or delivered mid-stream through
    the starved request's TokenStream when a decode-time page fault
    cannot be served — cohabiting slots keep decoding. Remedies: more
    pages, shorter max_new_tokens, fewer slots, or a bigger prefix
    cache hit rate (shared prompts)."""


class KVPageAccountingError(PreconditionNotMetError):
    """KV page refcount accounting went inconsistent: a page was
    released more times than it was held (double release), or the
    debug invariant checker (``GenerationEngine.check_kv_invariants``)
    found the refcounts out of sync with the free list / holders.
    Raised typed BEFORE the free list can be corrupted — a double-freed
    page handed to two slots would silently cross-write their KV."""


class StreamCancelled(UnavailableError):
    """The client cancelled its TokenStream: the slot was released at
    the next step boundary and no further tokens stream. Reading
    ``result()`` on a cancelled stream raises this (iteration just
    stops) — the cancel is client-initiated, so it counts as accounted,
    not as a server failure."""
