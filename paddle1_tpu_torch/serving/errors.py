"""Typed serving errors (a copy of ``paddle1_tpu/serving/errors.py``):
callers
distinguish *shed* (back off / retry elsewhere), *expired* (the answer
is late, not wrong) and *closed* (the worker is draining) without
string-matching messages."""

from __future__ import annotations

from ..core.errors import (ExecutionTimeoutError, PreconditionNotMetError,
                           ResourceExhaustedError, UnavailableError)

__all__ = ["ServerOverloaded", "DeadlineExceeded", "ServerClosed",
           "ReplicaFailed", "DeployFailed", "ScaleFailed", "SlotWedged",
           "StreamCancelled", "KVPoolExhausted", "StreamFailed",
           "KVPageAccountingError"]


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


class ReplicaFailed(UnavailableError):
    """Every failover retry for this request exhausted: the replica
    holding it died or wedged, and ``serve_retry_max`` re-dispatches
    onto other replicas failed too (or none were healthy). Delivered
    through the request's future — the client-visible form of a fleet
    that genuinely could not serve this request."""


class DeployFailed(PreconditionNotMetError):
    """A model hot-swap's canary replica never became healthy (spawn
    failure, ready-handshake timeout, or a failed canary inference);
    the deploy was rolled back and the fleet keeps serving the old
    version."""


class ScaleFailed(PreconditionNotMetError):
    """A ``scale_to`` transition could not complete: a scale-out
    replica never became healthy within the ready window (the corpse
    was retired; replicas that DID come up stay in rotation — capacity
    is kept, the shortfall is typed), or the fleet was not in a state
    to scale. The fleet keeps serving at whatever size it actually
    reached — an autoscaler backs off and re-evaluates instead of
    flapping."""


class SlotWedged(UnavailableError):
    """One decode slot of the generation engine wedged mid-stream (the
    ``gen_slot_wedge`` chaos point's model of a poisoned request):
    ONLY that request's TokenStream fails — delivered through the
    stream, tokens already streamed stay valid — and the slot is
    released; cohabiting sequences in the continuous batch are
    untouched."""


class KVPoolExhausted(ResourceExhaustedError):
    """The paged KV pool (``serve_gen_kv_pages``) has no free page even
    after evicting every evictable cached prefix: the live sequences'
    tokens genuinely exceed pool capacity. Raised at prefill admission
    (the request never claimed a slot) or delivered mid-stream through
    the starved request's TokenStream when a decode-time page fault
    cannot be served — cohabiting slots keep decoding. Remedies: more
    pages, shorter max_new_tokens, fewer slots, or a bigger prefix
    cache hit rate (shared prompts)."""


class StreamFailed(UnavailableError):
    """Every failover retry for this token stream exhausted: the
    replica decoding it died or wedged mid-stream, and re-admitting
    ``prompt + tokens already emitted`` onto ``serve_retry_max``
    survivors failed too (or none were healthy). Delivered through the
    stream — tokens already delivered stay valid and exactly-once; this
    is the generative analog of :class:`ReplicaFailed` and the ONLY
    client-visible form of replica loss (a successful failover is
    invisible: the continuation is bit-identical)."""


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
