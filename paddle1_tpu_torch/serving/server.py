"""Serving front end: admission control, deadlines, graceful drain (port
of ``paddle1_tpu/serving/server.py``).

The :class:`Server` is the piece a serving worker process wraps around an
:class:`~.engine.InferenceEngine`: clients ``submit()`` requests and get
futures back; a bounded queue sheds overload with the typed
:class:`ServerOverloaded`; per-request deadlines fail late requests with
:class:`DeadlineExceeded`; and SIGTERM (or
``core.health.request_drain()``) triggers the graceful drain: stop
admitting, flush everything already accepted, report.

Accounting invariant (the no-silent-drops contract): every accepted
request resolves (success, typed deadline failure or typed error), and
``drain()`` returns a report with ``unaccounted == 0`` proving it.

Left out: the embedding-delta subscriber (``delta_dir``, the JAX package's
online-learning loop), which comes with the distributed embedding slice.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core import flags as core_flags
from ..core import health as core_health
from ..core.errors import InvalidArgumentError, PreconditionNotMetError
from .batcher import Batcher, ServeFuture, _Request
from .engine import InferenceEngine
from .errors import ServerClosed, ServerOverloaded
from .metrics import ServingMetrics

__all__ = ["Server", "install_standalone_sigterm_drain"]


def install_standalone_sigterm_drain() -> None:
    """For an UNSUPERVISED serving worker on the main thread: make SIGTERM
    mean "drain", not "die with the queue full", by chaining a
    ``core.health.request_drain()`` in front of whatever handler the
    script installed. Idempotent per process. Shared by :class:`Server`
    and the generation server."""
    import signal
    prev = signal.getsignal(signal.SIGTERM)
    if getattr(prev, "_p1_serving_drain", False):
        return

    def _on_sigterm(signum, frame, _prev=prev):
        core_health.request_drain()  # fans out to subscribers
        if callable(_prev):
            _prev(signum, frame)
    _on_sigterm._p1_serving_drain = True
    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (OSError, ValueError):  # pragma: no cover
        pass  # exotic host; drain() still works programmatically


class Server:
    """Micro-batching inference server over one model.

    Parameters (``None`` -> the ``serve_*`` flag defaults)
    ------------------------------------------------------
    model : anything :class:`InferenceEngine` accepts (a Layer or a
        plain callable) or a pre-built engine.
    max_batch : micro-batch row ceiling (<= the engine's largest bucket).
    batch_timeout_ms : how long an incomplete batch waits for company.
    queue_depth : admitted-but-undispatched request bound (beyond it
        ``submit`` sheds with ``ServerOverloaded``).
    deadline_ms : default per-request deadline (0/None -> none).
    warmup : one forward per bucket in ``start()`` (needs
        ``input_specs``).
    """

    def __init__(self, model, max_batch: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 buckets=None, input_specs=None,
                 deadline_ms: Optional[float] = None,
                 warmup: bool = False,
                 metrics: Optional[ServingMetrics] = None):
        self.metrics = metrics if metrics is not None else ServingMetrics()
        if isinstance(model, InferenceEngine):
            if buckets is not None or input_specs is not None:
                raise InvalidArgumentError(
                    "buckets/input_specs cannot be applied to a pre-built "
                    "InferenceEngine — pass them to InferenceEngine(), or "
                    "hand Server the raw model")
            self.engine = model
            # latest-wins: the server currently serving the engine owns
            # the first-forward mirroring
            self.engine.metrics = self.metrics
        else:
            self.engine = InferenceEngine(
                model, buckets=buckets, max_batch=max_batch,
                input_specs=input_specs, metrics=self.metrics)
        if max_batch is None:
            # default clamps to the engine's top bucket, so explicit
            # buckets (1, 4) aren't tripped up by the flag's default
            self.max_batch = min(int(core_flags.flag("serve_max_batch")),
                                 self.engine.max_batch)
        else:
            self.max_batch = int(max_batch)
        if self.max_batch > self.engine.max_batch:
            raise InvalidArgumentError(
                f"max_batch={self.max_batch} exceeds the engine's largest "
                f"bucket {self.engine.max_batch} — a full micro-batch "
                "would be undispatchable")
        self.batch_timeout_ms = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else core_flags.flag("serve_batch_timeout_ms"))
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else core_flags.flag("serve_queue_depth"))
        dl = deadline_ms if deadline_ms is not None \
            else core_flags.flag("serve_deadline_ms")
        self.default_deadline_ms = float(dl) if dl else None
        self._warmup = bool(warmup)
        self._q: "queue.Queue[_Request]" = queue.Queue(self.queue_depth)
        self._drain_event = threading.Event()
        # makes {accepting-check -> requests_total -> enqueue} atomic
        # against drain()'s accepting-flip
        self._admit_lock = threading.Lock()
        self._accepting = False          # guarded-by: self._admit_lock
        self._batcher: Optional[Batcher] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Server":
        """Start the batcher thread (idempotent). Call from the main
        thread: the standalone SIGTERM-to-drain handler can only be
        installed there."""
        if self._batcher is not None and self._batcher.is_alive():
            return self
        # restart-after-drain reopens the server: clear the stale latch
        # before resubscribing (a pending process-level drain re-latches
        # just after)
        self._drain_event.clear()
        supervised = core_health.supervised()
        core_health.beat()
        core_health.add_drain_callback(self._drain_event.set)
        if core_health.drain_requested():
            self._drain_event.set()
        if not supervised and threading.current_thread() is \
                threading.main_thread():
            install_standalone_sigterm_drain()
        if self._warmup:
            n = self.engine.warm_up()
            self.metrics.counter("warmup_buckets_total").inc(n)
        self._batcher = Batcher(self.engine, self._q, self.max_batch,
                                self.batch_timeout_ms, self.metrics,
                                self._drain_event)
        self._batcher.start()
        with self._admit_lock:
            self._accepting = True
        return self

    @property
    def running(self) -> bool:
        return (self._batcher is not None and self._batcher.is_alive()
                and self._accepting)

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.drain()
        return False

    # -- request path -------------------------------------------------------

    def submit(self, *inputs, deadline_ms: Optional[float] = None
               ) -> ServeFuture:
        """Enqueue one request (each input carries a leading batch dim;
        a plain sample may be 1-row). Returns a future; raises
        ``ServerOverloaded`` (queue full) or ``ServerClosed``
        (draining/stopped) synchronously."""
        if not self._accepting or self._drain_event.is_set():
            raise ServerClosed(
                "server is draining/stopped — not admitting requests")
        if self._batcher is None or not self._batcher.is_alive():
            raise ServerClosed(
                "server not started (or its batcher died: "
                f"{self._batcher.fatal!r})" if self._batcher is not None
                else "server not started — call start()")
        if not inputs:
            raise InvalidArgumentError("submit needs >= 1 input array")
        arrays = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                  else np.asarray(a) for a in inputs]
        rows = int(np.shape(arrays[0])[0]) if np.ndim(arrays[0]) else 0
        if rows < 1:
            raise InvalidArgumentError(
                "request inputs need a leading batch dim (reshape a "
                "single sample to [1, ...])")
        if rows > self.max_batch:
            raise InvalidArgumentError(
                f"request has {rows} rows > max_batch={self.max_batch} "
                "— split it client-side")
        # every input must agree on the batch dim HERE: a mismatched
        # request reaching the Batcher would fail pad_to_bucket and take
        # its co-batched requests down too
        for i, a in enumerate(arrays[1:], start=1):
            if np.ndim(a) < 1 or int(np.shape(a)[0]) != rows:
                raise InvalidArgumentError(
                    f"input {i} has leading dim "
                    f"{np.shape(a)[0] if np.ndim(a) else '<scalar>'} but "
                    f"input 0 has {rows} — all inputs of one request must "
                    "share the batch dim")
        dl = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        req = _Request(arrays, self.engine._inner_sig(arrays),
                       dl / 1e3 if dl else None)
        # counted BEFORE the enqueue (else the batcher could complete it
        # first and a snapshot would read unaccounted < 0); the lock pairs
        # the count with the enqueue against drain()
        with self._admit_lock:
            if not self._accepting or self._drain_event.is_set():
                raise ServerClosed(
                    "server is draining/stopped — not admitting requests")
            self.metrics.counter("requests_total").inc()
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self.metrics.counter("shed_total").inc()
                raise ServerOverloaded(
                    f"queue depth {self.queue_depth} exhausted — request "
                    "shed (scale out, raise serve_queue_depth, or slow "
                    "the client)") from None
        b = self._batcher
        if self._drain_event.is_set() and b is not None \
                and b.drained.is_set():
            # lost the admission race against a lockless drain latch
            # (SIGTERM/health callback): nothing will read the queue
            b._fail_queued(ServerClosed(
                "server drained while the request was being admitted"),
                wrap=False)
        return req.future

    def infer(self, *inputs, deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None):
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(*inputs,
                           deadline_ms=deadline_ms).result(timeout)

    # -- drain / shutdown ---------------------------------------------------

    def wait(self, poll_s: float = 0.1,
             timeout: Optional[float] = None) -> dict:
        """Serve until a drain is requested (SIGTERM,
        ``core.health.request_drain()``, or ``timeout``), then drain and
        return the report: the serving worker's main loop."""
        t0 = time.monotonic()
        while not self._drain_event.is_set():
            if timeout is not None and time.monotonic() - t0 >= timeout:
                break
            core_health.beat()
            time.sleep(poll_s)
        return self.drain()

    def drain(self, timeout: float = 30.0) -> dict:
        """Graceful shutdown: stop admitting, flush every accepted
        request (complete or fail typed), join the batcher, report."""
        with self._admit_lock:
            self._accepting = False
            self._drain_event.set()
        drained = True
        if self._batcher is not None:
            drained = self._batcher.drained.wait(timeout)
            self._batcher.join(timeout=max(timeout, 1.0))
            if not drained:
                # flush stalled (a wedged forward): fail what's left
                # loudly, both still queued and already popped
                exc = PreconditionNotMetError(
                    f"drain timed out after {timeout}s")
                self._batcher._fail_queued(exc, wrap=False)
                self._batcher.fail_inflight(exc)
            # always sweep once more after the batcher exited: a submit
            # racing this drain can enqueue after the final flush
            self._batcher._fail_queued(ServerClosed(
                "server drained while the request was being admitted"),
                wrap=False)
        core_health.remove_drain_callback(self._drain_event.set)
        c = self.metrics.snapshot()["counters"]
        report = {
            "drained": bool(drained),
            "fatal": (repr(self._batcher.fatal)
                      if self._batcher is not None
                      and self._batcher.fatal is not None else None),
            "accepted": (c.get("requests_total", 0)
                         - c.get("shed_total", 0)),
            "completed": c.get("responses_total", 0),
            "deadline_failed": c.get("deadline_expired_total", 0),
            "errors": c.get("errors_total", 0),
            "shed": c.get("shed_total", 0),
            "batches": c.get("batches_total", 0),
            "compile_counts": dict(self.engine.compile_counts),
        }
        report["unaccounted"] = (report["accepted"] - report["completed"]
                                 - report["deadline_failed"]
                                 - report["errors"])
        return report

    stop = drain
