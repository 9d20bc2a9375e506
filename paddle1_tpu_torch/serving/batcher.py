"""Dynamic micro-batching: the queue-to-bucket dispatcher thread (port of
``paddle1_tpu/serving/batcher.py``).

The :class:`Batcher` drains a bounded request queue into micro-batches
under a ``max_batch`` / ``batch_timeout_ms`` policy (dispatch the moment
the batch is full, or when the oldest request has waited the timeout,
whichever first), concatenates compatible requests, pads to the engine's
shape bucket, runs ONE forward, and scatters the outputs back through
per-request futures.

A dispatched micro-batch's futures share one lazy :class:`_BatchResult`:
the first ``result()`` pays a single device-to-host copy for the whole
batch (the ``readback_ms`` histogram) and every other request slices the
cached host array. The Batcher itself never waits on the device, so it
queues the next batch's kernels while clients read back the last.

Requests are grouped by *inner signature* (shapes past the batch axis +
dtypes): an incompatible request flushes the current micro-batch and
seeds the next one. Per-request deadlines are enforced at dispatch time:
an expired request fails with the typed :class:`DeadlineExceeded`
instead of occupying bucket rows.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import chaos as core_chaos
from ..core import flags as core_flags
from ..core import health as core_health
from .errors import DeadlineExceeded

__all__ = ["Batcher", "ServeFuture"]


class _BatchResult:
    """Shared lazy readback of one dispatched micro-batch: holds the
    output tensors until the first reader copies them to the host (one
    copy, cached, device references dropped)."""

    __slots__ = ("_device", "_host", "_lock", "_metrics")

    def __init__(self, device_outs, metrics=None):
        self._device = device_outs
        self._host: Optional[List[np.ndarray]] = None
        self._lock = threading.Lock()
        self._metrics = metrics

    def materialize(self) -> List[np.ndarray]:
        with self._lock:
            if self._host is None:
                t0 = time.monotonic()
                self._host = [o.detach().cpu().numpy()
                              for o in self._device]
                if self._metrics is not None:
                    self._metrics.histogram("readback_ms").observe(
                        (time.monotonic() - t0) * 1e3)
                self._device = None  # free the device buffers
            return self._host


class ServeFuture:
    """Per-request response handle. ``result()`` blocks until the
    request's micro-batch was dispatched, then slices this request's
    rows out of the shared batch readback (single output -> array,
    multiple outputs -> list of arrays). Resolution is first-wins: a
    drain timeout may fail a future whose dispatch later completes (or
    the reverse); the loser reports False so its caller does not count a
    response twice. The wait Event is built only when a reader has to
    block."""

    __slots__ = ("_lock", "_event", "_done", "_exc", "_batch",
                 "_lo", "_hi")

    def __init__(self):
        self._lock = threading.Lock()
        self._event: Optional[threading.Event] = None  # guarded-by: _lock
        self._done = False                   # guarded-by: self._lock
        self._exc: Optional[BaseException] = None      # guarded-by: _lock
        self._batch: Optional[_BatchResult] = None     # guarded-by: _lock
        self._lo = 0                         # guarded-by: self._lock
        self._hi = 0                         # guarded-by: self._lock

    # -- batcher side -------------------------------------------------------

    def _set_slice(self, batch: _BatchResult, lo: int, hi: int) -> bool:
        with self._lock:
            if self._done:
                return False
            self._batch, self._lo, self._hi = batch, lo, hi
            self._done = True
            ev = self._event
        if ev is not None:
            ev.set()
        return True

    def _set_exception(self, exc: BaseException) -> bool:
        with self._lock:
            if self._done:
                return False
            self._exc = exc
            self._done = True
            ev = self._event
        if ev is not None:
            ev.set()
        return True

    # -- client side --------------------------------------------------------

    def done(self) -> bool:
        return self._done

    def _wait(self, timeout: Optional[float]) -> bool:
        if self._done:
            return True
        with self._lock:
            if self._done:
                return True
            if self._event is None:
                self._event = threading.Event()
            ev = self._event
        return ev.wait(timeout)

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """Block up to ``timeout`` for resolution and return the
        request's exception (None on success). A reader timing out on a
        still-unresolved future raises the typed
        :class:`DeadlineExceeded`; the request stays in flight and
        accounted."""
        if not self._wait(timeout):
            raise DeadlineExceeded(
                f"serving future not resolved within {timeout}s — the "
                "request is still in flight (a wedged or slow batch); "
                "it stays accounted and may yet complete")
        return self._exc

    def result(self, timeout: Optional[float] = None):
        exc = self.exception(timeout)
        if exc is not None:
            raise exc
        outs = [o[self._lo:self._hi] for o in self._batch.materialize()]
        return outs[0] if len(outs) == 1 else outs


class _Request:
    __slots__ = ("arrays", "rows", "sig", "future", "t_enq", "deadline")

    def __init__(self, arrays: Sequence[np.ndarray], sig: tuple,
                 deadline_s: Optional[float]):
        self.arrays = [a if isinstance(a, np.ndarray) else np.asarray(a)
                       for a in arrays]
        self.rows = int(self.arrays[0].shape[0])
        self.sig = sig
        self.future = ServeFuture()
        self.t_enq = time.monotonic()
        self.deadline = (self.t_enq + deadline_s
                         if deadline_s is not None else None)


class Batcher(threading.Thread):
    """The dispatcher thread. Owned/started by ``serving.Server``."""

    _POLL_S = 0.05  # idle wakeup: check drain, beat the health channel
    # While a partial batch waits for company the batcher sleeps in these
    # slices and drains with get_nowait, instead of blocking in q.get()
    # where every put() wakes it (a GIL handoff per request)
    _GATHER_SLICE_S = 0.001

    def __init__(self, engine, q: "queue.Queue", max_batch: int,
                 batch_timeout_ms: float, metrics,
                 drain_event: threading.Event):
        super().__init__(name="p1t-torch-serving-batcher", daemon=True)
        self.engine = engine
        self.q = q
        self.max_batch = int(max_batch)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.metrics = metrics
        self.drain = drain_event
        self.drained = threading.Event()  # set when the queue is flushed
        self.fatal: Optional[BaseException] = None
        # requests popped off the queue but not yet resolved, so a drain
        # that times out on a wedged dispatch can fail them too
        self._pending_lock = threading.Lock()
        self._pending: List[_Request] = []  # guarded-by: _pending_lock

    # -- loop ---------------------------------------------------------------

    def run(self) -> None:
        try:
            self._run_loop()
        except BaseException as e:  # noqa: broad-except — the batcher
            # thread must record ANY death and fail queued AND in-flight
            # futures loudly rather than leave clients hanging
            self.fatal = e
            self.fail_inflight(RuntimeError(f"serving batcher died: {e!r}"))
            self._fail_queued(e)
            self.drain.set()
            try:
                core_health.report_unhealthy(f"serving batcher died: {e!r}")
            except Exception:  # noqa: broad-except — best-effort marker
                pass
            if not isinstance(e, Exception):
                raise
        finally:
            self.drained.set()

    def _run_loop(self) -> None:
        carry: Optional[_Request] = None
        while True:
            core_health.beat()
            req = carry
            carry = None
            if req is None:
                try:
                    req = self.q.get(timeout=self._POLL_S)
                except queue.Empty:
                    if self.drain.is_set():
                        break
                    continue
            with self._pending_lock:
                self._pending.append(req)
            batch, carry = self._assemble(req)
            self._dispatch(batch)
            with self._pending_lock:
                self._pending.clear()
                if carry is not None:
                    self._pending.append(carry)

    def fail_inflight(self, exc: BaseException) -> None:
        """Fail every popped-but-unresolved request (first-wins)."""
        with self._pending_lock:
            snapshot = list(self._pending)
        for r in snapshot:
            if r.future._set_exception(exc):
                self.metrics.counter("errors_total").inc()

    def _assemble(self, first: _Request
                  ) -> Tuple[List[_Request], Optional[_Request]]:
        """Grow a micro-batch from the queue: same inner signature, up to
        ``max_batch`` rows, within ``batch_timeout_ms`` of the first
        request's ENQUEUE (draining flushes at once). Returns (batch,
        carried incompatible request)."""
        batch, rows = [first], first.rows
        flush_at = (0.0 if self.drain.is_set()
                    else first.t_enq + self.batch_timeout_s)
        while rows < self.max_batch:
            try:
                nxt = self.q.get_nowait()  # backlog coalesces for free
            except queue.Empty:
                rem = flush_at - time.monotonic()
                if rem <= 0:
                    break
                time.sleep(min(rem, self._GATHER_SLICE_S))
                continue
            with self._pending_lock:
                self._pending.append(nxt)
            if nxt.sig != first.sig or rows + nxt.rows > self.max_batch:
                return batch, nxt  # flush now; nxt seeds the next batch
            batch.append(nxt)
            rows += nxt.rows
        return batch, None

    def _dispatch(self, batch: List[_Request]) -> None:
        m = self.metrics
        now = time.monotonic()
        live: List[_Request] = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                if r.future._set_exception(DeadlineExceeded(
                        f"request expired after "
                        f"{(now - r.t_enq) * 1e3:.1f}ms in queue "
                        f"(deadline {(r.deadline - r.t_enq) * 1e3:.1f}ms)"
                        " — never dispatched")):
                    m.counter("deadline_expired_total").inc()
            else:
                live.append(r)
        if not live:
            return
        if core_chaos.check_serve_slow():
            # injected slow forward: stall THIS dispatch so queued
            # requests age past their deadlines
            time.sleep(float(core_flags.flag("serve_chaos_slow_s")))
        try:
            for r in live:
                m.histogram("queue_ms").observe((now - r.t_enq) * 1e3)
            t0 = time.monotonic()
            if len(live) == 1:
                arrays = live[0].arrays
            else:
                arrays = [np.concatenate([r.arrays[i] for r in live],
                                         axis=0)
                          for i in range(len(live[0].arrays))]
            padded, rows, bucket = self.engine.pad_to_bucket(arrays)
            t1 = time.monotonic()
            m.histogram("pad_ms").observe((t1 - t0) * 1e3)
            outs = self.engine.dispatch_padded(padded, bucket)
            t2 = time.monotonic()
            m.histogram("dispatch_ms").observe((t2 - t1) * 1e3)
            m.histogram("batch_occupancy").observe(rows / bucket)
            m.counter("batches_total").inc()
            m.counter("batches_full_total" if rows >= self.max_batch
                      else "batches_timeout_total").inc()
            result = _BatchResult(outs, m)
            lo, won = 0, 0
            for r in live:
                if r.future._set_slice(result, lo, lo + r.rows):
                    m.histogram("e2e_ms").observe((t2 - r.t_enq) * 1e3)
                    won += 1
                lo += r.rows
            if won:
                m.counter("responses_total").inc(won)
                m.record_response(won)
        except Exception as e:  # noqa: broad-except — typed per batch
            # a broken micro-batch fails ITS requests, not the server
            for r in live:
                if r.future._set_exception(e):
                    m.counter("errors_total").inc()

    def _fail_queued(self, exc: BaseException, wrap: bool = True) -> None:
        """Fail every still-queued request. ``wrap=True`` (the death
        path) delivers a RuntimeError naming ``exc``; ``wrap=False`` (the
        drain sweeps) delivers the typed error as is."""
        while True:
            try:
                r = self.q.get_nowait()
            except queue.Empty:
                return
            if r.future._set_exception(
                    RuntimeError(f"serving batcher died: {exc!r}")
                    if wrap else exc):
                self.metrics.counter("errors_total").inc()
