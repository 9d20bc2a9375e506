"""Serving metrics: the counters, gauges and histograms the generation
server's drain report and its callers read.

A copy of the subset of ``paddle1_tpu/obs/registry.py`` this slice needs
(``Counter``, ``Gauge``, ``Histogram`` and the registry's instrumentation
and ``snapshot`` surface), kept in the port so that it never imports the
JAX package. The exposition page, metric groups and the process registry
come with the observability slice.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict

from ..core.errors import InvalidArgumentError

__all__ = ["Counter", "Gauge", "Histogram", "ServingMetrics"]

# reservoir size per histogram: the quantiles are over the last ~4k
# observations
_RESERVOIR = 4096
# QPS window: rate over the last N responses' timestamps
_QPS_WINDOW = 512


class Counter:
    """Monotone counter (requests, sheds, tokens...)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    """Last-written value (slot occupancy, pages in use...)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Latency histogram: exact count+sum, reservoir quantiles."""

    __slots__ = ("name", "_lock", "count", "sum", "max", "_recent")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._recent: collections.deque = collections.deque(
            maxlen=_RESERVOIR)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v
            self._recent.append(v)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            data = sorted(self._recent)
            count, total, mx = self.count, self.sum, self.max

        def q(p):
            if not data:
                return 0.0
            return data[min(len(data) - 1,
                            max(0, int(round((p / 100.0)
                                             * (len(data) - 1)))))]
        return {"count": count, "sum": round(total, 4),
                "mean": round(total / count, 4) if count else 0.0,
                "p50": round(q(50), 4), "p95": round(q(95), 4),
                "p99": round(q(99), 4), "max": round(mx, 4)}


class ServingMetrics:
    """One server's registry. Families are created on first touch; a
    name registered as one kind can never be re-registered as another."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}      # guarded-by: self._lock
        self._gauges: Dict[str, Gauge] = {}          # guarded-by: self._lock
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: self._lock
        self._resp_times = collections.deque(maxlen=_QPS_WINDOW)
        self._started = time.monotonic()

    def _check_kind(self, name: str, kind: str) -> None:
        for other, table in (("counter", self._counters),
                             ("gauge", self._gauges),
                             ("histogram", self._histograms)):
            if other != kind and name in table:
                raise InvalidArgumentError(
                    f"metric family {name!r} is already registered as a "
                    f"{other} — one family, one kind")

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                self._check_kind(name, "counter")
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                self._check_kind(name, "gauge")
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                self._check_kind(name, "histogram")
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def record_response(self, n: int = 1) -> None:
        """Feed the QPS window (called once per completed request)."""
        now = time.monotonic()
        with self._lock:
            for _ in range(n):
                self._resp_times.append(now)

    def qps(self) -> float:
        """Responses/second over the recent-response window."""
        with self._lock:
            if len(self._resp_times) < 2:
                return 0.0
            span = self._resp_times[-1] - self._resp_times[0]
            n = len(self._resp_times) - 1
        if span <= 0:
            span = max(time.monotonic() - self._started, 1e-6)
            n += 1
        return n / span

    def snapshot(self) -> Dict[str, object]:
        """The whole registry as one JSON-able dict."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = list(self._histograms.values())
        return {
            "qps": round(self.qps(), 2),
            "uptime_s": round(time.monotonic() - self._started, 3),
            "counters": counters,
            "gauges": gauges,
            "histograms": {h.name: h.summary() for h in hists},
        }
