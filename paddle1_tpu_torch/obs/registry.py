"""Unified metrics registry: counters + gauges + latency histograms.

A copy of the JAX package's ``obs/registry.py`` (stdlib only), kept
with its structure and names: the port imports nothing of that package.
The supervisor, trainer and servers it names there are the JAX
package's; the port's data loader is what calls it here.

Promoted from ``serving/metrics.py`` in the JAX package: the serving
runtime's Counter/Gauge/Histogram grow a ``namespace`` and become the
single :class:`MetricsRegistry` every subsystem reports into —
``serving/metrics.py`` re-exports everything (zero API break, the
serving pages keep their ``p1t_serving_`` family prefix), while the
training side (engine step phases, checkpoint durations, loader
resilience, hapi fit) reports into the process-wide
:func:`process_registry` under the plain ``p1t_`` prefix.

Deliberately dependency-free and cheap: counters are a locked int,
gauges a plain float store, histograms keep exact count/sum plus a
bounded reservoir of recent observations for quantiles (latency
distributions are what the last few thousand observations say, not
what the process saw at boot). ``snapshot()`` returns a plain dict
(JSON-able; the test/bench surface and the cross-process aggregation
unit), ``render_text()`` emits Prometheus text exposition —
conformance locked by tests/test_obs.py's minimal parser: one
``# TYPE`` line per family per page, ``_total``-suffixed counters,
RAW (unrounded) monotone ``_sum``/``_count`` series so ``rate()``
works. ``tools/check_metric_names.py`` lints the metric-name contract
at the source level.

The fleet layer adds two multi-registry shapes on top:
:class:`MetricsGroup` keys child registries by a label (per model
version, per replica) so a rolling deploy's two versions never mix
their latencies, and :func:`merge_snapshots` folds many snapshots —
including ones shipped over the wire from replica subprocesses, or
read from Supervisor worker snapshot files — into one aggregate
(counters/count/sum add exactly; quantiles take the worst child, the
conservative merge for an SLO read). :func:`render_snapshot_text`
turns a merged snapshot back into a labeled exposition page for the
``/metrics`` endpoint.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ..core import locks
from ..core.errors import InvalidArgumentError

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "ServingMetrics", "MetricsGroup", "merge_snapshots",
           "render_snapshot_text", "process_registry",
           "reset_process_registry", "metrics_on", "step_registry",
           "SNAPSHOT_ENV", "write_snapshot_file"]

# reservoir size per histogram: large enough for a stable p99 (the
# quantile of the last ~4k observations), small enough to sort per
# snapshot without showing up in a profile
_RESERVOIR = 4096
# QPS window: rate over the last N responses' timestamps
_QPS_WINDOW = 512

# env var naming the JSON file a child process periodically publishes
# its process-registry snapshot to (atomic replace) — how a Supervisor
# aggregates training workers it cannot RPC into
SNAPSHOT_ENV = "PADDLE_OBS_SNAPSHOT"
_SNAPSHOT_INTERVAL_S = 1.0


class Counter:
    """Monotone counter (requests, sheds, compiles...)."""

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
    """Last-written value (slot occupancy, queue depth...) — unlike a
    Counter it moves both ways; ``set`` is a plain float store (atomic
    under the GIL, no lock on the per-step hot path)."""

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
    """Latency/occupancy histogram: exact count+sum, reservoir quantiles."""

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

    def percentile(self, p: float) -> float:
        """Quantile over the reservoir (nearest-rank); 0.0 when empty."""
        with self._lock:
            data = sorted(self._recent)
        if not data:
            return 0.0
        idx = min(len(data) - 1, max(0, int(round(
            (p / 100.0) * (len(data) - 1)))))
        return data[idx]

    def totals(self) -> Tuple[int, float]:
        """Raw (count, sum) — unrounded, for the Prometheus ``_sum`` /
        ``_count`` series a ``rate()`` is computed from (the rounded
        ``summary()`` values drift a rate by up to 5e-5 per scrape)."""
        with self._lock:
            return self.count, self.sum

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


def _fmt_line(name, value, pairs=(), label=None):
    """One exposition sample line (shared by the registry page and the
    merged-snapshot page — label quoting must never drift between
    them)."""
    pairs = [p for p in pairs if p is not None]
    if label is not None:
        pairs = pairs + [label]
    if pairs:
        lab = ",".join(f'{k}="{v}"' for k, v in pairs)
        return f"{name}{{{lab}}} {value}"
    return f"{name} {value}"


class MetricsRegistry:
    """One process's (or one Server's) registry. Counters, gauges and
    histograms are created on first touch, so instrumentation points
    never need registration boilerplate and ``snapshot()`` only reports
    what actually fired. A name registered as one kind can never be
    re-registered as another — the duplicate-family guard the
    exposition format depends on (one ``# TYPE`` per family)."""

    def __init__(self, namespace: str = "p1t_serving"):
        self.namespace = str(namespace)
        self._lock = locks.make_lock("MetricsRegistry._lock")
        self._counters: Dict[str, Counter] = {}      # guarded-by: self._lock
        self._gauges: Dict[str, Gauge] = {}          # guarded-by: self._lock
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: self._lock
        # (family dicts are lock-free on the READ fast path by design —
        # `get` then locked setdefault — so only mutation is guarded)
        self._resp_times = collections.deque(maxlen=_QPS_WINDOW)  # guarded-by: self._lock
        self._started = time.monotonic()

    # -- instrumentation surface -------------------------------------------

    def _check_kind(self, name: str, kind: str) -> None:
        for other, table in (("counter", self._counters),
                             ("gauge", self._gauges),
                             ("histogram", self._histograms)):
            if other != kind and name in table:
                raise InvalidArgumentError(
                    f"metric family {name!r} is already registered as a "
                    f"{other} — one family, one kind (the exposition "
                    "format allows a single # TYPE per family)")

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

    def peek(self, name: str):
        """Look a family up WITHOUT creating it: ``(kind, obj)`` or
        None. The SLO evaluator reads through this — evaluating an
        objective over a family that never fired must not materialize
        an empty family (the structural-zero proof counts families)."""
        c = self._counters.get(name)
        if c is not None:
            return ("counter", c)
        g = self._gauges.get(name)
        if g is not None:
            return ("gauge", g)
        h = self._histograms.get(name)
        if h is not None:
            return ("histogram", h)
        return None

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
            # burst faster than the clock tick: rate over process life
            span = max(time.monotonic() - self._started, 1e-6)
            n += 1
        return n / span

    # -- export surface -----------------------------------------------------

    def empty(self) -> bool:
        """True when no metric family was ever touched (the bench
        --obs structural proof that disabled instrumentation did
        literally nothing)."""
        with self._lock:
            return not (self._counters or self._gauges
                        or self._histograms)

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

    def render_text(self, label: Optional[Tuple[str, str]] = None,
                    type_headers: bool = True) -> str:
        """Prometheus-style plain-text exposition (one scrape page).

        Histograms are emitted as Prometheus *summaries*: a ``# TYPE``
        header, quantile-labeled gauges, and RAW (unrounded) monotone
        ``_sum``/``_count`` series — the pair ``rate()`` needs, so
        ``rate(..._sum[1m]) / rate(..._count[1m])`` yields a true
        rolling mean (the rounded summary values would drift it).
        Counters and gauges get their own ``# TYPE`` lines. The legacy
        ``_mean``/``_max``/``_p50``/``_p95``/``_p99`` gauge lines are
        kept for existing scrapers. ``label`` tags every sample with
        one extra ``key="value"`` pair — the :class:`MetricsGroup`
        per-version/per-replica pages, which pass
        ``type_headers=False``: the text format allows one TYPE line
        per metric family per page, so a multi-child page emits the
        labeled samples untyped rather than a duplicate header per
        child (untyped samples parse fine; duplicate TYPE lines do
        not)."""
        def line(name, value, *pairs):
            return _fmt_line(name, value, pairs, label)

        ns = self.namespace
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = list(self._histograms.values())
        lines = [line(f"{ns}_qps", round(self.qps(), 2)),
                 line(f"{ns}_uptime_seconds",
                      round(time.monotonic() - self._started, 3))]
        for name, v in sorted(counters.items()):
            if type_headers:
                lines.append(f"# TYPE {ns}_{name} counter")
            lines.append(line(f"{ns}_{name}", v))
        for name, v in sorted(gauges.items()):
            if type_headers:
                lines.append(f"# TYPE {ns}_{name} gauge")
            lines.append(line(f"{ns}_{name}", v))
        for h in sorted(hists, key=lambda h: h.name):
            base = f"{ns}_{h.name}"
            s = h.summary()
            count, total = h.totals()
            if type_headers:
                lines.append(f"# TYPE {base} summary")
            for q, stat in (("0.5", "p50"), ("0.95", "p95"),
                            ("0.99", "p99")):
                lines.append(line(base, s[stat], ("quantile", q)))
            lines.append(line(base + "_sum", repr(float(total))))
            lines.append(line(base + "_count", count))
            for stat in ("mean", "p50", "p95", "p99", "max"):
                lines.append(line(f"{base}_{stat}", s[stat]))
        return "\n".join(lines) + "\n"


# serving's historical name for the class; per-Server registries keep
# the p1t_serving_ namespace (and their exposition pages) unchanged
ServingMetrics = MetricsRegistry


class MetricsGroup:
    """A labeled family of :class:`MetricsRegistry` children — the
    fleet's per-model-version and per-replica split (a rolling deploy
    serves two versions at once; mixing their latency histograms would
    hide a regression in the new one behind the old one's volume).
    Children are created on first touch, like the registry's own
    counters; :meth:`aggregate` folds them into one fleet-wide view."""

    def __init__(self, label_key: str, namespace: str = "p1t_serving"):
        self.label_key = label_key
        self.namespace = namespace
        self._lock = locks.make_lock("MetricsGroup._lock")
        self._children: Dict[str, MetricsRegistry] = {}  # guarded-by: self._lock

    def child(self, label) -> MetricsRegistry:
        label = str(label)
        m = self._children.get(label)
        if m is None:
            with self._lock:
                m = self._children.setdefault(
                    label, MetricsRegistry(namespace=self.namespace))
        return m

    def labels(self) -> List[str]:
        with self._lock:
            return sorted(self._children)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            kids = dict(self._children)
        return {label: m.snapshot() for label, m in sorted(kids.items())}

    def aggregate(self) -> Dict[str, object]:
        return merge_snapshots(self.snapshot().values())

    def render_text(self) -> str:
        with self._lock:
            kids = dict(self._children)
        return "".join(
            m.render_text(label=(self.label_key, label),
                          type_headers=False)
            for label, m in sorted(kids.items()))


def merge_snapshots(snaps: Iterable[Dict[str, object]]
                    ) -> Dict[str, object]:
    """Fold many ``MetricsRegistry.snapshot()`` dicts into one aggregate
    (across a MetricsGroup's children, across replica subprocesses'
    wire-shipped snapshots, or across Supervisor workers' snapshot
    files). Counters, histogram counts and sums add exactly;
    quantiles/max take the WORST child — reservoir quantiles cannot be
    merged without the raw observations, and for an SLO read the
    conservative bound is the useful one (documented on the line a
    dashboard reads: an aggregate p99 here is "no child was worse")."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, float]] = {}
    qps = 0.0
    uptime = 0.0
    for s in snaps:
        qps += float(s.get("qps", 0.0) or 0.0)
        uptime = max(uptime, float(s.get("uptime_s", 0.0) or 0.0))
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in (s.get("gauges") or {}).items():
            # gauges are instantaneous levels, not totals: like the
            # quantiles, the aggregate takes the WORST (highest) child
            gauges[k] = max(gauges.get(k, 0.0), float(v))
        for name, h in (s.get("histograms") or {}).items():
            m = hists.setdefault(name, {
                "count": 0, "sum": 0.0, "mean": 0.0, "p50": 0.0,
                "p95": 0.0, "p99": 0.0, "max": 0.0})
            m["count"] += h["count"]
            m["sum"] += h["sum"]
            for q in ("p50", "p95", "p99", "max"):
                m[q] = max(m[q], h[q])
    for m in hists.values():
        m["mean"] = (round(m["sum"] / m["count"], 4) if m["count"]
                     else 0.0)
        m["sum"] = round(m["sum"], 4)
    return {"qps": round(qps, 2), "uptime_s": uptime,
            "counters": counters, "gauges": gauges,
            "histograms": hists}


def render_snapshot_text(snap: Dict[str, object], namespace: str,
                         label: Optional[Tuple[str, str]] = None) -> str:
    """Render a snapshot dict (typically a :func:`merge_snapshots`
    aggregate) as a labeled, UNTYPED exposition page — the merged-page
    analog of ``MetricsGroup.render_text`` for the ``/metrics``
    endpoint. Untyped because the same families may already carry a
    ``# TYPE`` on the live page above; merged histogram sums are the
    rounded aggregate values, so a rate() should be computed from the
    children's raw pages, not from here."""
    def line(name, value, *pairs):
        return _fmt_line(name, value, pairs, label)

    lines = [line(f"{namespace}_qps", snap.get("qps", 0.0)),
             line(f"{namespace}_uptime_seconds",
                  snap.get("uptime_s", 0.0))]
    for name, v in sorted((snap.get("counters") or {}).items()):
        lines.append(line(f"{namespace}_{name}", v))
    for name, v in sorted((snap.get("gauges") or {}).items()):
        lines.append(line(f"{namespace}_{name}", v))
    for name, h in sorted((snap.get("histograms") or {}).items()):
        base = f"{namespace}_{name}"
        for q, stat in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(line(base, h.get(stat, 0.0), ("quantile", q)))
        lines.append(line(base + "_sum", h.get("sum", 0.0)))
        lines.append(line(base + "_count", h.get("count", 0)))
        lines.append(line(base + "_max", h.get("max", 0.0)))
    return "\n".join(lines) + "\n"


# -- the process-wide registry ---------------------------------------------

_process_lock = threading.Lock()
_process: Optional[MetricsRegistry] = None
_snapshot_thread: Optional[threading.Thread] = None


def process_registry() -> MetricsRegistry:
    """THE process registry (namespace ``p1t``) every non-serving
    subsystem reports into — created on first touch. If the
    environment carries ``PADDLE_OBS_SNAPSHOT`` (a Supervisor set it
    for this worker), a daemon thread starts publishing the registry's
    snapshot there every second so the parent's ``/metrics`` page can
    aggregate children it cannot RPC into."""
    global _process
    m = _process
    if m is None:
        with _process_lock:
            if _process is None:
                _process = MetricsRegistry(namespace="p1t")
                _maybe_start_snapshot_writer()
            m = _process
    return m


def reset_process_registry() -> MetricsRegistry:
    """Replace the process registry with a fresh one (test isolation).
    Arms the snapshot writer like first touch does — a worker that
    resets before ever touching the registry must still publish."""
    global _process
    with _process_lock:
        _process = MetricsRegistry(namespace="p1t")
        _maybe_start_snapshot_writer()
        return _process


def metrics_on() -> bool:
    """Whether per-step (hot-path) training instrumentation is enabled
    — the ``obs_metrics`` flag. Cold-path lifecycle counters record
    regardless; this gate exists so the disabled per-step cost is ≈ 0
    (the bench --obs contract)."""
    from ..core import flags as core_flags
    return bool(core_flags.flag("obs_metrics"))


def step_registry() -> Optional[MetricsRegistry]:
    """The process registry when ``obs_metrics`` is on, else None —
    the one-call guard hot paths use (``m = step_registry()`` then
    ``if m is not None: ...``)."""
    return process_registry() if metrics_on() else None


def write_snapshot_file(path: str,
                        registry: Optional[MetricsRegistry] = None
                        ) -> None:
    """Atomically publish one registry snapshot as JSON (tmp+rename so
    a reader never sees a torn file)."""
    reg = registry if registry is not None else process_registry()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(reg.snapshot(), f)
    os.replace(tmp, path)


def _maybe_start_snapshot_writer() -> None:
    # caller holds _process_lock
    global _snapshot_thread
    path = os.environ.get(SNAPSHOT_ENV)
    if not path or _snapshot_thread is not None:
        return

    def loop():
        import warnings
        warned = False
        while True:
            time.sleep(_SNAPSHOT_INTERVAL_S)
            try:
                write_snapshot_file(path)
            except OSError as e:
                if not warned:  # once — telemetry must never kill work
                    warned = True
                    warnings.warn(
                        f"obs snapshot file {path!r} not writable: {e}")

    _snapshot_thread = threading.Thread(target=loop, daemon=True,
                                        name="p1t-obs-snapshot")
    _snapshot_thread.start()
