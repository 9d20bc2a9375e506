"""Runtime lock-order sanitizer.

A copy of the JAX package's ``core/locks.py`` (stdlib only), kept
with its structure and names: the port imports nothing of that package.
The supervisor, trainer and servers it names there are the JAX
package's; the port's data loader is what calls it here.

The static pass (``tools/lint/lock_discipline.py``) sees lexical
nesting; it cannot see an acquisition order composed across method
calls — fleet lock, then a metrics lock inside ``counter()``, then a
supervisor table lock three frames down. This module covers that
dynamically, the TSan-lite way:

* Hot classes construct their locks through :func:`make_lock` /
  :func:`make_rlock`. With the ``debug_lock_sanitizer`` flag OFF (the
  default) these return **plain** ``threading.Lock``/``RLock`` — the
  disabled cost is structurally zero (one flag read at construction,
  nothing on acquire/release; the test asserts the returned type IS
  the stdlib type).

* With the flag ON (the CI concurrency lanes), every acquisition
  records the edge ``held -> acquiring`` in one process-wide order
  graph, keyed by lock *name*. Acquiring B while holding A when some
  thread previously acquired A while holding B raises the typed
  :class:`LockOrderError` at the second site — the deadlock that
  would otherwise need the exact unlucky interleaving to manifest
  fires deterministically on ANY run that exercises both orders.
  Reentrant RLock re-acquisition records nothing.

* :func:`note_blocking` marks a blocking region (a socket ``recv``, a
  future wait). Under the sanitizer, entering one while the current
  thread holds ANY sanitized lock raises the typed
  :class:`BlockingUnderLockError` — the hold-while-blocking class
  (a ``sendall`` under a lock) caught at runtime wherever the
  static pass's lexical view ran out. Zero-cost when off: one module
  bool test, no allocation.

Edges are keyed by name, not object identity: two fleets' ``_lock``
instances are the same DISCIPLINE, and keying by name makes the order
graph survive object churn (and stay readable in the error message).
Names default to ``<ClassName attr>``-style strings passed by the
construction sites.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .errors import EnforceNotMet

__all__ = ["LockOrderError", "BlockingUnderLockError", "make_lock",
           "make_rlock", "note_blocking", "sanitizing", "held_locks",
           "reset_order_graph"]


class LockOrderError(EnforceNotMet):
    """Two locks were acquired in opposite orders by (possibly)
    different threads — a latent deadlock."""


class BlockingUnderLockError(EnforceNotMet):
    """A blocking call ran while the thread held a sanitized lock."""


# flipped True the first time a sanitized lock is constructed — the
# only cost note_blocking() pays when the sanitizer never armed
_armed = False

_graph_lock = threading.Lock()
# (before, after) -> "thread/site" note of the first time that order
# was observed; the evidence quoted when the inverse order shows up
_order: Dict[Tuple[str, str], str] = {}

_tls = threading.local()


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """BFS over the recorded order edges (caller holds _graph_lock).
    Returns the node path src..dst, or None."""
    if src == dst:
        return [src]
    prev: Dict[str, str] = {}
    frontier = [src]
    while frontier:
        nxt = []
        for n in frontier:
            for (a, b) in _order:
                if a != n or b in prev or b == src:
                    continue
                prev[b] = n
                if b == dst:
                    path = [dst]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return list(reversed(path))
                nxt.append(b)
        frontier = nxt
    return None


def _held() -> List["_SanitizedLock"]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def sanitizing() -> bool:
    """Whether the ``debug_lock_sanitizer`` flag is on (read per call —
    construction-time decisions go through make_lock)."""
    from . import flags as core_flags
    return bool(core_flags.flag("debug_lock_sanitizer"))


def reset_order_graph() -> None:
    """Drop recorded acquisition orders (test isolation)."""
    with _graph_lock:
        _order.clear()


def held_locks() -> List[str]:
    """Names of sanitized locks the current thread holds (tests)."""
    return [lk.name for lk in _held()]


class _SanitizedLock:
    """Order-recording wrapper with the ``threading.Lock`` surface
    (plus what ``threading.Condition`` needs: ``acquire``/``release``
    and context management; Condition's ``_is_owned`` fallback probes
    ``acquire(False)``, which this supports)."""

    _reentrant = False

    def __init__(self, name: str, allow_blocking: bool = False):
        self.name = name
        self.allow_blocking = allow_blocking
        self._lock = (threading.RLock() if self._reentrant
                      else threading.Lock())

    # -- order bookkeeping --------------------------------------------------

    def _before_acquire(self) -> None:
        held = _held()
        if not held:
            return
        if self._reentrant and any(lk is self for lk in held):
            return  # reentrant re-acquisition: no new edge
        me = self.name
        tname = threading.current_thread().name
        for prior in held:
            if prior is self:
                continue
            a, b = prior.name, me
            if a == b:
                # two DIFFERENT instances sharing a name, nested: the
                # name-keyed graph cannot order them — and if the same
                # pair ever nests the other way round the deadlock is
                # invisible to it. Typed, with the fix in the message.
                raise LockOrderError(
                    f"nested acquisition of two distinct locks both "
                    f"named '{a}' (thread '{tname}') — the sanitizer "
                    "orders locks BY NAME, so same-name nesting is "
                    "unverifiable; give the instances distinct names "
                    "(e.g. make_lock(f'Class[{rank}].lock')) or don't "
                    "nest them")
            with _graph_lock:
                # an inversion is any recorded PATH b ->* a (direct or
                # transitive: A->B, B->C elsewhere makes C-while-
                # holding-A a 3-lock cycle) — lockdep-style closure;
                # a != b here, so a found path always has >= 2 nodes
                path = _find_path(b, a)
                if path is not None:
                    raise LockOrderError(
                        f"lock-order inversion: thread '{tname}' is "
                        f"acquiring '{b}' while holding '{a}', but "
                        "the opposite order "
                        + " -> ".join(path)
                        + f" was previously observed "
                        f"({_order.get((path[0], path[1]), '?')}) — "
                        "threads running these paths concurrently "
                        "deadlock; pick one global order")
                _order.setdefault((a, b), f"thread '{tname}'")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._before_acquire()
        got = (self._lock.acquire(blocking, timeout) if blocking
               else self._lock.acquire(False))
        if got:
            _held().append(self)
        return got

    def release(self) -> None:
        self._lock.release()
        held = _held()
        # remove the most recent entry for THIS lock (locks are almost
        # always released LIFO, but nothing requires it)
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<SanitizedLock {self.name!r}>"


class _SanitizedRLock(_SanitizedLock):
    _reentrant = True


def make_lock(name: str,
              allow_blocking: bool = False) -> "threading.Lock":
    """A mutex for a hot shared structure: plain ``threading.Lock``
    unless ``debug_lock_sanitizer`` is on, then an order-recording
    wrapper. ``name`` keys the process-wide order graph — use a
    stable ``Class.attr``-style string. ``allow_blocking=True``
    declares an *administrative* mutex DESIGNED to be held across
    blocking operations (a deploy roll, a one-shot build): it still
    participates in order tracking, but holding it does not trip
    :func:`note_blocking` — the declaration is greppable and
    deliberate, like a ``# noqa`` with a type signature."""
    global _armed
    if not sanitizing():
        return threading.Lock()
    _armed = True
    return _SanitizedLock(name, allow_blocking)


def make_rlock(name: str,
               allow_blocking: bool = False) -> "threading.RLock":
    global _armed
    if not sanitizing():
        return threading.RLock()
    _armed = True
    return _SanitizedRLock(name, allow_blocking)


def note_blocking(what: str) -> None:
    """Mark a blocking region (socket recv, future wait). Under the
    sanitizer, raises typed when the current thread holds any
    sanitized lock — the hold-while-blocking class. Free when the
    sanitizer never armed (one module bool test)."""
    if not _armed:
        return
    held = [lk for lk in _held() if not lk.allow_blocking]
    if held:
        tname = threading.current_thread().name
        raise BlockingUnderLockError(
            f"blocking call ({what}) on thread '{tname}' while "
            f"holding sanitized lock(s) "
            f"{[lk.name for lk in held]} — every thread needing them "
            "convoys behind this wait; release before blocking")
