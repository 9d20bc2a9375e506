"""Worker-side health channel for the elastic supervisor.

A copy of the JAX package's ``core/health.py`` (stdlib only), kept
with its structure and names: the port imports nothing of that package.
The supervisor, trainer and servers it names there are the JAX
package's; the port's data loader is what calls it here.

The :class:`~paddle1_tpu.distributed.supervisor.Supervisor` owns worker
subprocesses and needs three signals a plain ``Popen.poll()`` cannot
give: *liveness* (a worker that is alive but wedged in a deadlocked
queue or stuck collective polls as healthy forever), *self-reported
health* (a worker that knows it is broken before it crashes), and a
*stack dump* channel for diagnosing a hang post-mortem. This module is
the worker half of that contract; it is deliberately dependency-light
(stdlib + an optional lazy chaos import) so a supervised worker can
speak the protocol before — or without — importing the full package.

Protocol (all via environment variables stamped by the Supervisor):

``PADDLE_FT_HEARTBEAT_FILE``
    Per-rank heartbeat file. :func:`beat` touches it (mtime is the
    signal); the supervisor declares a hang when the age exceeds
    ``ft_hang_timeout``. Workers call :func:`beat` once per training
    step — it is a no-op (one env lookup) when unsupervised, and
    rate-limited to at most one ``utime`` per ``_MIN_BEAT_INTERVAL_S``
    when supervised.
``PADDLE_FT_STACKDUMP_FILE``
    Where ``faulthandler`` writes the all-threads traceback when the
    supervisor sends ``SIGABRT`` to a hung worker (registered on first
    :func:`beat`; registration replaces the default abort so the
    supervisor can still SIGKILL afterwards).
``PADDLE_FT_WORKER_INCARNATION``
    0 for the first launch, incremented per restart. Worker-level chaos
    points (``worker_kill``/``worker_hang``/``worker_unhealthy``) fire
    only in incarnation 0, so a restarted worker replays clean — the
    same fire-once contract as every other chaos point.

First :func:`beat` also installs a ``SIGTERM`` handler that calls
:func:`.chaos.request_preemption` and marks a drain
request, so a supervisor ``drain`` (or a real preemption SIGTERM)
unwinds through the resilient loop's graceful-checkpoint path instead
of killing mid-step. The env vars are removed from ``os.environ`` at
install time: grandchild processes (e.g. ProcessMultiTrainer workers
forwarding ``PADDLE_*``) must not adopt their parent's heartbeat file
or signal handlers.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Optional

try:  # standalone import (tests load this file directly) lacks a package
    from . import chaos as _chaos
except ImportError:  # pragma: no cover - only hit outside the package
    _chaos = None

__all__ = ["beat", "supervised", "incarnation", "report_unhealthy",
           "request_drain", "drain_requested", "add_drain_callback",
           "remove_drain_callback", "reset",
           "HEARTBEAT_ENV", "STACKDUMP_ENV", "INCARNATION_ENV",
           "UNHEALTHY_SUFFIX"]

HEARTBEAT_ENV = "PADDLE_FT_HEARTBEAT_FILE"
STACKDUMP_ENV = "PADDLE_FT_STACKDUMP_FILE"
INCARNATION_ENV = "PADDLE_FT_WORKER_INCARNATION"
# the unhealthy marker sits next to the heartbeat file: one env var
# carries the whole channel
UNHEALTHY_SUFFIX = ".unhealthy"

_MIN_BEAT_INTERVAL_S = 0.05

_lock = threading.Lock()
_installed = False
_hb_file: Optional[str] = None
_incarnation = 0
_last_beat = 0.0
_beats = 0
_drain = False
_dump_fh = None  # keep the faulthandler file object alive
_prev_sigterm = None  # the script's own handler, chained by _on_sigterm
# drain subscribers (serving.Server registers one): each must be
# signal-handler safe — set a flag/Event, never do work
_drain_callbacks: list = []


def _install_from_env() -> None:
    """One-time adoption of the supervisor's env protocol (idempotent;
    called under ``_lock``)."""
    global _installed, _hb_file, _incarnation, _dump_fh
    _installed = True
    _hb_file = os.environ.pop(HEARTBEAT_ENV, None)
    if _hb_file is None:
        return
    _incarnation = int(os.environ.pop(INCARNATION_ENV, "0") or 0)
    dump_path = os.environ.pop(STACKDUMP_ENV, None)
    if dump_path:
        try:
            import faulthandler
            _dump_fh = open(dump_path, "w")
            # enable (register() refuses SIGABRT — it is one of
            # faulthandler's own fatal signals): the supervisor's
            # SIGABRT makes the wedged worker dump all threads to the
            # per-rank file and die; the supervisor reads the dump,
            # then SIGKILLs any straggler
            faulthandler.enable(file=_dump_fh, all_threads=True)
        except (OSError, ValueError, AttributeError) as e:
            print(f"health: stack-dump channel disabled ({e})",
                  file=sys.stderr)
    if threading.current_thread() is threading.main_thread():
        try:
            global _prev_sigterm
            prev = signal.signal(signal.SIGTERM, _on_sigterm)
            if prev is not _on_sigterm:
                # keep the EARLIEST real handler: a reset()+reinstall
                # must not capture our own handler as "previous" (the
                # chain would recurse into itself on the drain SIGTERM)
                _prev_sigterm = prev
        except (OSError, ValueError) as e:  # pragma: no cover
            print(f"health: SIGTERM drain handler not installed ({e})",
                  file=sys.stderr)


def _on_sigterm(signum, frame):
    """Supervisor drain (or a real preemption notice): request a
    graceful stop. Signal-handler safe: sets two flags, then chains to
    the script's own pre-existing SIGTERM handler (its cleanup must
    still run)."""
    global _drain
    _drain = True
    if _chaos is not None:
        _chaos.request_preemption()
    _notify_drain()
    if callable(_prev_sigterm):
        _prev_sigterm(signum, frame)


def _notify_drain() -> None:
    """Run registered drain subscribers (signal-context safe: they only
    set flags). A failing subscriber must not block the others or the
    chained handler."""
    for cb in list(_drain_callbacks):
        try:
            cb()
        except Exception:
            pass


def supervised() -> bool:
    """Whether this process runs under a Supervisor heartbeat channel."""
    with _lock:
        if not _installed:
            _install_from_env()
        return _hb_file is not None


def incarnation() -> int:
    """This worker's restart incarnation under its Supervisor (0 for
    the first launch, +1 per relaunch; 0 when unsupervised). Chaos
    arming gates on it: worker/replica points fire in incarnation 0
    only, so a restarted life replays clean."""
    with _lock:
        if not _installed:
            _install_from_env()
        return _incarnation


def beat() -> None:
    """Touch the per-rank heartbeat file (the liveness signal). Called
    once per training step by ``ResilientTrainer.fit`` and
    ``fleet/process_trainer._worker_main``; cheap no-op when the process
    is not supervised. Also the worker-level chaos trigger point."""
    global _last_beat, _beats
    with _lock:
        if not _installed:
            _install_from_env()
        if _hb_file is None:
            return
        _beats += 1
        beats = _beats
        now = time.monotonic()
        if now - _last_beat >= _MIN_BEAT_INTERVAL_S:
            _last_beat = now
            try:
                with open(_hb_file, "a"):
                    os.utime(_hb_file, None)
            except OSError:  # hb dir vanished (teardown race): not fatal
                pass
    _check_worker_chaos(beats)


def _check_worker_chaos(beats: int) -> None:
    """Fire armed worker-level chaos on this beat. Incarnation 0 only:
    a restarted worker must replay clean (the fire-once contract)."""
    if _chaos is None or _incarnation != 0 or not _chaos.enabled():
        return
    action = _chaos.check_worker(_rank())
    if action is None:
        return
    if action == _chaos.WORKER_KILL:
        # an ungraceful death: no cleanup, no atexit — SIGKILL self
        os.kill(os.getpid(), signal.SIGKILL)
    elif action == _chaos.WORKER_HANG:
        # a wedge: stop beating and block forever (the supervisor's
        # hang detector + SIGABRT dump + SIGKILL is the only way out)
        while True:  # pragma: no cover - exits only via SIGKILL
            time.sleep(3600)
    elif action == _chaos.WORKER_UNHEALTHY:
        report_unhealthy("chaos: injected unhealthy report "
                         f"(beat {beats})")


def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    except ValueError:  # pragma: no cover
        return 0


def report_unhealthy(reason: str) -> None:
    """Explicitly tell the supervisor this worker is unhealthy (it keeps
    running; the supervisor responds per policy). No-op when
    unsupervised."""
    with _lock:
        if not _installed:
            _install_from_env()
        if _hb_file is None:
            return
        try:
            with open(_hb_file + UNHEALTHY_SUFFIX, "w") as f:
                f.write(reason)
        except OSError:  # pragma: no cover
            pass


def request_drain() -> None:
    """Programmatic equivalent of the supervisor's drain SIGTERM:
    checkpoint at the next opportunity, then stop."""
    global _drain
    _drain = True
    if _chaos is not None:
        _chaos.request_preemption()
    _notify_drain()


def add_drain_callback(cb) -> None:
    """Subscribe to drain requests (SIGTERM under supervision, or
    :func:`request_drain`). The callback may fire from a signal handler:
    it must only set a flag/Event. Duplicate registrations are
    collapsed; unsubscribe with :func:`remove_drain_callback` (a
    long-lived process creating servers per model reload must not
    accumulate dead subscribers); ``reset()`` clears the list."""
    with _lock:
        if cb not in _drain_callbacks:
            _drain_callbacks.append(cb)


def remove_drain_callback(cb) -> None:
    """Unsubscribe a drain callback (no-op if not registered)."""
    with _lock:
        try:
            _drain_callbacks.remove(cb)
        except ValueError:
            pass


def drain_requested() -> bool:
    """Whether a graceful stop was requested (drain SIGTERM or
    :func:`request_drain`). Checked by ``ResilientTrainer.fit`` after
    its graceful-preemption checkpoint."""
    return _drain


def reset() -> None:
    """Forget the installed channel (test isolation). Does not undo the
    SIGTERM/faulthandler registration."""
    global _installed, _hb_file, _incarnation, _last_beat, _beats, _drain
    with _lock:
        _installed = False
        _hb_file = None
        _incarnation = 0
        _last_beat = 0.0
        _beats = 0
        _drain = False
        _drain_callbacks.clear()
