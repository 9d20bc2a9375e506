"""Structured JSONL lifecycle journal.

A copy of the JAX package's ``obs/events.py`` (stdlib only), kept
with its structure and names: the port imports nothing of that package.
The supervisor, trainer and servers it names there are the JAX
package's; the port's data loader is what calls it here.

The stack's lifecycle moments — worker restart, world resize, model
deploy, overload shed, sample quarantine, checkpoint commit — were
print/warn scatter: greppable at best, unparseable at scale. With the
``obs_events_file`` flag (or the ``PADDLE_OBS_EVENTS`` env var a parent
stamps into worker env) set, :func:`emit` appends one JSON object per
event::

    {"ts": 1754300000.123, "pid": 4242, "event": "worker_restart",
     "rank": 3, "incarnation": 2}

Appends are single ``write()`` calls on an ``O_APPEND`` handle, so many
processes share one journal without interleaving torn lines. Disabled
(the default) an emit is one flag read and an early return; enabled it
must never kill the work it observes — write failures warn once and
stop trying. The human-readable prints/warns stay — the journal is for
machines, the console for people.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["EVENTS_ENV", "emit", "events_path", "read_events",
           "set_flight_tap"]

EVENTS_ENV = "PADDLE_OBS_EVENTS"

_lock = threading.Lock()
_file = None   # (pid, path, fh) — reopened after fork or path change
_warned = False

# lifecycle tap: the flight recorder (obs/flight.py) subscribes so its
# ring keeps recent events even without a journal file configured.
# None (default) keeps the disabled emit a flag read + pointer test.
_flight_tap = None


def set_flight_tap(fn) -> None:
    """Install (or clear, with None) the lifecycle-record subscriber."""
    global _flight_tap
    _flight_tap = fn


def events_path() -> str:
    """The active journal path: the ``obs_events_file`` flag, else the
    ``PADDLE_OBS_EVENTS`` env var, else '' (disabled)."""
    from ..core import flags as core_flags
    return (core_flags.flag("obs_events_file")
            or os.environ.get(EVENTS_ENV, ""))


def emit(event: str, **fields) -> None:
    """Append one lifecycle record; no-op when no journal is
    configured. ``fields`` must be JSON-serializable or reprable."""
    global _file, _warned
    path = events_path()
    tap = _flight_tap
    if not path and tap is None:
        return
    rec = {"ts": round(time.time(), 6), "pid": os.getpid(),
           "event": str(event)}
    rec.update(fields)
    if tap is not None:
        try:
            tap(rec)
        except Exception:  # noqa: broad-except — the flight ring must
            # never kill the lifecycle moment it records
            pass
    if not path:
        return
    try:
        line = json.dumps(rec, default=repr) + "\n"
    except (TypeError, ValueError):
        line = json.dumps({"ts": rec["ts"], "pid": rec["pid"],
                           "event": rec["event"],
                           "fields": repr(fields)}) + "\n"
    with _lock:
        pid = os.getpid()
        if _file is None or _file[0] != pid or _file[1] != path:
            try:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                _file = (pid, path, open(path, "a"))
            except OSError as e:
                if not _warned:
                    _warned = True
                    import warnings
                    warnings.warn(
                        f"obs events file {path!r} not writable: {e}; "
                        "lifecycle journal disabled for this process")
                _file = (pid, path, None)
        fh = _file[2]
        if fh is None:
            return
        try:
            fh.write(line)
            fh.flush()
        except (OSError, ValueError):
            pass  # the journal must never kill the work it observes


def read_events(path: Optional[str] = None) -> list:
    """Parse the journal back (tests/tools), skipping torn lines."""
    path = path or events_path()
    out = []
    if not path:
        return out
    try:
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    out.append(json.loads(ln))
                except ValueError:
                    continue
    except OSError:
        pass
    return out
