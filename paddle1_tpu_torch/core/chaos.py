"""Deterministic chaos injection for the fault-tolerance stack.

A copy of the JAX package's ``core/chaos.py`` (stdlib only;
``maybe_poison`` walks a batch's dicts, lists and tuples itself), kept
with its structure and names: the port imports nothing of that package.
The supervisor, trainer and servers it names there are the JAX
package's; the port's data loader is what calls it here.

Long multi-host runs die to a short list of causes — a NaN batch out of a
corrupt shard, a checkpoint write killed mid-flight, a dataloader worker
raising, a preemption notice — and the recovery code for each is exactly
the code that never runs in a clean test environment. This module makes
those failures *first-class, reproducible inputs*: each injection point
carries a monotone occurrence counter, and a chaos spec arms specific
occurrences ("the 3rd batch", "the 2nd checkpoint write"). Because the
counters are deterministic, a failure fires exactly once per armed
occurrence — so a retried/replayed operation comes back clean, which is
what lets the resilience tests assert bit-parity between an interrupted
run and an uninterrupted one.

Spec syntax (comma-separated, each entry ``point@N`` with 1-based N;
repeat a point to arm several occurrences)::

    nan_batch@3,ckpt_fail@2,preempt@7,loader_raise@5

Worker-level points take an optional rank qualifier ``point@N:R`` —
"fire on the Nth health beat of rank R" (without ``:R`` every rank
fires on its Nth beat; chaos state is process-local, so each worker
counts its own beats)::

    worker_kill@5:1,worker_hang@8:0

Dataloader-level points use the same qualifier with a *worker id*
(``loader_worker_kill@3:0`` = worker 0's 3rd task; the single-process
loader path counts as worker 0). They are armed in the loader worker
PROCESS (the parent forwards :func:`active_spec` at spawn) and only in
loader-worker incarnation 0, so a recovered/re-spawned worker replays
clean — the same fire-once contract as the supervisor points::

    loader_worker_kill@4:0,corrupt_sample@3:1,loader_stall@2:0

Armed via :func:`configure` or the ``FLAGS_ft_chaos`` env/flag (read by
``configure_from_flags``). All state is process-local and reset by
:func:`reset`.

Injection points
----------------
``nan_batch``     — :func:`maybe_poison` rewrites the first floating leaf
                    of the batch to NaN (a corrupt input shard).
``ckpt_fail``     — :func:`check_checkpoint_write` raises ``IOError``
                    inside ``CheckpointManager.save`` *before* the commit
                    rename, leaving a partial tmp dir behind (a write
                    killed mid-flight).
``loader_raise``  — :func:`check_loader` raises inside the DataLoader
                    prefetch producer (a worker crash).
``preempt``       — :func:`check_preempt` raises
                    :class:`SimulatedPreemption` (the maintenance-event
                    signal; also raised after :func:`request_preemption`,
                    which is safe to call from a real signal handler).
``serve_slow_step`` — :func:`check_serve_slow` returns True on an armed
                    serving micro-batch dispatch; the Batcher stalls
                    that dispatch for ``serve_chaos_slow_s`` seconds (a
                    slow/hiccuping executable — the deadline-expiry and
                    shed paths' reproducible trigger).

Worker-level points (checked by :func:`check_worker` from
``core.health.beat``, i.e. once per training step of a *supervised*
worker; incarnation 0 only, so a restarted worker replays clean):

``worker_kill``      — SIGKILL self (an ungraceful worker death the
                       Supervisor must detect via ``poll`` and restart
                       from the last committed checkpoint — or, under
                       the elastic ``resize`` policy, answer with a
                       shrink-and-continue into a smaller world; the
                       incarnation-0 gate below is what keeps the kill
                       from re-firing in every resized life).
``worker_hang``      — stop beating and block forever (a deadlocked
                       queue / stuck collective; the Supervisor's
                       heartbeat ager must catch it, collect a SIGABRT
                       stack dump, and respond per policy).
``worker_unhealthy`` — write the explicit unhealthy marker and keep
                       running (a worker that knows it is broken).

Dataloader-level points (checked inside the input pipeline; all pure
bookkeeping — the loader performs the kill/sleep/raise):

``loader_worker_kill`` — :func:`check_loader_worker_kill` on the Nth
                       task a loader worker picks up; the worker
                       SIGKILLs itself (an OOM-killed decode process
                       the parent must detect and re-spawn).
``corrupt_sample``   — :func:`check_sample` raises
                       :class:`ChaosInjectedError` on the Nth sample
                       fetch (a corrupt record; drives the
                       ``loader_bad_sample`` skip/quarantine policy).
``loader_stall``     — :func:`check_loader_stall` True on the Nth
                       task/batch; the loader sleeps
                       ``loader_chaos_stall_s`` (a wedged reader the
                       input-stall watchdog must catch).

Serving-replica points (checked by :func:`check_replica` from the
replica worker's request loop — one shared counter per replica process,
qualifier = the replica's fleet rank; armed in the replica PROCESS via
the spec the fleet forwards at spawn, and only in incarnation 0 so a
supervisor-restarted replica replays clean):

``replica_kill``     — SIGKILL self mid-request (an OOM-killed serving
                       worker; the fleet must fail over its in-flight
                       requests to a healthy replica and the Supervisor
                       must relaunch it).
``replica_hang``     — stop reading the fleet connection and block
                       forever (a wedged RPC plane; the fleet's
                       per-request transport timeout + circuit breaker
                       is the detector — the replica's Batcher keeps
                       heartbeating, so Popen/heartbeat watching alone
                       would never notice).
``replica_slow``     — handle this request only after sleeping
                       ``serve_chaos_slow_s`` (a hiccuping replica —
                       drives the adaptive-admission overload path).

Collective-schedule point (checked by :func:`check_collective` from
the ``distributed/collective.py`` wrappers — one shared counter per
process, qualifier = the trainer rank)::

``collective_skip``  — ``collective_skip@N[:R]``: rank R (any rank
                       when unqualified) SKIPS its Nth collective op —
                       the wrapper returns its input untouched and
                       journals nothing, seeding exactly the
                       rank-divergent schedule the collective-schedule
                       sanitizer's cross-rank verifier must turn into
                       a typed CollectiveDivergenceError (on hardware
                       this shape deadlocks).

Generative-serving points (checked by :func:`check_gen_step` once per
continuous-batching decode step; the qualifier is a SLOT id)::

``gen_slot_wedge``   — ``gen_slot_wedge@N[:S]``: on the Nth decode
                       step, slot S (the lowest active slot when
                       unqualified) is declared wedged. The engine must
                       fail ONLY that slot's TokenStream typed, release
                       the slot, and leave cohabiting sequences
                       bit-identical to an uncontended run — the
                       continuous-batching isolation contract.
``gen_slow_step``    — stall the Nth decode dispatch for
                       ``serve_chaos_slow_s`` (drives the mid-stream
                       wall-deadline path). Action belongs to the
                       engine loop; this stays pure bookkeeping.

Generation-fleet points (the GenerationFleet's mid-stream failure
matrix; armed in the gen-replica PROCESS via the spec the fleet
forwards at spawn, incarnation 0 only so a restarted replica replays
clean):

``gen_replica_kill`` — checked by :func:`check_gen_replica` once per
                       TOKEN FRAME the gen replica streams back
                       (qualifier = fleet rank): SIGKILL self MID-
                       STREAM, after some tokens have already reached
                       the client — the fleet must re-admit every
                       in-flight stream on a survivor from
                       ``prompt + tokens already emitted`` and the
                       continuation must be bit-identical.
``gen_replica_hang`` — same counter: stop streaming frames (and stay
                       otherwise alive and heartbeating) — the
                       wedged-stream class only the fleet's stream-
                       silence deadline can catch.
``gen_page_pressure`` — checked by :func:`check_gen_pressure` once per
                       scheduler tick (own counter, no qualifier): the
                       scheduler claims every free KV page and holds
                       them for a few ticks — forcing decode page
                       faults so the preemption path (shed prefix
                       cache, preempt lowest-priority stream, park +
                       re-admit bit-identically) runs deterministically.

Parameter-server points (checked by :func:`check_ps` once per REQUEST
the TableServer handles; armed in the PS server PROCESS via the env
the owner forwards at spawn, qualifier = the PS server rank):

``ps_kill``          — ``ps_kill@N[:R]``: SIGKILL self on the Nth
                       request, AFTER applying + checkpointing it but
                       BEFORE acking — the client's bounded
                       retry/reconnect replays the un-acked request
                       into the restarted-from-checkpoint server, and
                       the push-epoch fence must make the replay
                       idempotent (exactly-once even when the dead
                       server DID apply it).
``ps_hang``          — stall the Nth request past the client's socket
                       timeout (a wedged PS — the retry path's
                       reconnect must turn it into a stall, not a
                       trainer crash).

Delta-pipeline points (checked inside ``DeltaLog.publish``; each
counts its own publishes, qualifier unused):

``delta_corrupt``    — bit-flip the Nth published delta file after its
                       CRC was computed: the subscriber's verify must
                       skip + count it, never apply it.
``delta_gap``        — after the Nth publish, prune every older delta
                       from under any lagging reader: the subscriber
                       must surface a typed ``DeltaGapDetected`` and
                       resync from a snapshot instead of silently
                       serving stale rows.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union

__all__ = [
    "SimulatedPreemption", "ChaosInjectedError", "configure",
    "configure_from_flags", "reset", "enabled", "fire", "counts",
    "active_spec",
    "maybe_poison", "check_checkpoint_write", "check_loader",
    "check_preempt", "check_serve_slow", "check_worker",
    "check_sample", "check_loader_worker_kill", "check_loader_stall",
    "check_replica", "check_gen_step", "check_collective",
    "check_gen_replica", "check_gen_pressure",
    "check_ps", "check_delta_corrupt", "check_delta_gap",
    "request_preemption", "preemption_requested",
    "POISON_BATCH", "CKPT_FAIL", "LOADER_RAISE", "PREEMPT", "SERVE_SLOW",
    "WORKER_KILL", "WORKER_HANG", "WORKER_UNHEALTHY",
    "LOADER_WORKER_KILL", "CORRUPT_SAMPLE", "LOADER_STALL",
    "REPLICA_KILL", "REPLICA_HANG", "REPLICA_SLOW",
    "GEN_SLOT_WEDGE", "GEN_SLOW_STEP", "COLLECTIVE_SKIP",
    "GEN_REPLICA_KILL", "GEN_REPLICA_HANG", "GEN_PAGE_PRESSURE",
    "PS_KILL", "PS_HANG", "DELTA_CORRUPT", "DELTA_GAP",
]

POISON_BATCH = "nan_batch"
CKPT_FAIL = "ckpt_fail"
LOADER_RAISE = "loader_raise"
PREEMPT = "preempt"
SERVE_SLOW = "serve_slow_step"
WORKER_KILL = "worker_kill"
WORKER_HANG = "worker_hang"
WORKER_UNHEALTHY = "worker_unhealthy"
LOADER_WORKER_KILL = "loader_worker_kill"
CORRUPT_SAMPLE = "corrupt_sample"
LOADER_STALL = "loader_stall"
REPLICA_KILL = "replica_kill"
REPLICA_HANG = "replica_hang"
REPLICA_SLOW = "replica_slow"
GEN_SLOT_WEDGE = "gen_slot_wedge"
GEN_SLOW_STEP = "gen_slow_step"
COLLECTIVE_SKIP = "collective_skip"
GEN_REPLICA_KILL = "gen_replica_kill"
GEN_REPLICA_HANG = "gen_replica_hang"
GEN_PAGE_PRESSURE = "gen_page_pressure"
PS_KILL = "ps_kill"
PS_HANG = "ps_hang"
DELTA_CORRUPT = "delta_corrupt"
DELTA_GAP = "delta_gap"

_WORKER_POINTS = (WORKER_KILL, WORKER_HANG, WORKER_UNHEALTHY)
# loader points share the worker points' ":qualifier" grammar, but the
# qualifier is a LOADER worker id, not a trainer rank
_LOADER_POINTS = (LOADER_WORKER_KILL, CORRUPT_SAMPLE, LOADER_STALL)
# serving-replica points: the qualifier is the REPLICA rank in its fleet
_REPLICA_POINTS = (REPLICA_KILL, REPLICA_HANG, REPLICA_SLOW)
# generative-serving points: the qualifier is a decode SLOT id; both
# share the per-step counter check_gen_step advances
_GEN_POINTS = (GEN_SLOT_WEDGE, GEN_SLOW_STEP)
# collective-schedule point: the qualifier is the trainer rank
_COLLECTIVE_POINTS = (COLLECTIVE_SKIP,)
# generation-fleet points: kill/hang share one token-frame counter
# (qualifier = gen-replica fleet rank); page pressure counts its own
# scheduler ticks (qualifier unused)
_GEN_FLEET_POINTS = (GEN_REPLICA_KILL, GEN_REPLICA_HANG,
                     GEN_PAGE_PRESSURE)
# parameter-server points: kill/hang share one REQUEST counter
# (qualifier = the PS server rank)
_PS_POINTS = (PS_KILL, PS_HANG)
# delta-pipeline points: each counts its own publishes (qualifier unused)
_DELTA_POINTS = (DELTA_CORRUPT, DELTA_GAP)
_QUALIFIED_POINTS = (_WORKER_POINTS + _LOADER_POINTS + _REPLICA_POINTS
                     + _GEN_POINTS + _COLLECTIVE_POINTS
                     + _GEN_FLEET_POINTS + _PS_POINTS + _DELTA_POINTS)
_POINTS = (POISON_BATCH, CKPT_FAIL, LOADER_RAISE,
           PREEMPT, SERVE_SLOW) + _QUALIFIED_POINTS


class SimulatedPreemption(BaseException):
    """A (simulated) preemption notice.

    Deliberately a ``BaseException`` — like ``KeyboardInterrupt`` — so
    that transient-failure retry wrappers written as ``except Exception``
    can never swallow it: a preemption must unwind to the resilient
    loop's preemption handler, not be retried in place.

    ``graceful=True`` marks a real advance NOTICE (the SIGTERM grace
    window of :func:`request_preemption`): the handler still has time
    to checkpoint the current known-good state, losing nothing. The
    armed ``preempt@N`` chaos point simulates the opposite — an
    ungraceful kill with no chance to save — and restores+replays.
    """

    def __init__(self, *args, graceful: bool = False):
        super().__init__(*args)
        self.graceful = graceful


class ChaosInjectedError(IOError):
    """The error raised by armed ``ckpt_fail``/``loader_raise`` points
    (an IOError: both model real I/O failures)."""


_lock = threading.Lock()
# point -> set of armed 1-based occurrence indices
_armed: Dict[str, set] = {}
# worker/loader point -> set of (occurrence, qualifier-or-None) pairs
_armed_worker: Dict[str, set] = {}
# point -> occurrences seen so far
_counters: Dict[str, int] = {}
_preempt_requested = False
# the spec string this process was armed with (canonical form) — what a
# parent forwards to spawned dataloader workers so they can arm their
# own process-local counters
_spec_str: str = ""


def reset() -> None:
    """Disarm every point and zero all counters (test isolation)."""
    global _preempt_requested, _spec_str
    with _lock:
        _armed.clear()
        _armed_worker.clear()
        _counters.clear()
        _preempt_requested = False
        _spec_str = ""


def configure(spec: Union[str, Dict[str, object], None]) -> None:
    """Arm injection points from a spec string (``"nan_batch@3,..."``;
    worker points take ``worker_kill@N:R`` = Nth beat of rank R) or a
    dict ``{point: N-or-list-of-N}``. Resets previous arming/counters."""
    reset()
    if not spec:
        return
    entries: List[Tuple[str, int, Optional[int]]] = []
    if isinstance(spec, str):
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            if "@" not in raw:
                raise ValueError(
                    f"chaos spec entry {raw!r} must be 'point@N' "
                    f"(points: {', '.join(_POINTS)})")
            name, _, n = raw.partition("@")
            n, colon, rank = n.partition(":")
            try:
                entries.append((name.strip(), int(n),
                                int(rank) if colon else None))
            except ValueError:
                raise ValueError(
                    f"chaos spec entry {raw!r} must be 'point@N' (or "
                    f"'point@N:rank' for worker points) with integer "
                    f"N/rank") from None
    else:
        for name, ns in spec.items():
            for n in (ns if isinstance(ns, (list, tuple)) else [ns]):
                entries.append((name, int(n), None))
    global _spec_str
    with _lock:
        for name, n, rank in entries:
            if name not in _POINTS:
                raise ValueError(
                    f"unknown chaos point {name!r} "
                    f"(points: {', '.join(_POINTS)})")
            if n < 1:
                raise ValueError(f"chaos occurrence must be >= 1, got {n}")
            if rank is not None and name not in _QUALIFIED_POINTS:
                raise ValueError(
                    f"rank qualifier '@{n}:{rank}' is only valid for "
                    f"worker/loader points ({', '.join(_QUALIFIED_POINTS)})")
            if rank is not None and rank < 0:
                raise ValueError(f"chaos rank must be >= 0, got {rank}")
            if name in _QUALIFIED_POINTS:
                _armed_worker.setdefault(name, set()).add((n, rank))
            else:
                _armed.setdefault(name, set()).add(n)
        # configure() is reset-then-arm (see docstring), so the armed
        # set and the forwarded spec string stay in lockstep
        _spec_str = ",".join(
            f"{name}@{n}" + (f":{rank}" if rank is not None else "")
            for name, n, rank in entries)


def configure_from_flags() -> bool:
    """Arm from the ``ft_chaos`` flag (set via ``FLAGS_ft_chaos`` env or
    ``set_flags``). Returns True when anything was armed."""
    from . import flags as core_flags
    spec = core_flags.flag("ft_chaos")
    if spec:
        configure(spec)
        return True
    return False


def enabled() -> bool:
    """Whether any point is armed (fast gate for hot paths)."""
    return bool(_armed) or bool(_armed_worker) or _preempt_requested


def counts() -> Dict[str, int]:
    """Occurrence counters seen so far (diagnostics/tests)."""
    with _lock:
        return dict(_counters)


def active_spec() -> str:
    """The canonical spec string this process is armed with ('' when
    nothing is armed). The DataLoader forwards it to spawned worker
    processes so loader-level points count occurrences in the process
    where the work actually happens."""
    return _spec_str


def fire(point: str) -> bool:
    """Record one occurrence of ``point``; True iff this occurrence is
    armed. Each armed occurrence fires exactly once — a replay of the
    same logical operation draws a fresh (higher) occurrence number and
    comes back clean."""
    with _lock:
        n = _counters.get(point, 0) + 1
        _counters[point] = n
        return n in _armed.get(point, ())


# -- point helpers (each a 1-2 line call at the real code site) --------------

def maybe_poison(batch):
    """``nan_batch``: on an armed occurrence, return a copy of ``batch``
    with its first floating-point leaf filled with NaN."""
    if not enabled() or not fire(POISON_BATCH):
        return batch
    import numpy as np

    state = {"done": False}

    def poison(leaf):
        if state["done"]:
            return leaf
        arr = np.asarray(getattr(leaf, "data", leaf))
        if np.issubdtype(arr.dtype, np.floating):
            state["done"] = True
            return np.full_like(arr, np.nan)
        return leaf

    def tree_map(obj):
        if isinstance(obj, dict):
            return {k: tree_map(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(tree_map(v) for v in obj)
        return poison(obj)

    poisoned = tree_map(batch)
    if not state["done"]:  # integer-only batch: poison is a no-op
        return batch
    return poisoned


def check_checkpoint_write() -> None:
    """``ckpt_fail``: raise on an armed checkpoint-write occurrence."""
    if enabled() and fire(CKPT_FAIL):
        raise ChaosInjectedError(
            "chaos: injected checkpoint write failure")


def check_loader() -> None:
    """``loader_raise``: raise on an armed dataloader-batch occurrence."""
    if enabled() and fire(LOADER_RAISE):
        raise ChaosInjectedError("chaos: injected dataloader failure")


def check_serve_slow() -> bool:
    """``serve_slow_step``: True on an armed serving-dispatch occurrence.
    The *action* (sleeping ``serve_chaos_slow_s``) belongs to the
    serving Batcher — this stays pure bookkeeping, like the worker
    points."""
    return enabled() and fire(SERVE_SLOW)


def request_preemption() -> None:
    """Flag a preemption from outside the loop (signal-handler safe: just
    sets a bool). The next :func:`check_preempt` raises."""
    global _preempt_requested
    _preempt_requested = True


def preemption_requested() -> bool:
    return _preempt_requested


def check_worker(rank: int) -> Optional[str]:
    """Worker-level points, evaluated once per health beat of rank
    ``rank``. All three share one beat counter (an entry ``point@N:R``
    reads "on the Nth beat of rank R"; without ``:R`` any rank's Nth
    beat matches). Returns the fired point name — ``WORKER_KILL`` >
    ``WORKER_HANG`` > ``WORKER_UNHEALTHY`` when several arm the same
    beat — or None. The *action* (SIGKILL self / block / write the
    unhealthy marker) is performed by ``core.health``, keeping this
    module pure bookkeeping."""
    if not _armed_worker:
        return None
    with _lock:
        n = _counters.get("worker_beat", 0) + 1
        _counters["worker_beat"] = n
        for point in (WORKER_KILL, WORKER_HANG, WORKER_UNHEALTHY):
            armed = _armed_worker.get(point, ())
            if (n, None) in armed or (n, rank) in armed:
                return point
    return None


def check_replica(rank: int) -> Optional[str]:
    """Serving-replica points, evaluated once per inference request the
    replica worker ``rank`` handles. The three points share one request
    counter (an entry ``point@N:R`` reads "on the Nth request of
    replica R"; without ``:R`` any replica's Nth request matches), and
    priority is ``REPLICA_KILL`` > ``REPLICA_HANG`` > ``REPLICA_SLOW``
    when several arm the same request. The *action* (SIGKILL self /
    stop reading / sleep ``serve_chaos_slow_s``) is performed by
    ``serving.replica`` — this stays pure bookkeeping, like the
    worker points."""
    if not _armed_worker:
        return None
    with _lock:
        n = _counters.get("replica_req", 0) + 1
        _counters["replica_req"] = n
        for point in _REPLICA_POINTS:
            armed = _armed_worker.get(point, ())
            if (n, None) in armed or (n, rank) in armed:
                return point
    return None


def check_gen_step(active_slots) -> Tuple[Optional[int], bool]:
    """Generative-serving points, evaluated ONCE per continuous-batching
    decode step. Both points share one step counter: an entry
    ``gen_slot_wedge@N:S`` reads "on the Nth decode step, wedge slot S"
    (without ``:S`` the lowest active slot is wedged);
    ``gen_slow_step@N`` stalls the Nth dispatch. Returns
    ``(wedged_slot_or_None, slow)``; the *actions* (failing the slot's
    stream typed + releasing it / sleeping ``serve_chaos_slow_s``)
    belong to ``serving.generate`` — this stays pure bookkeeping, like
    every other point."""
    if not _armed_worker:
        return None, False
    active = sorted(int(s) for s in active_slots)
    with _lock:
        n = _counters.get("gen_step", 0) + 1
        _counters["gen_step"] = n
        slow = any(n == occ for occ, _ in
                   _armed_worker.get(GEN_SLOW_STEP, ()))
        wedged = None
        for occ, slot in _armed_worker.get(GEN_SLOT_WEDGE, ()):
            if occ != n:
                continue
            if slot is None:
                wedged = active[0] if active else None
            elif slot in active:
                wedged = slot
            break
    return wedged, slow


def check_gen_replica(rank: int) -> Optional[str]:
    """Generation-fleet replica points, evaluated once per TOKEN FRAME
    the gen replica ``rank`` streams back to its fleet. Kill and hang
    share one frame counter (``gen_replica_kill@N:R`` reads "on the Nth
    token frame of replica R"; without ``:R`` any replica's Nth frame
    matches); priority ``GEN_REPLICA_KILL`` > ``GEN_REPLICA_HANG`` when
    both arm the same frame. The *action* (SIGKILL self mid-stream /
    stop streaming while staying alive) is performed by
    ``serving.genreplica`` — this stays pure bookkeeping."""
    if not _armed_worker:
        return None
    with _lock:
        n = _counters.get("gen_token_frame", 0) + 1
        _counters["gen_token_frame"] = n
        for point in (GEN_REPLICA_KILL, GEN_REPLICA_HANG):
            armed = _armed_worker.get(point, ())
            if (n, None) in armed or (n, rank) in armed:
                return point
    return None


def check_gen_pressure() -> bool:
    """``gen_page_pressure``: True on an armed scheduler-tick occurrence
    (own counter — deliberately NOT the ``check_gen_step`` counter, so
    arming pressure never shifts the wedge/slow-step schedules). The
    *action* (claiming every free KV page and holding it for a few
    ticks to force decode page faults into the preemption path) belongs
    to the generation scheduler — this stays pure bookkeeping."""
    return enabled() and _fire_qualified(GEN_PAGE_PRESSURE, 0)


def check_collective(rank: int) -> bool:
    """``collective_skip``: True on an armed collective-op occurrence
    for trainer ``rank`` (``collective_skip@N:R`` = rank R's Nth
    collective; without ``:R`` any rank's Nth matches). The *action*
    (returning the input untouched, journaling nothing) belongs to the
    ``distributed/collective.py`` wrappers — this stays pure
    bookkeeping. Fires exactly once, so a retried operation replays
    clean."""
    return enabled() and _fire_qualified(COLLECTIVE_SKIP, rank)


def check_ps(rank: int = 0) -> Optional[str]:
    """Parameter-server points, evaluated once per request the
    :class:`~paddle1_tpu.distributed.ps_server.TableServer` handles.
    Kill and hang share one request counter (``ps_kill@N:R`` reads "on
    the Nth request of PS rank R"; without ``:R`` any server's Nth
    request matches); priority ``PS_KILL`` > ``PS_HANG`` when both arm
    the same request. The *action* (apply + checkpoint, then SIGKILL
    self before acking / stalling past the client timeout) is performed
    by ``distributed.ps_server`` — this stays pure bookkeeping."""
    if not _armed_worker:
        return None
    with _lock:
        n = _counters.get("ps_request", 0) + 1
        _counters["ps_request"] = n
        for point in _PS_POINTS:
            armed = _armed_worker.get(point, ())
            if (n, None) in armed or (n, rank) in armed:
                return point
    return None


def check_delta_corrupt() -> bool:
    """``delta_corrupt``: True on an armed delta-publish occurrence
    (own counter). The *action* (bit-flipping the committed payload so
    the subscriber's CRC verify must catch it) belongs to
    ``DeltaLog.publish`` — this stays pure bookkeeping."""
    return enabled() and _fire_qualified(DELTA_CORRUPT, 0)


def check_delta_gap() -> bool:
    """``delta_gap``: True on an armed delta-publish occurrence (own
    counter). The *action* (force-pruning every older delta from under
    a lagging reader, seeding the hole ``DeltaGapDetected`` must catch)
    belongs to ``DeltaLog.publish`` — this stays pure bookkeeping."""
    return enabled() and _fire_qualified(DELTA_GAP, 0)


def _fire_qualified(point: str, qualifier: int) -> bool:
    """Record one occurrence of a qualified (worker/loader) point on its
    own counter; True iff this occurrence is armed for ``qualifier`` (or
    unqualified)."""
    if not _armed_worker:
        return False
    with _lock:
        if point not in _armed_worker:
            return False
        n = _counters.get(point, 0) + 1
        _counters[point] = n
        armed = _armed_worker[point]
        return (n, None) in armed or (n, qualifier) in armed


def check_sample(worker: Optional[int] = None) -> None:
    """``corrupt_sample``: raise :class:`ChaosInjectedError` on an armed
    sample-fetch occurrence (the Nth ``dataset[i]`` / reader item of
    loader worker ``worker``; the single-process path is worker 0). The
    ``loader_bad_sample`` policy then treats it like any real corrupt
    record."""
    if enabled() and _fire_qualified(CORRUPT_SAMPLE,
                                     0 if worker is None else worker):
        raise ChaosInjectedError("chaos: corrupt sample record")


def check_loader_worker_kill(worker: int) -> bool:
    """``loader_worker_kill``: True on an armed task occurrence for
    loader worker ``worker``. The *action* (SIGKILL self) belongs to the
    worker loop — this stays pure bookkeeping."""
    return enabled() and _fire_qualified(LOADER_WORKER_KILL, worker)


def check_loader_stall(worker: int) -> bool:
    """``loader_stall``: True on an armed task/batch occurrence; the
    loader sleeps ``loader_chaos_stall_s`` (the input-stall watchdog's
    reproducible trigger)."""
    return enabled() and _fire_qualified(LOADER_STALL, worker)


def check_preempt() -> None:
    """``preempt``: raise :class:`SimulatedPreemption` on an armed step
    occurrence, or when :func:`request_preemption` was called."""
    global _preempt_requested
    if not enabled():
        return
    if _preempt_requested:
        _preempt_requested = False
        raise SimulatedPreemption("preemption requested", graceful=True)
    if fire(PREEMPT):
        raise SimulatedPreemption("chaos: simulated preemption")
