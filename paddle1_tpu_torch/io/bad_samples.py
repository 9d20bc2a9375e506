"""Shared corrupt-sample policy for every input-pipeline front end (port
of ``paddle1_tpu/io/bad_samples.py``, host code, unchanged).

One helper for every consumer — the single-process DataLoader producer
and the multi-process worker loop here (the JAX package's legacy
``fluid`` PyReader is not ported yet) — so
the ``loader_bad_sample`` policy (``raise`` / ``skip`` / ``quarantine``)
behaves identically everywhere instead of being copy-pasted per path.

A "bad sample" is one failed *sample-level* operation: a map-style
``dataset[i]`` raising, an iterable item that won't collate/convert, or
an armed ``corrupt_sample`` chaos occurrence (which models a corrupt
record by raising). Policy semantics:

``raise``      — propagate (today's behavior, the default): one corrupt
                 record fails the epoch loudly.
``skip``       — drop the sample and count it (``bad_sample_count``).
``quarantine`` — drop + count + append an ``{index, error, worker}``
                 record to the in-memory quarantine log (and to the
                 ``loader_quarantine_file`` JSONL sink when set), so a
                 million-user-scale job can both keep training and
                 account for exactly which records it refused.

Interrupts are never policy material: ``KeyboardInterrupt`` /
``SystemExit`` / ``SimulatedPreemption`` propagate through every
policy — a preemption notice must unwind to its handler, not be
"quarantined" as a bad sample.
"""

from __future__ import annotations

import json
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

POLICIES = ("raise", "skip", "quarantine")


def resolve_policy(policy: Optional[str] = None) -> str:
    """Explicit policy, or the ``loader_bad_sample`` flag; validated."""
    if policy is None:
        from ..core import flags as core_flags
        policy = core_flags.flag("loader_bad_sample")
    if policy not in POLICIES:
        from ..core.errors import InvalidArgumentError
        raise InvalidArgumentError(
            f"bad-sample policy must be one of {POLICIES}, got {policy!r}")
    return policy


def bad_sample_record(index, exc: BaseException,
                      worker: Optional[int] = None) -> Dict[str, Any]:
    """One quarantine-log entry: picklable (crosses the mp result queue)
    and JSON-serializable (rides the quarantine file and test asserts).
    Integer-like indices (numpy scalars from a custom sampler included)
    are narrowed to ``int``; anything else degrades to ``repr`` — the
    quarantine machinery must never be the thing that kills the epoch."""
    try:
        index = int(index)
    except (TypeError, ValueError):
        index = repr(index)
    return {"index": index, "error": repr(exc), "worker": worker}


def fetch_samples(dataset, indices: Sequence[int], policy: str,
                  worker: Optional[int] = None,
                  pool=None) -> Tuple[List[Any], List[Dict[str, Any]]]:
    """Fetch ``dataset[i]`` for each index under the bad-sample policy.

    Returns ``(samples, skipped)`` where ``skipped`` is a list of
    quarantine records for the dropped indices (empty under ``raise``,
    which propagates the first failure instead). ``pool`` is an
    optional ThreadPoolExecutor for parallel decode (the single-process
    loader's worker threads). Chaos ``corrupt_sample`` occurrences are
    counted here — one per sample fetch — so the injection point sits
    exactly where a real corrupt record would surface.
    """
    from ..core import chaos

    def one(i):
        if chaos.enabled():
            chaos.check_sample(0 if worker is None else worker)
        return dataset[i]

    if policy == "raise":
        if pool is not None:
            return list(pool.map(one, indices)), []
        return [one(i) for i in indices], []

    def guarded(i):
        try:
            return i, one(i), None
        except Exception as e:  # interrupts (BaseException) propagate
            return i, None, e

    results = list(pool.map(guarded, indices)) if pool is not None \
        else [guarded(i) for i in indices]
    samples, skipped = [], []
    for i, s, e in results:
        if e is None:
            samples.append(s)
        else:
            skipped.append(bad_sample_record(i, e, worker=worker))
    return samples, skipped


class BadSampleLog:
    """Per-loader accounting sink for dropped samples.

    ``count`` covers both ``skip`` and ``quarantine``; ``records`` (and
    the optional JSONL file) are populated under ``quarantine`` only —
    skip is the "keep going, just tell me how many" dial, quarantine is
    the "and show me exactly which" one.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.records: List[Dict[str, Any]] = []
        self._file_warned = False

    def absorb(self, skipped: Sequence[Dict[str, Any]], policy: str,
               quarantine_file: str = "") -> None:
        if not skipped:
            return
        from ..obs import events as obs_events
        from ..obs import registry as obs_registry
        m = obs_registry.process_registry()
        m.counter("loader_bad_samples_total").inc(len(skipped))
        with self._lock:
            self.count += len(skipped)
            if policy != "quarantine":
                return
            m.counter("loader_quarantined_total").inc(len(skipped))
            obs_events.emit("quarantine", count=len(skipped),
                            indices=[r.get("index") for r in skipped])
            self.records.extend(skipped)
            if not quarantine_file:
                return
            try:
                with open(quarantine_file, "a") as f:
                    for rec in skipped:
                        f.write(json.dumps(rec, default=repr) + "\n")
            except (OSError, TypeError, ValueError) as e:
                if not self._file_warned:  # once: the in-memory log and
                    # the training run must survive a broken log path
                    # (or an unserializable record)
                    self._file_warned = True
                    warnings.warn(
                        f"quarantine file {quarantine_file!r} not "
                        f"writable ({e}); keeping the in-memory log only")
