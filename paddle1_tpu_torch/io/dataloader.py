"""DataLoader with background prefetch to the card (port of
``paddle1_tpu/io/dataloader.py``).

Analog of the reference's ``python/paddle/fluid/reader.py:149`` DataLoader
+ dataloader/dataloader_iter.py (single/multi-process iters) + the C++
BufferedReader (operators/reader/buffered_reader.h:36: background thread
pre-copies batches to device through pinned memory).

Design, as in the JAX package: with ``num_workers=0`` (or without the
shared-memory arena) a producer thread loads, collates and stages the
next ``prefetch_factor`` batches while step N computes, fanning sample
loads over a thread pool of ``num_workers`` threads; with
``num_workers > 0`` and ``use_shared_memory`` real worker PROCESSES
collate batches into one shared-memory arena each (``core/native``) and
the parent copies them out.

What the card changes:

* **The place.** An iterator takes the caller's place (``get_device()``
  in the thread that calls ``iter``) and sets it in its producer thread;
  batches end on that place: the card by default, the CPU when the caller
  is on the CPU. Host work runs with the CPU as the current place: the
  collation in the producer thread, the sample loads in the thread pool
  and everything in a worker process, which sets the CPU first thing, so
  a worker never calls CUDA (``to_tensor`` in a transform or a
  ``collate_fn`` makes a CPU tensor there). ``default_collate_fn`` called
  by a user outside a loader still returns tensors on the current place.
* **Staging** (the JAX package's ``jax.device_put``): a collated host
  batch goes to pinned memory and is copied with ``non_blocking=True`` on
  one copy stream the iterator owns; the copy records an event that
  travels with the batch. When the consumer takes the batch, its current
  stream waits on the event and each tensor is marked used there
  (``record_stream``), so the caching allocator does not reuse its memory
  while the step still reads it. The multi-process iterator copies each
  array out of the arena straight into a pinned tensor (one copy) and
  stages it the same way the moment it pulls the result, so that
  recovery can replace an arena without losing salvaged data. On the
  CPU there is no pinning and no stream.

Resilience layer (the paper's L2 readers are a runtime component, so the
input pipeline gets the same treatment as the train step and launcher):

* **Checkpointable state** — ``state_dict()/set_state_dict()`` capture
  (epoch, cursor, sampler shuffle state | iterable-dataset state) so a
  resumed run restores its position in O(1) instead of replaying the
  stream; the state is the JAX package's (version 1), so a state written
  by one package restores the other's loader.
* **Worker crash recovery** — a dead worker process (OOM-kill, segfault)
  is detected by the exitcode sweep inside the queue-wait loop,
  re-spawned with a fresh arena up to ``loader_max_worker_restarts``
  times, and its in-flight task indices re-dispatched — instead of the
  legacy sticky ``RuntimeError``.
* **Corrupt-sample policy** — ``loader_bad_sample`` = ``raise`` (default)
  / ``skip`` / ``quarantine`` via the shared :mod:`.bad_samples` helper;
  counters and the quarantine log live on the loader.
* **Input-stall watchdog** — no batch within ``loader_stall_timeout_s``
  dumps worker liveness + the pending task map, then restarts the
  stalled worker or raises :class:`DataLoaderStalled`; the wait loop
  calls ``health.beat()`` so a slow loader is not mistaken for a hung
  trainer by a supervisor.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..core import place as core_place
from ..core.errors import InvalidArgumentError
from ..core.tensor import Tensor, _wrap, to_tensor
from .bad_samples import (BadSampleLog, bad_sample_record, fetch_samples,
                          resolve_policy)
from .dataset import BatchSampler, Dataset, IterableDataset

__all__ = ["DataLoader", "DataLoaderStalled", "default_collate_fn"]

# polling slice for stall/death sweeps: long enough to stay cheap, short
# enough that worker death is noticed promptly
_SWEEP_SLICE_S = 0.2
# an iterable dataset that keeps raising without advancing would spin the
# skip policy forever; bound the consecutive failures
_MAX_BAD_STREAK = 1024
# arena names must be unique across iterator lifetimes (id() values can
# be recycled by the allocator while an old arena is still linked)
_ARENA_SEQ = itertools.count()


class DataLoaderStalled(RuntimeError):
    """The input-stall watchdog gave up: no batch arrived within
    ``loader_stall_timeout_s`` and the stalled worker could not be (or
    could no longer be) restarted. Carries the worker-liveness and
    pending-task dump in its message."""


def default_collate_fn(batch: List[Any]):
    """Stack samples into batch tensors on the current place (reference
    dataloader/collate.py default_collate_fn). Inside a loader the current
    place is the CPU."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return to_tensor(torch.stack([s.detach().as_subclass(torch.Tensor)
                                      for s in batch]))
    if isinstance(sample, np.ndarray):
        return to_tensor(np.stack(batch))
    if isinstance(sample, (int, float)):
        return to_tensor(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return type(sample)(default_collate_fn(list(col))
                            for col in zip(*batch))
    return batch


def _on_the_host():
    """Make the CPU this thread's current place (the thread pool's
    initializer; a worker process's first act)."""
    core_place._tls.place = core_place.CPUPlace()


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor leaf of its dicts, lists
    and tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


class _Stager:
    """The H2D stage of BufferedReader: collated host batches onto the
    iterator's place.

    On a card: each CPU tensor is pinned (``pin_memory``, one copy) and
    copied with ``non_blocking=True`` on this stager's copy stream, and
    one event recorded after a batch's copies travels with it;
    :meth:`receive` makes the consumer's current stream wait on that
    event and marks each tensor used on that stream (``record_stream``),
    so the caching allocator does not hand its memory out again while the
    step still reads it. On the CPU a batch passes through as it is."""

    def __init__(self, place):
        self.device = place.torch_device()
        self.cuda = self.device.type == "cuda"
        self.stream = (torch.cuda.Stream(device=self.device) if self.cuda
                       else None)

    def host_tensor(self, src: torch.Tensor) -> torch.Tensor:
        """An empty host tensor for ``src``'s shape and dtype: pinned when
        the batch goes on to a card."""
        return torch.empty(src.shape, dtype=src.dtype, pin_memory=self.cuda)

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        plain = t.detach().as_subclass(torch.Tensor)
        if plain.device.type == "cpu" and not plain.is_pinned():
            plain = torch.Tensor.pin_memory(plain)
        out = torch.Tensor.to(plain, self.device, non_blocking=True)
        return _wrap(out) if isinstance(t, Tensor) else out

    def stage(self, batch):
        """``(batch on the place, event or None)``."""
        if not self.cuda:
            return batch, None
        with torch.cuda.stream(self.stream):
            out = _map_tensors(batch, self._copy)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def receive(self, batch, event):
        """The batch, safe to use on the consumer's current stream."""
        if event is None:
            return batch
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)

        def mark(t):
            torch.Tensor.record_stream(t, current)
            return t
        _map_tensors(batch, mark)
        return batch


class _SingleProcessIter:
    def __init__(self, loader: "DataLoader"):
        self._loader = loader
        self._policy = loader.bad_sample_policy
        # the caller's place: where batches end (raises here, typed, for
        # a card this process does not see)
        self._place = core_place.get_device()
        self._stager = _Stager(self._place)
        skip = loader._begin_epoch()
        self._skip = skip
        self._batch_iter = None
        self._dataset_iter = None
        if loader.batch_sampler is not None:
            self._batch_iter = iter(loader.batch_sampler)
            for _ in range(skip):  # restored cursor: index-batches only —
                try:               # no sample is loaded, collated or staged
                    next(self._batch_iter)
                except StopIteration:
                    break
        elif isinstance(loader.dataset, IterableDataset):
            # (after _begin_epoch: a restored dataset state must be
            # applied before the epoch's iterator is built)
            self._dataset_iter = iter(loader.dataset)
            if hasattr(loader.dataset, "state_dict"):
                # snapshot BEFORE the producer starts prefetching: the
                # loader's reported state must track the CONSUMED
                # position (per-batch snapshots ride the queue), never
                # the producer's run-ahead
                loader._last_iterable_state = loader.dataset.state_dict()
        nw = max(loader.num_workers, 0)
        self._pool = (ThreadPoolExecutor(nw, initializer=_on_the_host)
                      if nw > 0 else None)
        self._prefetch_q: "queue.Queue" = queue.Queue(
            maxsize=loader.prefetch_factor)
        self._done = object()
        self._finished = False
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _load_batch(self, indices):
        with core_place.device_guard("cpu"):
            samples, skipped = fetch_samples(self._loader.dataset, indices,
                                             self._policy, worker=None,
                                             pool=self._pool)
            if skipped:
                self._loader._absorb_bad_samples(skipped)
            if not samples:
                return None  # every sample quarantined: drop the batch
            return self._loader.collate_fn(samples)

    def _put(self, item) -> bool:
        """Stop-aware put: a consumer that broke out of its loop (queue
        full, nobody draining) must not strand the producer thread in a
        blocking put forever — shutdown() flips _stop and this returns."""
        while not self._stop.is_set():
            try:
                self._prefetch_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _maybe_chaos_stall(self):
        from ..core import chaos
        from ..core import flags as core_flags
        if chaos.check_loader_stall(0):
            time.sleep(float(core_flags.flag("loader_chaos_stall_s")))

    def _next_iterable_samples(self, bs, state):
        """Draw up to ``bs`` samples from the iterable dataset under the
        bad-sample policy. Returns (samples, epoch_ended)."""
        samples = []
        while len(samples) < bs and not self._stop.is_set():
            try:
                s = next(self._dataset_iter)
            except StopIteration:
                return samples, True
            except Exception as e:
                # the stream yielded a corrupt record in place of a sample
                state["ordinal"] += 1
                self._bad_iterable_sample(state, e)
                continue
            state["ordinal"] += 1
            from ..core import chaos
            if chaos.enabled():
                try:
                    chaos.check_sample(0)
                except Exception as e:
                    self._bad_iterable_sample(state, e)
                    continue
            state["streak"] = 0
            samples.append(s)
        return samples, False

    def _bad_iterable_sample(self, state, e):
        if self._policy == "raise":
            raise e
        self._loader._absorb_bad_samples(
            [bad_sample_record(state["ordinal"] - 1, e, worker=None)])
        state["streak"] += 1
        if state["streak"] > _MAX_BAD_STREAK:
            raise RuntimeError(
                f"iterable dataset produced {state['streak']} consecutive "
                f"bad samples — refusing to spin under loader_bad_sample="
                f"{self._policy!r} (the stream is not advancing)")

    def _producer(self):
        from ..core import chaos
        k = self._skip  # index-batches handled so far this epoch
        try:
            core_place.set_device(self._place)
            if self._dataset_iter is not None:
                ds = self._loader.dataset
                snapshot = getattr(ds, "state_dict", None)
                bs = self._loader.batch_size or 1
                state = {"ordinal": 0, "streak": 0}
                while not self._stop.is_set():
                    with core_place.device_guard("cpu"):
                        samples, ended = self._next_iterable_samples(
                            bs, state)
                    if not samples:
                        break
                    if len(samples) < bs and self._loader.drop_last:
                        break
                    if chaos.enabled():
                        chaos.check_loader()
                        self._maybe_chaos_stall()
                    with core_place.device_guard("cpu"):
                        batch = self._loader.collate_fn(samples)
                    batch, event = self._stager.stage(batch)
                    # per-batch state snapshot: when the CONSUMER pops
                    # this batch, the loader's reported dataset state
                    # becomes "position right after it" — prefetched-
                    # but-unconsumed batches are regenerated on resume,
                    # not dropped
                    snap = snapshot() if snapshot is not None else None
                    k += 1
                    if not self._put((batch, k, snap, event)):
                        return
                    if ended:
                        break
            else:
                for indices in self._batch_iter:
                    if self._stop.is_set():
                        break
                    if chaos.enabled():
                        chaos.check_loader()
                        self._maybe_chaos_stall()
                    batch = self._load_batch(indices)
                    k += 1
                    if batch is None:
                        # every sample quarantined: nothing to yield,
                        # but the cursor advance must still reach the
                        # consumer — a checkpoint taken after the NEXT
                        # batch would otherwise lag one index-batch and
                        # a resume would re-fetch (and double-log) this
                        # one
                        if not self._put((None, k, None, None)):
                            return
                        continue
                    batch, event = self._stager.stage(batch)
                    if not self._put((batch, k, None, event)):
                        return
        except BaseException as e:  # stored in _err and re-raised on the
            # consumer's next() — a producer-thread error must cross the
            # queue, not die silently with the thread (the lint's
            # error-forwarding allowlist covers this file)
            if isinstance(e, (StopIteration, StopAsyncIteration)):
                # PEP 479 semantics: a StopIteration leaking out of
                # dataset code would read as a clean (early!) epoch end
                # in __next__ — surface it as the error it is
                e = RuntimeError(
                    "DataLoader worker raised StopIteration "
                    "(dataset raised it past the epoch boundary)")
            self._err = e
        finally:
            if not self._put(self._done):   # normal epoch end
                try:                        # stopping: consumer is gone,
                    self._prefetch_q.put_nowait(self._done)  # best effort
                except queue.Full:
                    pass

    def _get_with_watchdog(self):
        """Pop the next prefetched item; with ``loader_stall_timeout_s``
        set, poll in slices (beating the supervisor heartbeat) and raise
        a typed :class:`DataLoaderStalled` when the producer goes quiet
        past the timeout."""
        timeout = self._loader.stall_timeout_s
        if not timeout:
            return self._prefetch_q.get()
        from ..core import health
        waited = 0.0
        while True:
            try:
                return self._prefetch_q.get(timeout=_SWEEP_SLICE_S)
            except queue.Empty:
                health.beat()  # a slow loader is not a hung trainer
                waited += _SWEEP_SLICE_S
                if waited >= timeout:
                    self._loader.stall_events += 1
                    from ..obs import events as obs_events
                    from ..obs import registry as obs_registry
                    obs_registry.process_registry().counter(
                        "loader_stalls_total").inc()
                    obs_events.emit("loader_stall", waited=round(waited, 2))
                    alive = self._thread.is_alive()
                    err = DataLoaderStalled(
                        f"no batch in {waited:.1f}s "
                        f"(loader_stall_timeout_s={timeout}); producer "
                        f"thread alive={alive}, cursor="
                        f"{self._loader._cursor} — the producer cannot "
                        "be restarted in-process; check the dataset/"
                        "storage backend")
                    self._err = err
                    self._finished = True
                    self.shutdown()
                    raise err

    def __next__(self):
        while True:
            if self._finished:
                # the _done sentinel is single-shot: without this, a
                # second next() after exhaustion blocks forever on the
                # empty queue. A worker error stays sticky — every
                # subsequent next() re-raises it instead of reporting a
                # clean epoch end.
                if self._err is not None:
                    raise self._err
                raise StopIteration
            item = self._get_with_watchdog()
            if item is self._done:
                self._finished = True
                if self._err is not None:
                    raise self._err
                self._loader._note_epoch_end()
                raise StopIteration
            batch, cursor, snap, event = item
            self._loader._cursor = cursor
            if snap is not None:
                self._loader._last_iterable_state = snap
            if batch is None:
                continue  # all-quarantined index-batch: position
                # advanced, nothing to yield
            batch = self._stager.receive(batch, event)
            self._loader._note_batch_yielded()
            if not self._loader.return_list and isinstance(batch, tuple):
                return list(batch)
            return batch

    def peek_many(self, k: int):
        """Pop up to ``k`` pre-staged (already device-resident) batches
        for the multi-step training path (``ParallelEngine.step_many``):
        blocks until ``k`` are available, returning fewer only at epoch
        end. Raises StopIteration when the epoch is already over."""
        out = []
        for _ in range(max(int(k), 1)):
            try:
                out.append(next(self))
            except StopIteration:
                break
        if not out:
            raise StopIteration
        return out

    def __iter__(self):
        return self

    def shutdown(self):
        stop = getattr(self, "_stop", None)
        if stop is None:  # __init__ died before the thread existed
            return
        stop.set()
        try:
            while True:
                self._prefetch_q.get_nowait()
        except queue.Empty:
            pass
        t = getattr(self, "_thread", None)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # interpreter teardown: never raise in __del__
            pass


class WorkerInfo:
    """Visible through io.get_worker_info() inside a worker (reference
    dataloader/worker.py WorkerInfo: id, num_workers, dataset)."""

    def __init__(self, wid, num_workers, dataset):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset


_current_worker_info = None


def _worker_info():
    return _current_worker_info


def _mp_worker_loop(dataset, task_q, result_q, arena_name, collate_fn,
                    worker_id, worker_init_fn, consumed_val,
                    num_workers=1, bad_sample_policy="raise",
                    chaos_spec="", incarnation=0):
    """Worker process body (reference dataloader/worker.py:171
    _worker_loop). Batches go to the parent as shm-arena descriptors —
    zero-copy apart from the final parent-side read. Results are stamped
    with this worker's ``incarnation`` so the parent can discard debris
    from a replaced (crashed/stalled) predecessor."""
    import os
    import pickle
    import signal as _signal
    import time as _time

    import numpy as np

    import torch

    from ..core import chaos
    from ..core import flags as core_flags
    from ..core.native import ShmArena

    # the CPU is this process's place before any user code runs: a worker
    # never touches CUDA (a forked child of a process that set CUDA up may
    # not), so a to_tensor in a transform or collate_fn lands on the host;
    # one intra-op thread a worker, as torch's own loader sets (the
    # workers are the parallelism)
    _on_the_host()
    torch.set_num_threads(1)
    # chaos occurrence counters are process-local: arm THIS process from
    # the parent's forwarded spec — incarnation 0 only, so a re-spawned
    # worker replays clean (the same fire-once contract as the
    # supervisor's worker points). A forked child must not keep the
    # parent's armed points/counters either way.
    if chaos_spec and incarnation == 0:
        chaos.configure(chaos_spec)
    else:
        chaos.reset()
    chaos_stall_s = float(core_flags.flag("loader_chaos_stall_s"))
    global _current_worker_info
    _current_worker_info = WorkerInfo(worker_id, num_workers, dataset)
    arena = ShmArena(arena_name, create=False)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    produced = 0

    def to_arr(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().as_subclass(torch.Tensor).numpy()
        return np.asarray(leaf)

    import multiprocessing as _mp
    import queue as _pyqueue

    def next_task():
        """Orphan-checked task get (the fleet-worker pattern): a
        parent killed with SIGKILL skips every cleanup path, and a
        worker blocked forever in ``get()`` outlives it as an orphan —
        holding its inherited pipes (and any shell waiting on them)
        open. Poll in slices and exit when the parent is gone."""
        while True:
            try:
                return task_q.get(timeout=2.0)
            except _pyqueue.Empty:
                parent = _mp.parent_process()
                if parent is not None and not parent.is_alive():
                    return None

    try:
        while True:
            task = next_task()
            if task is None:
                break
            seq, indices = task
            if chaos.enabled():
                if chaos.check_loader_worker_kill(worker_id):
                    # an ungraceful worker death (the OOM killer): no
                    # cleanup, no error record — SIGKILL self
                    os.kill(os.getpid(), _signal.SIGKILL)
                if chaos.check_loader_stall(worker_id):
                    _time.sleep(chaos_stall_s)
            samples, skipped = fetch_samples(dataset, indices,
                                             bad_sample_policy,
                                             worker=worker_id)
            if not samples:
                # every sample in the batch quarantined: the parent
                # still needs the seq slot (ordering) + the accounting
                result_q.put((seq, incarnation, pickle.dumps(
                    {"empty": True, "skipped": skipped})))
                produced += 1
                continue
            batch = collate_fn(samples)
            if isinstance(batch, dict):
                keys = list(batch.keys())
                leaves = [to_arr(batch[k]) for k in keys]
            elif isinstance(batch, (tuple, list)):
                keys = None
                leaves = [to_arr(b) for b in batch]
            else:
                keys = None
                leaves = [to_arr(batch)]
            if any(l.dtype == object for l in leaves):
                # non-numeric payloads can't ride shared memory; pickle the
                # whole batch through the result pipe instead
                result_q.put((seq, incarnation, pickle.dumps(
                    {"pickled": batch, "keys": None, "skipped": skipped})))
                produced += 1
                continue
            # Arena recycling with backpressure: when the arena is 3/4
            # full, WAIT until the parent has drained everything produced
            # so far, then reset the bump pointer. Reset only BETWEEN
            # batches (a mid-batch reset could let later leaves overwrite
            # earlier ones). Progress is guaranteed: the parent keeps
            # consuming queued results while we wait.
            if arena.used() > 3 * arena.size // 4:
                while consumed_val.value < produced:
                    _time.sleep(0.001)
                arena.reset()
            descs = [arena.put_array(arr) for arr in leaves]
            result_q.put((seq, incarnation, pickle.dumps(
                {"descs": descs, "keys": keys, "skipped": skipped})))
            produced += 1
    except KeyboardInterrupt:  # noqa: broad-except — worker process:
        pass                   # ctrl-C belongs to the parent, die quietly
    except BaseException as e:  # forwarded to the parent through the
        # result queue (seq -1 = fatal worker error record) and
        # re-raised there — the lint's error-forwarding allowlist
        # covers this file
        result_q.put((-1, incarnation, pickle.dumps(repr(e))))
    finally:
        arena.close()


class _MultiProcessIter:
    """num_workers>0 path: real worker PROCESSES over a shared-memory arena
    (reference dataloader_iter.py:251 _DataLoaderIterMultiProcess +
    mmap_allocator.cc). One arena per worker, epoch-reset recycling.

    Recovery model: tasks keep fixed worker affinity (``seq % nw``) so
    batch order survives restarts; ``_pending`` tracks every dispatched-
    but-unreceived task, and a dead/stalled worker slot is re-spawned
    with a fresh arena + bumped incarnation, its pending tasks re-sent
    in order. Results are decoded (copied out of the arena) the moment
    they are pulled from the result queue, so a later arena replacement
    can never invalidate data already salvaged.

    Queue topology: one task queue AND one result queue PER WORKER, both
    replaced on re-spawn. This is load-bearing for recovery, not style —
    a SIGKILLed worker (the OOM killer, or the kill chaos point) can die
    while its queue feeder thread holds the shared queue's write lock,
    permanently wedging every OTHER worker's puts (observed: one kill →
    whole-pipeline stall → restart budget burned on innocent workers).
    With per-worker queues the orphaned lock wedges only the dead
    worker's own queue, which the parent drains of complete messages
    (reads never need the write lock) and then abandons."""

    def __init__(self, loader: "DataLoader"):
        import multiprocessing as mp
        import os
        import pickle
        self._pickle = pickle
        self._loader = loader
        self._policy = loader.bad_sample_policy
        self._max_restarts = loader.max_worker_restarts
        # the caller's place: where batches end
        self._place = core_place.get_device()
        self._stager = _Stager(self._place)
        from ..core import chaos
        # Arm loader-level chaos in this loader's FIRST worker fleet
        # only. In-process counters make armed occurrences fire once per
        # process; worker processes get fresh counters, so without this
        # gate every re-iteration (a trainer rollback, the next epoch)
        # would replay the same faults — and replays must come back
        # clean (the fire-once contract).
        if loader._mp_chaos_forwarded:
            self._chaos_spec = ""
        else:
            self._chaos_spec = chaos.active_spec()
            loader._mp_chaos_forwarded = bool(self._chaos_spec)
        # fork is the fast default (and what the reference/torch use). A
        # forked child of a process that set CUDA up must never call CUDA
        # (it would fail to re-initialize it), and a lock some other
        # thread of the parent held at the fork stays held in the child:
        # the workers run host code only, with the CPU as their place
        # (_mp_worker_loop), which is what makes fork safe here —
        # PADDLE1_MP_START=spawn opts into the safe-but-slower start
        # method (dataset must pickle).
        self._ctx = mp.get_context(os.environ.get("PADDLE1_MP_START",
                                                  "fork"))
        nw = loader.num_workers
        self._nw = nw
        self._arena_mb = int(os.environ.get("FLAGS_dataloader_shm_mb",
                                            "256"))
        skip = loader._begin_epoch()
        self._base_cursor = skip
        self._batch_iter = iter(loader.batch_sampler)
        for _ in range(skip):  # restored cursor: indices only, no loads
            try:
                next(self._batch_iter)
            except StopIteration:
                break
        self._task_qs: list = [None] * nw
        self._result_qs: list = [None] * nw
        self._workers: list = [None] * nw
        self._arenas: list = [None] * nw
        self._arena_names: list = [None] * nw
        self._consumed: list = [None] * nw
        self._gen = [0] * nw          # incarnation per worker slot
        self._restarts = [0] * nw
        for w in range(nw):
            self._spawn(w)
        self._send_seq = 0
        self._recv_seq = 0
        self._pending = {}  # seq -> indices (dispatched, not yet received)
        self._buf = {}      # seq -> (decoded batch | None, skip records)
        self._exhausted = False
        self._finished = False  # epoch-end latch: single-shot, like the
        self._err = None        # single-process iterator's
        # prime the pipeline
        for _ in range(loader.prefetch_factor * nw):
            self._dispatch()

    def _spawn(self, w: int):
        import os
        from ..core.native import ShmArena
        name = f"/p1t_{os.getpid()}_{next(_ARENA_SEQ)}_{w}"
        arena = ShmArena(name, size=self._arena_mb << 20)
        consumed = self._ctx.Value("l", 0)
        loader = self._loader
        # fresh queues per incarnation: a crashed predecessor may have
        # orphaned either lock (its feeder thread mid-put, or a get
        # interrupted by SIGKILL) — see the class docstring
        self._task_qs[w] = self._ctx.Queue()
        self._result_qs[w] = self._ctx.Queue()
        p = self._ctx.Process(
            target=_mp_worker_loop,
            args=(loader.dataset, self._task_qs[w], self._result_qs[w],
                  name, loader.collate_fn, w, loader.worker_init_fn,
                  consumed, self._nw, self._policy, self._chaos_spec,
                  self._gen[w]),
            daemon=True)
        p.start()
        self._workers[w] = p
        self._arenas[w] = arena
        self._arena_names[w] = name
        self._consumed[w] = consumed

    def _dispatch(self):
        if self._exhausted:
            return
        try:
            indices = next(self._batch_iter)
        except StopIteration:
            self._exhausted = True
            return
        w = self._send_seq % self._nw
        self._pending[self._send_seq] = list(indices)
        self._task_qs[w].put((self._send_seq, indices))
        self._send_seq += 1

    def __next__(self):
        if self._err is not None:
            raise self._err
        if self._finished:
            # single-shot epoch end: a second next() must not re-run
            # _note_epoch_end (it would inflate loader._epoch and
            # corrupt the checkpointable state)
            raise StopIteration
        while True:
            if self._recv_seq in self._buf:
                batch, skipped = self._buf.pop(self._recv_seq)
                self._recv_seq += 1
                self._loader._cursor = self._base_cursor + self._recv_seq
                if skipped:
                    self._loader._absorb_bad_samples(skipped)
                self._dispatch()
                if batch is None:
                    continue  # every sample quarantined: nothing to yield
                batch = self._stager.receive(*batch)
                self._loader._note_batch_yielded()
                if not self._loader.return_list and isinstance(batch,
                                                               tuple):
                    return list(batch)
                return batch
            if self._recv_seq >= self._send_seq and self._exhausted:
                self._finished = True
                self._loader._note_epoch_end()
                self.shutdown()
                raise StopIteration
            self._pump()

    def _drain_ready(self) -> bool:
        """Pull every complete message currently readable across the
        per-worker result queues (waiting up to one sweep slice for the
        first). True iff anything was ingested."""
        from multiprocessing.connection import wait as conn_wait
        import queue as pyqueue
        readers = {}
        for w in range(self._nw):
            q = self._result_qs[w]
            if q is not None:
                readers[q._reader] = w
        got = False
        ready = conn_wait(list(readers), timeout=_SWEEP_SLICE_S)
        for r in ready:
            w = readers[r]
            if not self._workers[w].is_alive():
                # a DEAD worker's pipe may end in a truncated message —
                # recv would block forever (the parent holds the write
                # end open, so no EOF). The exitcode sweep routes this
                # slot through _recover, whose salvage is bounded.
                continue
            try:
                seq, gen, payload = self._result_qs[w].get_nowait()
            except (pyqueue.Empty, EOFError, OSError):
                continue  # raced the feeder; a live writer finishes
                # its in-flight message, so this resolves next sweep
            self._ingest(seq, gen, payload)
            got = True
        return got

    def _pump(self):
        """Block (in sweep slices) until the next in-order batch is
        buffered, detecting dead workers and input stalls while waiting."""
        from ..core import health
        timeout = self._loader.stall_timeout_s
        waited = 0.0
        while self._recv_seq not in self._buf:
            if self._drain_ready():
                waited = 0.0
                continue
            health.beat()  # a slow loader is not a hung trainer
            dead = [w for w in range(self._nw)
                    if not self._workers[w].is_alive()]
            if dead:
                # a worker killed by signal/OOM never posts an error
                # record — the exitcode sweep is the only witness
                self._recover(dead, "died")
                waited = 0.0
                continue
            waited += _SWEEP_SLICE_S
            if timeout and waited >= timeout:
                self._on_stall(waited)
                waited = 0.0

    def _ingest(self, seq, gen, payload):
        """Decode one result-queue record into the reorder buffer.
        Decoding copies the arrays out of the worker's arena immediately,
        so recovery can replace the arena without losing salvaged data."""
        if seq == -1:
            self._fatal(RuntimeError(
                f"DataLoader worker failed: "
                f"{self._pickle.loads(payload)}"))
        w = seq % self._nw
        if gen != self._gen[w]:
            return  # debris from a replaced incarnation
        rec = self._pickle.loads(payload)
        skipped = rec.get("skipped") or []
        if rec.get("empty"):
            batch = None
        else:
            if "pickled" in rec:
                batch = rec["pickled"]
            else:
                # each array straight from the arena into a (pinned, on
                # the card's path) host tensor: one copy
                arrays = [self._host_copy(self._arenas[w].view_array(d))
                          for d in rec["descs"]]
                if rec["keys"] is not None:
                    batch = dict(zip(rec["keys"], arrays))
                else:
                    batch = arrays[0] if len(arrays) == 1 else tuple(arrays)
            batch = self._stager.stage(batch)
        with self._consumed[w].get_lock():
            self._consumed[w].value += 1
        self._buf[seq] = (batch, skipped)
        self._pending.pop(seq, None)

    def _host_copy(self, view: np.ndarray) -> Tensor:
        src = torch.from_numpy(view)
        dst = self._stager.host_tensor(src)
        dst.copy_(src)
        return _wrap(dst)

    def _fatal(self, err):
        """Sticky failure: shut the pipeline down and raise ``err`` from
        this and every subsequent next()."""
        self._err = err
        self.shutdown()
        raise err

    def _liveness_dump(self) -> str:
        lines = []
        for w, p in enumerate(self._workers):
            lines.append(
                f"worker {w}: pid={getattr(p, 'pid', None)} "
                f"alive={p.is_alive() if p is not None else False} "
                f"exitcode={getattr(p, 'exitcode', None)} "
                f"incarnation={self._gen[w]} restarts={self._restarts[w]}")
        pending = {s: self._pending[s] for s in sorted(self._pending)}
        return ("; ".join(lines) +
                f"; next batch seq={self._recv_seq}"
                f"; pending tasks={pending}")

    def _on_stall(self, waited: float):
        """Watchdog trip: dump liveness + pending map, then restart the
        worker owing the next batch (budget permitting) or fail typed."""
        self._loader.stall_events += 1
        from ..obs import events as obs_events
        from ..obs import registry as obs_registry
        obs_registry.process_registry().counter(
            "loader_stalls_total").inc()
        obs_events.emit("loader_stall", waited=round(waited, 2))
        dump = self._liveness_dump()
        w = self._recv_seq % self._nw
        warnings.warn(
            f"DataLoader input stall: no batch for {waited:.1f}s "
            f"(loader_stall_timeout_s={self._loader.stall_timeout_s}); "
            f"{dump}")
        if self._restarts[w] >= self._max_restarts:
            self._fatal(DataLoaderStalled(
                f"DataLoader stalled waiting for batch {self._recv_seq} "
                f"from worker {w} and the restart budget "
                f"(loader_max_worker_restarts={self._max_restarts}) is "
                f"exhausted; {dump}"))
        p = self._workers[w]
        if p.is_alive():
            p.kill()  # SIGKILL: a wedged worker won't honor SIGTERM
        self._recover([w], "stalled")

    @staticmethod
    def _salvage(q, budget_s: float = 2.0):
        """Every complete message still readable from a dead worker's
        queue — BOUNDED. ``Queue.get``'s timeout covers only the poll:
        once committed to a message, ``recv`` blocks until it is whole,
        and a worker SIGKILLed mid-write leaves a truncated tail with
        no EOF (the parent holds the write end). Reading in a daemon
        thread with a deadline converts that into one leaked (parked)
        thread in the pathological case instead of hanging recovery."""
        import queue as pyqueue
        out: list = []

        def reader():
            try:
                while True:
                    out.append(q.get(timeout=0.05))
            except (pyqueue.Empty, EOFError, OSError):
                pass

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        t.join(timeout=budget_s)
        if t.is_alive():
            try:  # abandon the queue under the blocked reader
                q._reader.close()
            except Exception:
                pass
            t.join(timeout=0.2)
        return list(out)  # snapshot: the reader may still append

    def _recover(self, slots, reason: str):
        """Re-spawn dead/stalled worker slots and re-dispatch their
        in-flight tasks. Salvages every complete already-posted result
        from the slot's own queue first (reads never contend with the
        dead feeder's orphaned write lock, and the old arena is still
        mapped), so nothing fully produced is lost."""
        import queue as pyqueue
        for w in slots:
            p = self._workers[w]
            p.join(timeout=2)
            exitcode = p.exitcode
            self._restarts[w] += 1
            if self._restarts[w] > self._max_restarts:
                self._fatal(RuntimeError(
                    f"DataLoader worker for batch {self._recv_seq} "
                    f"{reason} (exitcode {exitcode}) and the restart "
                    f"budget (loader_max_worker_restarts="
                    f"{self._max_restarts}) is exhausted; "
                    f"{self._liveness_dump()}"))
            old_result, old_task = self._result_qs[w], self._task_qs[w]
            for rec in self._salvage(old_result):
                self._ingest(*rec)
            try:  # the old arena may hold a half-written batch
                self._arenas[w].close(unlink=True)
            except Exception:
                pass
            self._gen[w] += 1  # new incarnation: chaos stays disarmed,
            self._spawn(w)     # stale results are discarded by gen
            for q in (old_result, old_task):
                try:  # both locks may be orphaned — never join/flush
                    q.cancel_join_thread()
                    q.close()
                except Exception:
                    pass
            redo = sorted(s for s in self._pending if s % self._nw == w)
            for s in redo:
                self._task_qs[w].put((s, self._pending[s]))
            self._loader.worker_restart_count += 1
            from ..obs import events as obs_events
            from ..obs import registry as obs_registry
            obs_registry.process_registry().counter(
                "loader_worker_restarts_total").inc()
            obs_events.emit("loader_worker_restart", worker=int(w),
                            reason=reason, exitcode=exitcode)
            warnings.warn(
                f"DataLoader worker {w} {reason} (exitcode {exitcode}); "
                f"re-spawned (restart {self._restarts[w]}/"
                f"{self._max_restarts}) and re-dispatched {len(redo)} "
                f"in-flight task(s)")

    peek_many = _SingleProcessIter.peek_many

    def __iter__(self):
        return self

    def shutdown(self):
        for q in getattr(self, "_task_qs", []):
            if q is None:
                continue
            try:
                q.put(None)
            except Exception:
                pass
        for p in getattr(self, "_workers", []):
            if p is None:
                continue
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
        for a in getattr(self, "_arenas", []):
            if a is None:
                continue
            try:
                a.close(unlink=True)
            except Exception:
                pass
        for q in (getattr(self, "_task_qs", []) +
                  getattr(self, "_result_qs", [])):
            if q is None:
                continue
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:
                pass
        self._workers = []
        self._arenas = []
        self._task_qs = []
        self._result_qs = []

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class DataLoader:
    """paddle.io.DataLoader equivalent.

    Supported arguments mirror the reference (reader.py:149) in the JAX
    package's positions: dataset, feed_list/places are accepted-and-
    ignored (no Program graphs; batches go to the place of the thread
    that starts an epoch), batch_sampler XOR (batch_size, shuffle,
    drop_last), num_workers, collate_fn; ``prefetch_factor`` batches are
    staged ahead (one without ``use_buffer_reader``).

    Resilience knobs (flags unless overridden per loader):
    ``bad_sample_policy`` (``loader_bad_sample``), ``max_worker_restarts``
    (``loader_max_worker_restarts``), ``stall_timeout_s``
    (``loader_stall_timeout_s``). Counters: ``bad_sample_count``,
    ``quarantine`` (records under the quarantine policy),
    ``worker_restart_count``, ``stall_events``, ``batches_consumed``.

    Checkpointable-state protocol: ``state_dict()`` captures (epoch,
    cursor, sampler shuffle state | iterable-dataset state);
    ``set_state_dict(state)`` applies it to the NEXT iterator, which
    resumes by skipping cursor *index-batches* (no sample is loaded) —
    O(1) in data cost versus the legacy replay fast-forward. One live
    iterator per loader is assumed for state tracking (the training
    loop's usage); concurrent iterators share these counters.
    """

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, bad_sample_policy=None,
                 max_worker_restarts=None, stall_timeout_s=None):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1) if use_buffer_reader \
            else 1
        self.batch_size = batch_size
        self.drop_last = drop_last
        if isinstance(dataset, IterableDataset):
            self.batch_sampler = None
            if batch_sampler is not None:
                raise InvalidArgumentError(
                    "batch_sampler not supported for IterableDataset")
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            if batch_size is None:
                raise InvalidArgumentError("batch_size required")
            self.batch_sampler = BatchSampler(dataset=dataset,
                                              shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        if bad_sample_policy is not None:
            resolve_policy(bad_sample_policy)  # validate eagerly
        self._bad_sample_policy = bad_sample_policy
        self._max_worker_restarts = max_worker_restarts
        self._stall_timeout_s = stall_timeout_s
        self._bad_log = BadSampleLog()
        self._mp_chaos_forwarded = False  # first worker fleet arms chaos
        self.worker_restart_count = 0
        self.stall_events = 0
        self.batches_consumed = 0  # yielded to the consumer, all epochs
        self._epoch = 0            # epochs fully completed
        self._cursor = 0           # index-batches handled this epoch
        # True between epochs (and before the first): a state snapshot
        # here must NOT pin the finished epoch's shuffle seed onto the
        # next epoch — restore lets the sampler draw fresh instead
        self._epoch_boundary = True
        # IterableDataset position as of the last CONSUMED batch (the
        # producer prefetches ahead; live dataset.state_dict() would
        # overcount and a resume would drop the in-queue batches)
        self._last_iterable_state = None
        self._pending_state = None

    # -- resilience knobs (constructor override, else flag) -------------

    @property
    def bad_sample_policy(self) -> str:
        return resolve_policy(self._bad_sample_policy)

    @property
    def max_worker_restarts(self) -> int:
        if self._max_worker_restarts is not None:
            return int(self._max_worker_restarts)
        from ..core import flags as core_flags
        return int(core_flags.flag("loader_max_worker_restarts"))

    @property
    def stall_timeout_s(self) -> float:
        if self._stall_timeout_s is not None:
            return float(self._stall_timeout_s)
        from ..core import flags as core_flags
        return float(core_flags.flag("loader_stall_timeout_s"))

    @property
    def quarantine_file(self) -> str:
        from ..core import flags as core_flags
        return core_flags.flag("loader_quarantine_file")

    @property
    def bad_sample_count(self) -> int:
        return self._bad_log.count

    @property
    def quarantine(self):
        """Quarantine records ({index, error, worker}) accumulated under
        ``bad_sample_policy='quarantine'``."""
        return self._bad_log.records

    def _absorb_bad_samples(self, skipped):
        self._bad_log.absorb(skipped, self.bad_sample_policy,
                             self.quarantine_file)

    # -- checkpointable loader state -------------------------------------

    def checkpointable(self) -> bool:
        """Whether ``state_dict``/``set_state_dict`` can restore this
        loader's position exactly: a map-style dataset whose batch
        sampler speaks the state protocol (all built-in samplers do),
        or an IterableDataset that implements it itself."""
        bs = self.batch_sampler
        if bs is not None:
            ok = hasattr(bs, "state_dict") and hasattr(bs, "set_state_dict")
            chk = getattr(bs, "checkpointable", None)
            if ok and callable(chk):
                ok = bool(chk())
            return ok
        ds = self.dataset
        return hasattr(ds, "state_dict") and hasattr(ds, "set_state_dict")

    def state_dict(self):
        """Position + shuffle state of the current epoch (rides the
        ResilientTrainer checkpoint meta / hapi epoch sidecar)."""
        if not self.checkpointable():
            raise InvalidArgumentError(
                "this DataLoader is not checkpointable (custom sampler/"
                "IterableDataset without state_dict/set_state_dict); "
                "resume falls back to the replay fast-forward")
        st = {"version": 1, "epoch": int(self._epoch),
              "cursor": int(self._cursor)}
        if self.batch_sampler is not None:
            # at an epoch boundary the finished epoch's shuffle seed is
            # HISTORY, not position: restoring it would replay the old
            # order in the next epoch instead of drawing fresh (from
            # the — separately checkpointed — global RNG stream)
            st["sampler"] = None if self._epoch_boundary \
                else self.batch_sampler.state_dict()
        else:
            # consumed-position snapshot when an iterator is live;
            # the dataset's own state otherwise (fresh loader, or
            # between epochs)
            st["dataset"] = self.dataset.state_dict() \
                if self._last_iterable_state is None \
                else self._last_iterable_state
        return st

    def set_state_dict(self, state) -> None:
        """Stage a restored state; the NEXT ``iter()`` resumes from it
        (sampler shuffle state re-applied, ``cursor`` index-batches
        skipped without loading a single sample)."""
        if not isinstance(state, dict):
            raise InvalidArgumentError(
                f"loader state must be a dict, got {type(state).__name__}")
        if int(state.get("version", 1)) != 1:
            raise InvalidArgumentError(
                f"unsupported loader state version {state.get('version')}")
        if not self.checkpointable():
            raise InvalidArgumentError(
                "cannot restore state into a non-checkpointable "
                "DataLoader (custom sampler/IterableDataset without "
                "state_dict/set_state_dict)")
        self._pending_state = dict(state)

    def _begin_epoch(self) -> int:
        """Called by a freshly built iterator: apply any staged restored
        state; returns the number of index-batches to skip."""
        st, self._pending_state = self._pending_state, None
        self._epoch_boundary = False
        if st is None:
            self._cursor = 0
            return 0
        self._epoch = int(st.get("epoch", 0))
        skip = 0
        if self.batch_sampler is not None:
            # sampler state None = the snapshot was taken at an epoch
            # boundary: the next epoch draws its own fresh shuffle seed
            if st.get("sampler") is not None and \
                    hasattr(self.batch_sampler, "set_state_dict"):
                self.batch_sampler.set_state_dict(st.get("sampler"))
            skip = int(st.get("cursor", 0))
        else:
            self.dataset.set_state_dict(st.get("dataset"))
            self._last_iterable_state = st.get("dataset")
        self._cursor = skip
        return skip

    def _note_batch_yielded(self):
        self.batches_consumed += 1

    def _note_epoch_end(self):
        self._epoch += 1
        self._cursor = 0
        self._epoch_boundary = True
        # between epochs the dataset's live state IS the position
        self._last_iterable_state = None

    def __iter__(self):
        # Real worker processes need: workers requested, shared memory
        # allowed, the native arena available, and an indexable dataset.
        if (self.num_workers > 0 and self.use_shared_memory and
                self.batch_sampler is not None):
            from ..core import native
            if native.available():
                return _MultiProcessIter(self)
        return _SingleProcessIter(self)

    def __len__(self):
        if self.batch_sampler is None:
            raise RuntimeError("len() undefined for IterableDataset loader")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()
