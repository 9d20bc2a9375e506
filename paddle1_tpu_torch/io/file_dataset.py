"""Out-of-core file datasets: InMemoryDataset / QueueDataset (port of
``paddle1_tpu/io/file_dataset.py``: host code over files and
subprocesses, unchanged but for the port's errors and launch
environment).

Analog of the reference's industrial data runtime — ``fluid.DatasetFactory``
datasets (the reference's python/paddle/fluid/dataset.py InMemoryDataset /
QueueDataset) over the C++ channel machinery (framework/data_feed.cc
MultiSlotDataFeed pipe ingest, framework/data_set.cc load/global-shuffle,
dist_multi_trainer.cc consuming the channels).

Scoping (the JAX package's):

* Parsing — the reference pipes every file through ``pipe_command`` (an
  external filter) then a MultiSlot text protocol. Both survive here:
  ``set_pipe_command`` runs the same shell filter per file, and the line
  parser is a plain Python ``parse_fn`` (default: whitespace floats).
* Global shuffle — the reference exchanges samples between trainers over
  the PS network. Here the input store is shared (GCS/NFS), so
  every trainer can read EVERY file: a common-seed permutation with
  round-robin ownership gives each trainer a uniform random, disjoint,
  covering shard with zero network traffic. (Disjoint per-host filelists
  would need the PS exchange path — out of scope, documented.)
* Out-of-core — QueueDataset streams: a reader thread parses into a
  bounded queue and the iterator drains it; resident memory is
  O(queue capacity), not O(data).
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core.errors import InvalidArgumentError, PreconditionNotMetError
from .dataset import Dataset, IterableDataset

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset",
           "DatasetFactory"]


def _default_parse(line: str):
    parts = line.split()
    return np.asarray([float(p) for p in parts], np.float32) \
        if parts else None


def _iter_file_lines(path: str, pipe_command: Optional[str]):
    """Lines of one file, optionally through the reference's per-file
    shell filter (data_feed.cc fp_ = popen(pipe_command))."""
    if pipe_command:
        with open(path, "rb") as f:
            proc = subprocess.Popen(pipe_command, shell=True, stdin=f,
                                    stdout=subprocess.PIPE)
            try:
                for raw in proc.stdout:
                    yield raw.decode("utf-8", "replace").rstrip("\n")
            finally:
                proc.stdout.close()
                if proc.wait() != 0:
                    raise PreconditionNotMetError(
                        f"pipe_command {pipe_command!r} failed on {path}")
    else:
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")


class DatasetBase:
    """Configuration surface shared by the file datasets (reference
    fluid/dataset.py DatasetBase: set_filelist/set_batch_size/set_thread/
    set_pipe_command/set_use_var)."""

    def __init__(self):
        self._filelist: List[str] = []
        self._batch_size = 1
        self._thread = 1
        self._pipe_command: Optional[str] = None
        self._parse_fn: Callable = _default_parse
        self._use_vars = []
        self._rank = None
        self._world = None

    def set_filelist(self, filelist: Sequence[str]) -> None:
        self._filelist = list(filelist)

    def set_batch_size(self, batch_size: int) -> None:
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num: int) -> None:
        self._thread = max(1, int(thread_num))

    def set_pipe_command(self, pipe_command: str) -> None:
        self._pipe_command = pipe_command

    def set_parse_fn(self, fn: Callable) -> None:
        """line:str → sample (np array / tuple / None to drop). The
        Python-native replacement for the MultiSlot text protocol."""
        self._parse_fn = fn

    def set_use_var(self, var_list) -> None:
        self._use_vars = list(var_list)  # parity; names ride metadata

    def set_rank_world(self, rank: int, world: int) -> None:
        """Pin the trainer coordinates (otherwise read from the launch
        env, PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM)."""
        self._rank, self._world = int(rank), int(world)

    def _coords(self):
        if self._rank is not None:
            return self._rank, self._world
        from ..distributed import env
        return env.get_rank(), env.get_world_size()

    def _my_files(self) -> List[str]:
        """File-level sharding (reference: trainers split the filelist)."""
        rank, world = self._coords()
        return self._filelist[rank::world]

    def _parse_file(self, path: str):
        for line in _iter_file_lines(path, self._pipe_command):
            s = self._parse_fn(line)
            if s is not None:
                yield s


class InMemoryDataset(DatasetBase, Dataset):
    """Load-then-shuffle dataset (reference fluid.InMemoryDataset:
    load_into_memory / local_shuffle / global_shuffle / release_memory /
    get_memory_data_size / get_shuffle_data_size)."""

    def __init__(self):
        super().__init__()
        self._samples: List = []
        self._global_shuffled = False

    # -- ingest -------------------------------------------------------------

    def load_into_memory(self) -> None:
        self._samples = [s for p in self._my_files()
                         for s in self._parse_file(p)]
        self._global_shuffled = False

    def release_memory(self) -> None:
        self._samples = []

    # -- shuffles -------------------------------------------------------------

    def local_shuffle(self, seed: Optional[int] = None) -> None:
        rng = np.random.default_rng(seed)
        rng.shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num: int = 12,
                       seed: int = 0) -> None:
        """Shared-filesystem global shuffle: every trainer re-reads the
        FULL filelist, applies the common-seed permutation, and keeps the
        positions it owns round-robin — a uniform random disjoint cover
        of the whole corpus (reference data_set.cc GlobalShuffle's
        result, without the PS sample exchange)."""
        rank, world = self._coords()
        # two streaming passes keep resident memory at O(N/world) samples
        # (plus O(N) permutation indices): pass 1 counts, pass 2 keeps
        # only owned samples — a trainer owns shuffled position p when
        # p % world == rank, and sample j lands at position inv_perm[j]
        total = sum(1 for p in self._filelist for _ in self._parse_file(p))
        perm = np.random.default_rng(seed).permutation(total)
        inv = np.empty(total, np.int64)
        inv[perm] = np.arange(total)
        mine = {}
        j = 0
        for p in self._filelist:
            for s in self._parse_file(p):
                pos = int(inv[j])
                if pos % world == rank:
                    mine[pos] = s
                j += 1
        self._samples = [mine[pos] for pos in sorted(mine)]
        self._global_shuffled = True

    # -- introspection --------------------------------------------------------

    def get_memory_data_size(self, fleet=None) -> int:
        local = len(self._samples)
        return local  # single-controller view; fleet sums over workers

    def get_shuffle_data_size(self, fleet=None) -> int:
        return len(self._samples) if self._global_shuffled else 0

    # -- Dataset protocol (feeds io.DataLoader) -------------------------------

    def __getitem__(self, idx):
        return self._samples[idx]

    def __len__(self):
        return len(self._samples)


class QueueDataset(DatasetBase, IterableDataset):
    """Streaming dataset (reference fluid.QueueDataset): samples flow
    from files through a bounded queue to the consumer; nothing is ever
    fully resident. One reader thread per iterator (the reference's
    thread pool maps onto the DataLoader's worker processes here)."""

    _SENTINEL = object()

    def __init__(self, capacity: int = 1024):
        super().__init__()
        self.capacity = int(capacity)

    def __iter__(self):
        import queue as _q
        q: "_q.Queue" = _q.Queue(maxsize=self.capacity)
        files = self._my_files()
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that notices consumer abandonment (early break
            # closing the generator) instead of blocking forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _q.Full:
                    continue
            return False

        def reader():
            try:
                for p in files:
                    for s in self._parse_file(p):
                        if not put(s):
                            return  # consumer gone: close files/pipes
            except BaseException as e:  # noqa: broad-except —
                # propagated into the consumer via err[]
                err.append(e)
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        try:
            while True:
                s = q.get()
                if s is self._SENTINEL:
                    break
                yield s
        finally:
            stop.set()   # unblocks the reader on GeneratorExit too
            t.join()
        if err:
            raise err[0]


class DatasetFactory:
    """Reference fluid.DatasetFactory: create_dataset(name)."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise InvalidArgumentError(
            f"unknown dataset class {datafeed_class!r} (reference "
            f"DatasetFactory raises the same)")
