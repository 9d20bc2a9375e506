"""Datasets and samplers (port of ``paddle1_tpu/io/dataset.py``).

Analog of the reference's ``python/paddle/fluid/dataloader/`` (dataset.py,
batch_sampler.py, sampler.py): Dataset/IterableDataset/TensorDataset/
ComposeDataset/ChainDataset/Subset/random_split, Sampler family and
BatchSampler/DistributedBatchSampler.

Host code, as in the JAX package. What changes is where randomness comes
from: an epoch's seed (and ``random_split``'s) is one draw below 2**31
from torch's CPU default generator, or from the ``torch.Generator`` given;
the order is then ``np.random.RandomState(seed).permutation(n)`` as in the
JAX package, so both packages give the same order for the same seed and
their sampler states (``{"seed": s}``) are interchangeable.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence

import numpy as np

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler"]


def _draw_seed(generator=None) -> int:
    """One seed in [0, 2**31) from ``generator`` (a ``torch.Generator``),
    else from torch's CPU default generator (what ``paddle.seed`` seeds)."""
    gen = generator if generator is not None else torch.default_generator
    return int(torch.randint(2 ** 31, (1,), generator=gen,
                             device=gen.device))


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of port tensors (or anything indexable along dim 0)."""

    def __init__(self, tensors):
        if not tensors:
            raise InvalidArgumentError("TensorDataset needs >=1 tensor")
        n = tensors[0].shape[0]
        for t in tensors:
            if t.shape[0] != n:
                raise InvalidArgumentError(
                    "All tensors must share dim-0 length")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Zip datasets: sample = concatenation of each dataset's fields."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise InvalidArgumentError("ComposeDataset needs >=1 dataset")
        n = len(self.datasets[0])
        for d in self.datasets:
            if len(d) != n:
                raise InvalidArgumentError("Datasets must be equal length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(sample)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        # fraction support
        if all(0 < l < 1 for l in lengths):
            n = len(dataset)
            lengths = [int(math.floor(n * l)) for l in lengths]
            lengths[-1] += n - sum(lengths)
        else:
            raise InvalidArgumentError(
                "sum(lengths) must equal dataset length")
    perm = np.random.RandomState(_draw_seed(generator)).permutation(
        len(dataset))
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class _EpochSeedMixin:
    """Checkpointable shuffle state shared by the stochastic samplers.

    Each epoch's randomness is one 31-bit seed drawn from torch's CPU
    default generator (or the sampler's ``generator``) *eagerly* when ``__iter__`` is called — so a loader-state
    snapshot taken any time after the epoch's iterator exists captures
    the seed that produced (and can bit-exactly regenerate) the epoch's
    index sequence. ``set_state_dict`` forces that seed onto the NEXT
    ``__iter__`` (consumed once), which is how a resumed process replays
    the interrupted epoch's order instead of drawing a fresh one.
    """

    _last_seed: Optional[int] = None
    _forced_seed: Optional[int] = None

    def _epoch_seed(self, generator=None) -> int:
        if self._forced_seed is not None:
            seed, self._forced_seed = self._forced_seed, None
        else:
            seed = _draw_seed(generator)
        self._last_seed = int(seed)
        return self._last_seed

    def state_dict(self):
        """Shuffle state of the current (last-started) epoch."""
        return {"seed": self._last_seed}

    def set_state_dict(self, state):
        seed = (state or {}).get("seed")
        self._forced_seed = None if seed is None else int(seed)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    # deterministic: checkpointable with no state of its own
    def state_dict(self):
        return {}

    def set_state_dict(self, state):
        pass


class RandomSampler(_EpochSeedMixin, Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        # eager (not a generator): the epoch seed must be drawn — and
        # the index sequence fixed — the moment the iterator is built,
        # or a checkpoint taken before the first batch would miss it
        n = len(self.data_source)
        rng = np.random.RandomState(self._epoch_seed(self.generator))
        if self.replacement:
            idx = rng.randint(0, n, self.num_samples).tolist()
        else:
            idx = rng.permutation(n)[:self.num_samples].tolist()
        return iter(idx)

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(_EpochSeedMixin, Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.RandomState(self._epoch_seed())
        idx = rng.choice(len(self.weights), self.num_samples,
                         replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Groups sampler indices into batches (reference batch_sampler.py)."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if (dataset is None) == (sampler is None):
            raise InvalidArgumentError(
                "Exactly one of dataset / sampler must be given")
        if sampler is not None:
            self.sampler = sampler
        else:
            self.sampler = (RandomSampler(dataset) if shuffle
                            else SequenceSampler(dataset))
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        # iter(self.sampler) EAGERLY: the inner sampler draws its epoch
        # seed here, so checkpointable-loader state capture works before
        # the first batch (see _EpochSeedMixin)
        it = iter(self.sampler)

        def gen():
            batch = []
            for idx in it:
                batch.append(idx)
                if len(batch) == self.batch_size:
                    yield batch
                    batch = []
            if batch and not self.drop_last:
                yield batch
        return gen()

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # -- checkpointable-loader protocol ---------------------------------
    # The cursor (batches already consumed this epoch) is tracked by the
    # DataLoader; the sampler contributes only what regenerates the same
    # index SEQUENCE — its shuffle state. A custom inner sampler without
    # the protocol makes the whole loader non-checkpointable (the
    # DataLoader then falls back to the legacy replay fast-forward).

    def checkpointable(self) -> bool:
        return hasattr(self.sampler, "state_dict") and \
            hasattr(self.sampler, "set_state_dict")

    def state_dict(self):
        return {"sampler": self.sampler.state_dict()}

    def set_state_dict(self, state):
        self.sampler.set_state_dict((state or {}).get("sampler"))


class DistributedBatchSampler(BatchSampler):
    """Per-rank shard of the index space (reference
    distributed/fleet/dataset?  python/paddle/io DistributedBatchSampler):
    pads to equal length so every rank sees the same number of batches —
    required for lockstep data-parallel steps.

    Two shard layouts:

    * **strided** (default, the reference layout): rank ``r`` takes every
      ``nranks``-th index of the whole epoch. Simple, but the set of
      samples a rank has consumed after ``c`` batches is spread over the
      entire epoch — there is NO world-size-invariant notion of "where
      the job is", so loader state written at one world size cannot be
      restored at another (``set_state_dict`` raises the teaching error).
    * **elastic** (``elastic=True``): batch-major — global batch ``j`` is
      the contiguous slice ``order[j*G:(j+1)*G]`` of the epoch order
      (``G = batch_size * nranks``, the *global* batch), and rank ``r``
      takes its contiguous ``batch_size`` chunk of it. The global stream
      is a pure function of (epoch, global batch size): after ``c``
      batches the job has consumed exactly the first ``c*G`` positions
      *for any world size*, so a live resize (8→6 ranks) resumes by
      keeping the cursor and re-slicing — no sample dropped or consumed
      twice. ``rank="all"`` yields the whole global batch in epoch order
      (the single-controller mode: one host process feeding every mesh
      device); per-rank chunks concatenate to exactly that stream.

    An elastic resize must keep the global batch fixed:
    ``new_nranks * new_batch_size == old_nranks * old_batch_size``
    (``set_state_dict`` verifies and teaches otherwise).
    """

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False, elastic=False):
        from ..distributed import env
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.nranks = num_replicas if num_replicas is not None \
            else env.get_world_size()
        self.elastic = bool(elastic)
        if rank == "all":
            if not self.elastic:
                raise InvalidArgumentError(
                    'rank="all" (global-batch mode) requires '
                    "elastic=True: the strided layout has no "
                    "world-invariant global stream to yield")
            self.local_rank = "all"
        else:
            self.local_rank = rank if rank is not None else env.get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        if self.elastic:
            g = self.batch_size * self.nranks
            nb = (len(dataset) // g if drop_last
                  else int(math.ceil(len(dataset) / g)))
            self.num_samples = nb * self.batch_size
            self.total_size = nb * g
        else:
            self.num_samples = int(math.ceil(len(dataset) / self.nranks))
            self.total_size = self.num_samples * self.nranks

    def _epoch_order(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n)
        return indices

    def __iter__(self):
        if self.elastic:
            return self._iter_elastic()
        indices = self._epoch_order()
        n = len(indices)
        # pad to make divisible
        pad = self.total_size - n
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        local = indices[self.local_rank:self.total_size:self.nranks]

        def gen():
            batch = []
            for idx in local.tolist():
                batch.append(idx)
                if len(batch) == self.batch_size:
                    yield batch
                    batch = []
            if batch and not self.drop_last:
                yield batch
        return gen()

    def _iter_elastic(self):
        indices = self._epoch_order()
        g = self.batch_size * self.nranks
        if self.total_size > len(indices):  # wrap-pad the final batch
            indices = np.concatenate(
                [indices, indices[:self.total_size - len(indices)]])
        else:
            indices = indices[:self.total_size]
        for j in range(self.total_size // g):
            chunk = indices[j * g:(j + 1) * g]
            if self.local_rank == "all":
                yield chunk.tolist()
            else:
                r = self.local_rank
                yield chunk[r * self.batch_size:
                            (r + 1) * self.batch_size].tolist()

    def __len__(self):
        if self.elastic:
            return self.total_size // (self.batch_size * self.nranks)
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    # checkpointable: the index sequence is a pure function of
    # (epoch, rank, world) — epoch is the whole shuffle state; the
    # layout fields ride along so a restore at a DIFFERENT world size
    # is either remapped (elastic) or refused with the reason (strided)
    def checkpointable(self) -> bool:
        return True

    def state_dict(self):
        return {"epoch": int(self.epoch), "nranks": int(self.nranks),
                "batch_size": int(self.batch_size),
                "elastic": bool(self.elastic)}

    def set_state_dict(self, state):
        st = state or {}
        old_elastic = st.get("elastic")
        if old_elastic is not None and bool(old_elastic) != self.elastic:
            old_l, new_l = (("batch-major (elastic)", "strided")
                            if old_elastic else
                            ("strided", "batch-major (elastic)"))
            raise InvalidArgumentError(
                f"DistributedBatchSampler state was written by a "
                f"{old_l} sampler but this sampler is {new_l}: the two "
                "layouts order samples differently, so restoring "
                "across them would drop and double-consume samples "
                "even at the same world size — rebuild the sampler "
                f"with elastic={bool(old_elastic)}")
        old_n = st.get("nranks")
        old_b = st.get("batch_size")
        if old_n is not None and old_b is not None:
            old_n, old_b = int(old_n), int(old_b)
            if self.elastic:
                if old_n * old_b != self.nranks * self.batch_size:
                    raise InvalidArgumentError(
                        "elastic resume requires a FIXED global batch: "
                        f"checkpoint was written at {old_n} rank(s) x "
                        f"batch_size {old_b} = global {old_n * old_b}, "
                        f"this sampler is {self.nranks} rank(s) x "
                        f"{self.batch_size} = global "
                        f"{self.nranks * self.batch_size}. Resize by "
                        "scaling batch_size inversely with the world "
                        "size (global_batch // nranks)")
            elif old_n != self.nranks or old_b != self.batch_size:
                raise InvalidArgumentError(
                    "DistributedBatchSampler state was written at "
                    f"{old_n} rank(s) x batch_size {old_b} but this "
                    f"sampler is {self.nranks} x {self.batch_size}: the "
                    "strided per-epoch layout has no world-size-"
                    "invariant cursor, so its state cannot be remapped "
                    "across a resize — construct the sampler with "
                    "elastic=True (batch-major layout) to make loader "
                    "state portable across world sizes")
        self.epoch = int(st.get("epoch", self.epoch))
