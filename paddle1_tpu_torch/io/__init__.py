"""paddle1_tpu_torch.io — datasets and the DataLoader (port of
``paddle1_tpu/io``, the reference's ``paddle.io``). Every name of the JAX
package's ``io`` is here; batches end on the caller's place (the card by
default), staged through pinned memory on a copy stream."""

from .bad_samples import BadSampleLog
from .dataloader import (DataLoader, DataLoaderStalled,  # noqa: F401
                         WorkerInfo, default_collate_fn)
from .dataset import (BatchSampler, ChainDataset, ComposeDataset, Dataset,
                      DistributedBatchSampler, IterableDataset,
                      RandomSampler, Sampler, SequenceSampler, Subset,
                      TensorDataset, WeightedRandomSampler, random_split)
from .file_dataset import (DatasetFactory, InMemoryDataset, QueueDataset)


def get_worker_info():
    """Inside a DataLoader worker: (id, num_workers, dataset); None in
    the main process (reference io/dataloader/worker.py:77)."""
    from .dataloader import _worker_info
    return _worker_info()
