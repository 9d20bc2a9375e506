"""``ModelParallel`` (port of
``paddle1_tpu/distributed/meta_parallel/model_parallel.py``): the eager
wrapper of a tensor-parallel model. The layers
``text.models.apply_megatron_sharding`` tagged are cut to this rank's
model-parallel shard (``mp_layers.shard_tagged_layers``; the
``meta_parallel`` layers hold theirs already), and gradients are
averaged over the data-parallel ranks as ``DataParallel`` averages
them."""

from __future__ import annotations

from torch import nn

from ..parallel import DataParallel
from .mp_layers import shard_tagged_layers

__all__ = ["ModelParallel"]


class ModelParallel(DataParallel):
    def __init__(self, layers: nn.Module, hcg, strategy=None, **kwargs):
        mp = hcg.get_model_parallel_group()
        if mp.nranks > 1:
            shard_tagged_layers(layers, mp)
        super().__init__(layers, group=hcg.mesh.data_group, **kwargs)
        self._hcg = hcg
