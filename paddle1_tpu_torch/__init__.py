"""paddle1_tpu_torch — the PyTorch/CUDA port of paddle1_tpu.

A second package beside the JAX reference (``paddle1_tpu``), ported
slice by slice. It imports ``torch`` and numpy only — never ``jax`` and
nothing of ``paddle1_tpu`` — and its entry points run on CUDA unless the
caller passes ``device="cpu"``. Hand-written CUDA kernels are built from
``ops/cuda/*.cu`` the first time a CUDA tensor reaches them.

Slice 1 is generative serving: ``serving.GenerationServer`` over
``serving.CausalLM`` with a paged KV cache, on the paged-attention and
LayerNorm kernels. Slice 2 is BERT pretraining:
``distributed.ParallelEngine`` over ``text.models.BertForPretraining`` and
``optimizer.AdamW`` (bf16 with f32 masters), on the flash-attention
forward and backward kernels, the fused AdamW kernel and the LayerNorm
kernel under autograd. Slice 3 is ResNet training and evaluation:
``vision.models.resnet50`` through the same engine with
``optimizer.Momentum``, on the fused batch-norm forward and backward
kernels (training, given statistics) over channels-last activations.
Slice 4a is data-parallel training over ``torch.distributed``
(``distributed.init_parallel_env``, ``spawn``, the collectives,
``DataParallel``, ``nn.SyncBatchNorm``, and ``ParallelEngine`` on
``distributed.build_mesh(dp=n)``), where every training batch norm takes
the global batch's statistics through the local-moments kernel.
"""

from . import distributed, optimizer, serving, text, vision  # noqa: F401
from .core.device import resolve_device  # noqa: F401

__all__ = ["distributed", "optimizer", "serving", "text", "vision",
           "resolve_device"]
