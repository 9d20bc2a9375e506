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
Slice 2b(i) is the eager dygraph API of BASELINE config 1 (MNIST LeNet):
the Paddle ``Tensor``/``Parameter`` (a ``torch.Tensor`` subclass),
``to_tensor``, places, seeds, ``autograd`` (``grad``, ``no_grad``,
``PyLayer``), ``save``/``load`` and ``vision.models.LeNet``, with
``nn.functional.softmax`` on the hand-written row-softmax kernel.
Slice 2b(ii) is the Paddle layer API under every ported layer:
``nn.Layer`` (a ``torch.nn.Module``) with ``ParamAttr``, the
initializers (``nn.initializer``) and the regularizers, parameters named
as the JAX package names them, and the optimizer's per-parameter
learning rate, regularizer, clip opt-out and decay filter by name; it
runs BERT-base fine-tuning in eager dygraph. The op namespace
(``ops.math_ops``, ``ops.manip_ops``, ``ops.linalg_ops``) is exported
here as in Paddle (``paddle.matmul``, ``paddle.concat``,
``paddle.linalg.norm``, ...) and installed as the Paddle ``Tensor``'s
methods. ``amp`` is automatic mixed precision (``auto_cast``,
``GradScaler``, ``decorate``), casting at the named Paddle ops. ``io``
is the input pipeline (datasets, samplers and the ``DataLoader`` with
its worker processes, batches staged onto the card through pinned memory
on a copy stream), with ``vision.transforms`` and ``vision.datasets``.
"""

import torch as _torch

from . import (amp, autograd, distributed, framework,  # noqa: F401
               io, nn, optimizer, regularizer, serving, text, utils,
               vision)
from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                       no_grad, set_grad_enabled)
from .core.device import resolve_device  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401
from .distributed import DataParallel  # noqa: F401
from .core.dtype import (bfloat16, bool_, complex64,  # noqa: F401
                         complex128, float16, float32, float64,
                         get_default_dtype, int8, int16, int32, int64,
                         set_default_dtype, uint8)
from .core.generator import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.place import (CPUPlace, CUDAPlace, device_guard,  # noqa: F401
                         get_device, set_device)
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .framework import ParamAttr, load, save  # noqa: F401
from . import ops  # noqa: F401
from .ops import *  # noqa: F401,F403  (the op namespace; patches Tensor)
from .ops import linalg  # noqa: F401

__all__ = ["amp", "autograd", "distributed", "framework", "io", "nn",
           "optimizer",
           "regularizer", "serving", "text", "utils", "vision",
           "resolve_device",
           "to_tensor", "ParamAttr",
           "Tensor", "Parameter", "seed", "get_rng_state", "set_rng_state",
           "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "save", "load", "CPUPlace", "CUDAPlace",
           "set_device", "get_device", "device_guard", "get_default_dtype",
           "set_default_dtype", "float32", "float64", "float16", "bfloat16",
           "int8", "int16", "int32", "int64", "uint8", "bool_", "complex64",
           "complex128", "ops", "rank", "is_empty", "reverse", "tolist",
           "crop_tensor", "DataParallel", "set_flags", "get_flags",
           "in_dynamic_mode", "in_dygraph_mode", "is_compiled_with_cuda",
           "create_parameter", "set_printoptions", "get_cuda_rng_state",
           "set_cuda_rng_state", "promote_types"] + ops.__all__


def rank(input):
    """The tensor's rank as a 0-d int32 tensor."""
    t = input if isinstance(input, Tensor) else to_tensor(input)
    return ops.manip_ops._new(_torch.tensor(t.dim(), dtype=_torch.int32,
                                            device=t.device))


def is_empty(x, name=None):
    """Whether ``x`` has no elements, a 0-d bool tensor."""
    t = x if isinstance(x, _torch.Tensor) else to_tensor(x)
    return ops.manip_ops._new(_torch.tensor(t.nelement() == 0,
                                            device=t.device))


def reverse(x, axis, name=None):
    """``flip`` under its old name."""
    return ops.manip_ops.flip(x, axis if isinstance(axis, (list, tuple))
                              else [axis])


def tolist(x):
    return (x if isinstance(x, _torch.Tensor) else to_tensor(x)).tolist()


def crop_tensor(x, shape=None, offsets=None, name=None):
    """The old name of ``crop`` (None or -1 in ``shape``: to the end)."""
    t = x if isinstance(x, _torch.Tensor) else to_tensor(x)
    if shape is None:
        shape = [-1] * t.dim()
    shape = [-1 if s is None else s for s in shape]
    return ops.manip_ops.crop(t, shape=shape, offsets=offsets)


def in_dynamic_mode() -> bool:
    """The port runs eagerly: always True, as in the JAX package."""
    return True


in_dygraph_mode = in_dynamic_mode


def is_compiled_with_cuda() -> bool:
    """Whether torch was built with CUDA (the reference's question; the
    JAX package, a TPU build, answers False)."""
    return _torch.backends.cuda.is_built()


def get_cuda_rng_state():
    """The generators' states (``get_rng_state``), as the JAX package
    answers for its accelerator."""
    return get_rng_state()


def set_cuda_rng_state(state):
    return set_rng_state(state)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, *,
                     device=None):
    """A free parameter of ``shape``, made as a layer makes its own
    (``nn.Layer.create_parameter``) on the current place."""
    from .framework import ParamAttr as _Attr
    from .nn.layer_base import Layer
    if name is not None and attr is None:
        attr = _Attr(name=name)
    return Layer().create_parameter(shape, attr=attr, dtype=dtype,
                                    is_bias=is_bias,
                                    default_initializer=default_initializer,
                                    device=device)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """How tensors print (torch's print options, which a Tensor's repr
    reads)."""
    kw = {k: v for k, v in dict(precision=precision, threshold=threshold,
                                edgeitems=edgeitems, sci_mode=sci_mode,
                                linewidth=linewidth).items() if v is not None}
    _torch.set_printoptions(**kw)


def promote_types(a, b):
    """The dtype two dtypes (names, numpy or torch dtypes) promote to."""
    from .core.dtype import convert_dtype
    return _torch.promote_types(convert_dtype(a), convert_dtype(b))
