"""The port's op namespace (``paddle1_tpu.ops`` subset: the shape ops of
``manip_ops``) and its hand-written CUDA kernels, each beside its plain
PyTorch version. Importing this package builds and loads nothing: a
kernel is compiled (``ops/cuda/build.py``) the first time a CUDA tensor
reaches it."""

from .manip_ops import concat, flatten, split, stack, transpose  # noqa: F401
