"""Training engine of the port (``paddle1_tpu.distributed`` subset: the
single-device ``ParallelEngine``)."""

from .parallel_engine import ParallelEngine  # noqa: F401
