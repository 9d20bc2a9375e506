"""Framework utilities (``paddle1_tpu.framework`` subset): ``save`` and
``load``."""

from .io import load, save  # noqa: F401
