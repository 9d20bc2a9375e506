"""Vision models of the port (``paddle1_tpu.vision`` subset)."""

from . import models  # noqa: F401
