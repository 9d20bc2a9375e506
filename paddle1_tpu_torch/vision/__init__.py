"""Vision models and detection ops of the port (``paddle1_tpu.vision``
subset)."""

from . import models, ops  # noqa: F401
