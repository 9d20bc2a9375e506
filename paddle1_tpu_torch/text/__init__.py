"""Text models of the port (``paddle1_tpu.text`` subset)."""

from . import models  # noqa: F401
