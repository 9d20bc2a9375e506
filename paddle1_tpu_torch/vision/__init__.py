"""Vision models, detection ops, datasets and transforms of the port
(``paddle1_tpu.vision``)."""

from . import datasets, models, ops, transforms  # noqa: F401

__all__ = ["datasets", "models", "ops", "transforms"]
