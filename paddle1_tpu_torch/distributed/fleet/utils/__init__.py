"""``fleet.utils`` of the port: activation recomputation."""

from .recompute import recompute, recompute_sequential  # noqa: F401
