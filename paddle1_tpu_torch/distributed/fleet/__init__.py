"""``distributed.fleet`` of the port: only ``fleet.utils`` (recompute)
so far; the fleet API itself is a later slice (ROADMAP.md)."""

from . import utils  # noqa: F401
