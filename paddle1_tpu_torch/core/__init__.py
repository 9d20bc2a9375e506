"""Core runtime of the port: typed errors, the flag registry and device
resolution."""

from . import device, errors, flags  # noqa: F401
from .device import resolve_device  # noqa: F401
