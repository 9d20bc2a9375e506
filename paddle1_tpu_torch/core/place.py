"""Places (port of ``paddle1_tpu/core/place.py``).

``CPUPlace`` and ``CUDAPlace`` (in place of ``TPUPlace``) name a
``torch.device``; ``set_device``/``get_device``/``device_guard`` keep a
thread's current place, where ``to_tensor``, ``Tensor(...)``, the creation
ops and every layer made without a ``device`` put their tensors. The
current place defaults to ``CUDAPlace(0)``: with no card that is a typed
error when a tensor is made there (``core/device.py``), never a quiet move
to the CPU as the reference's ``get_device`` falls back (a departure by
design: the port's entry points run on the card unless the caller asks
for the CPU) — call ``set_device("cpu")`` or pass ``place=CPUPlace()`` to
run on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Union

import torch

from .device import resolve_device
from .errors import InvalidArgumentError

__all__ = ["Place", "CPUPlace", "CUDAPlace", "set_device", "get_device",
           "device_guard", "place_of"]


class Place:
    """Device identity (kind, index)."""

    kind: str = "unknown"

    def __init__(self, index: int = 0):
        self.index = int(index)

    def torch_device(self) -> torch.device:
        """The ``torch.device``; raises DeviceUnavailableError for a CUDA
        place without a card."""
        raise NotImplementedError

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.index == other.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    def __repr__(self):
        return f"Place({self.kind}:{self.index})"


class CPUPlace(Place):
    kind = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """One CUDA card: the reference's CUDAPlace (the JAX package's
    TPUPlace)."""
    kind = "gpu"

    def torch_device(self) -> torch.device:
        return resolve_device(f"cuda:{self.index}")


_tls = threading.local()


def _parse(device: Union[str, Place, torch.device]) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return CPUPlace() if device.type == "cpu" else \
            CUDAPlace(device.index or 0)
    if not isinstance(device, str):
        raise InvalidArgumentError(f"Cannot parse device: {device!r}")
    kind, _, idx = device.lower().partition(":")
    try:
        index = int(idx) if idx else 0
    except ValueError:
        raise InvalidArgumentError(f"Cannot parse device: {device!r}") \
            from None
    if kind == "cpu":
        return CPUPlace(index)
    if kind in ("gpu", "cuda"):
        return CUDAPlace(index)
    raise InvalidArgumentError(
        f"Unknown device kind: {device!r} (this package runs on 'gpu' or "
        "'cpu')")


def set_device(device: Union[str, Place, torch.device]) -> Place:
    """Make ``device`` ('cpu', 'gpu', 'gpu:1', 'cuda:0', a Place or a
    torch.device) this thread's current place; raises
    DeviceUnavailableError for a card this process does not see."""
    place = _parse(device)
    dev = place.torch_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _tls.place = place
    return place


def get_device() -> Place:
    """This thread's current place (``CUDAPlace(0)`` until set)."""
    place = getattr(_tls, "place", None)
    if place is None:
        place = _tls.place = CUDAPlace(0)
    return place


@contextlib.contextmanager
def device_guard(device: Union[str, Place, torch.device]):
    """Scoped device switch."""
    prev = getattr(_tls, "place", None)
    set_device(device)
    try:
        yield
    finally:
        _tls.place = prev


def place_of(t: torch.Tensor) -> Place:
    """The place a tensor lies on."""
    return CPUPlace() if t.device.type == "cpu" else \
        CUDAPlace(t.device.index or 0)
