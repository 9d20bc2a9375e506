"""Device resolution (the port's counterpart of ``core/place.py``).

Every entry point of the port runs on CUDA unless the caller passes
``device="cpu"`` explicitly, as the CPU parity tests do. A missing card
is a typed error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import torch

from .errors import DeviceUnavailableError, InvalidArgumentError

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` (or a CPU ``torch.device``) → CPU;
    any CUDA spelling → that CUDA device. Raises
    :class:`DeviceUnavailableError` when CUDA is asked for (or defaulted
    to) and this process sees no card."""
    try:
        dev = torch.device("cuda" if device is None else device)
    except RuntimeError as e:
        raise InvalidArgumentError(
            f"device must be 'cuda' or 'cpu', got {device!r}") from e
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise InvalidArgumentError(
            f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False — pass device='cpu' to run on the CPU explicitly")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
