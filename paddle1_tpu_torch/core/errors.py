"""Typed error hierarchy + enforce macros.

A copy of ``paddle1_tpu/core/errors.py`` (the analog of Paddle's
PADDLE_ENFORCE machinery, ``platform/enforce.h`` and ``platform/errors.h``),
kept in the port so that it never imports the JAX package. The typed
hierarchy is preserved so user code can catch specific categories.
"""

from __future__ import annotations

__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "PermissionDeniedError",
    "ResourceExhaustedError", "PreconditionNotMetError", "UnimplementedError",
    "UnavailableError", "FatalError", "ExecutionTimeoutError",
    "DeviceUnavailableError", "KernelBuildError", "KernelLaunchError",
    "enforce", "enforce_eq", "enforce_gt", "enforce_not_none",
]


class EnforceNotMet(RuntimeError):
    """Base for all framework-raised errors (reference enforce.h:EnforceNotMet)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class FatalError(EnforceNotMet):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


class DeviceUnavailableError(UnavailableError):
    """The caller asked for (or defaulted to) a CUDA device that this
    process cannot see. The port never runs on the CPU unless the caller
    passes ``device="cpu"`` explicitly."""


class KernelBuildError(UnavailableError):
    """``nvcc`` failed to build a kernel from the repo's sources (or is
    missing); the message carries the compiler's stderr."""


class KernelLaunchError(UnavailableError):
    """A hand-written CUDA kernel's launcher returned a CUDA error (a
    refused launch, or an error left by an earlier asynchronous fault)."""


def enforce(cond, msg="", error_cls=PreconditionNotMetError):
    if not cond:
        raise error_cls(msg if msg else "Enforce condition failed")


def enforce_eq(a, b, msg="", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(f"{msg} (expected {a!r} == {b!r})")


def enforce_gt(a, b, msg="", error_cls=InvalidArgumentError):
    if not a > b:
        raise error_cls(f"{msg} (expected {a!r} > {b!r})")


def enforce_not_none(x, msg="", error_cls=NotFoundError):
    if x is None:
        raise error_cls(msg if msg else "Expected a non-None value")
    return x
