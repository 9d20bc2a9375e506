"""Bucket policy shared by the serving engines (port of
``resolve_buckets`` from ``paddle1_tpu/serving/engine.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

from ..core import flags as core_flags
from ..core.errors import InvalidArgumentError

__all__ = ["resolve_buckets"]


def resolve_buckets(buckets=None, max_batch: Optional[int] = None,
                    spec_flag: str = "serve_buckets") -> Tuple[int, ...]:
    """Normalize the bucket list: explicit sequence > the ``spec_flag``
    flag > powers of two up to ``max_batch`` (the ``serve_max_batch``
    flag when None). Always sorted and deduped; an explicit ``max_batch``
    is always covered. The generation engine reuses the same policy for
    PROMPT-LENGTH buckets by passing ``spec_flag=
    "serve_gen_prefill_buckets"`` and the prompt capacity as
    ``max_batch`` (a different axis, so it never reads the batch-size
    flag)."""
    explicit_max = max_batch is not None
    if max_batch is None:
        max_batch = int(core_flags.flag("serve_max_batch"))
    if buckets is None:
        spec = core_flags.flag(spec_flag)
        if spec:
            try:
                buckets = [int(b) for b in str(spec).split(",")
                           if b.strip()]
            except ValueError:
                raise InvalidArgumentError(
                    f"{spec_flag} must be comma-separated ints, got "
                    f"{spec!r}") from None
    if buckets is None:
        buckets, b = [], 1
        while b < max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(max_batch)
    out = sorted({int(b) for b in buckets})
    if not out or out[0] < 1:
        raise InvalidArgumentError(f"buckets must be >= 1, got {out}")
    if explicit_max and out[-1] < max_batch:
        out.append(int(max_batch))  # the requested ceiling must dispatch
    return tuple(out)
