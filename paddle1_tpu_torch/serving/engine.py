"""Bucket policy shared by the serving engines (port of
``resolve_buckets`` from ``paddle1_tpu/serving/engine.py``)."""

from __future__ import annotations

from typing import Tuple

from ..core import flags as core_flags
from ..core.errors import InvalidArgumentError

__all__ = ["resolve_buckets"]


def resolve_buckets(buckets, max_batch: int,
                    spec_flag: str = "serve_gen_prefill_buckets"
                    ) -> Tuple[int, ...]:
    """Normalize a bucket list: explicit sequence > the ``spec_flag``
    flag > powers of two up to ``max_batch``. Always sorted, deduped and
    covering ``max_batch``. The generation engine passes the prompt
    capacity as ``max_batch``: the buckets are prompt lengths."""
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
    if out[-1] < max_batch:
        out.append(int(max_batch))  # the requested ceiling must dispatch
    return tuple(out)
