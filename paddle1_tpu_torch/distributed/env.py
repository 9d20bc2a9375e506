"""Distributed environment state (port of
``paddle1_tpu/distributed/env.py``).

Tracks (a) the process-level rank and world size from the launcher's
environment protocol (``PADDLE_TRAINER_ID`` / ``RANK``,
``PADDLE_TRAINERS_NUM`` / ``WORLD_SIZE``), and (b) the thread-bound
parallel binding. The JAX package binds a logical group name to a mesh
AXIS for the duration of a trace (``spmd_axes(dp="data")``); here one
process runs per rank, so a logical name binds to the process GROUP of
its ranks (a ``collective.Group``). ``ParallelEngine`` binds ``dp``
around its forward; the batch-norm functional and ``SyncBatchNorm`` read
it (``current_spmd_axis("dp")``) and then normalize a training batch with
the statistics of the whole group's batch.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Optional

__all__ = ["get_rank", "get_world_size", "get_local_rank", "spmd_axes",
           "current_spmd_axis"]

_tls = threading.local()


def get_rank() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID",
                              os.environ.get("RANK", "0")))


def get_world_size() -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM",
                              os.environ.get("WORLD_SIZE", "1")))


def get_local_rank() -> int:
    """This rank's index on its host (``PADDLE_RANK_IN_NODE`` /
    ``LOCAL_RANK``, else the global rank): the card it drives."""
    return int(os.environ.get("PADDLE_RANK_IN_NODE",
                              os.environ.get("LOCAL_RANK",
                                             str(get_rank()))))


@contextlib.contextmanager
def spmd_axes(**mapping: Any):
    """Bind logical parallel groups for the enclosed code on this thread,
    e.g. ``with spmd_axes(dp=group): ...`` (``group`` a
    ``collective.Group``)."""
    prev = getattr(_tls, "axes", None)
    merged = dict(prev or {})
    merged.update(mapping)
    _tls.axes = merged
    try:
        yield
    finally:
        _tls.axes = prev


def current_spmd_axis(logical: str) -> Optional[Any]:
    """The group bound to ``logical`` on this thread, or None."""
    axes = getattr(_tls, "axes", None)
    if axes is None:
        return None
    return axes.get(logical)
