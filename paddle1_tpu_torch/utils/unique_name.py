"""Layer names (Paddle's ``paddle.utils.unique_name``).

Every ``nn.Layer`` takes ``f"{prefix}_{n}"`` from a per-prefix counter,
and its parameters are named after it, so a model's parameter names
depend on the layers built before it in the process. :func:`guard` opens
a fresh namespace: layers built inside number from zero again, as in a
new process, so a model rebuilt there carries the names an optimizer's
``state_dict`` was saved under.
"""

from __future__ import annotations

import contextlib

from ..nn import layer_base

__all__ = ["guard"]


@contextlib.contextmanager
def guard():
    """Within the block every counter starts at zero; the counters of the
    outer namespace come back after it."""
    counts = layer_base._global_layer_name_counts
    saved = dict(counts)
    counts.clear()
    try:
        yield
    finally:
        counts.clear()
        counts.update(saved)
