"""The data-parallel mesh (port of ``build_mesh`` from
``paddle1_tpu/distributed/topology.py``).

The JAX package's mesh is an array of devices with named axes, driven by
one process. Here each rank is a process, so a mesh is a descriptor: the
degree of each axis and the group of ranks that the data-parallel axis
spans. Only ``dp`` is ported; the model-parallel, pipeline, sharding and
sequence axes are slice 4b (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

from ..core.errors import InvalidArgumentError
from . import collective

__all__ = ["Mesh", "build_mesh"]


class Mesh:
    """``shape``: the degree of each axis (``{"pp": 1, "dp": n, ...}``, as
    the JAX mesh's ``shape``); ``group``: the ``collective.Group`` of the
    ``dp`` axis, the default group (ranks ``0..n-1``)."""

    def __init__(self, shape: Dict[str, int], group: collective.Group):
        self.shape = dict(shape)
        self.group = group

    def __repr__(self):
        return f"Mesh({self.shape}, {self.group})"


def build_mesh(dp: int = 1, mp: int = 1, pp: int = 1, sharding: int = 1,
               sp: int = 1) -> Mesh:
    """A data-parallel mesh over the default process group: ``dp`` must
    equal the world size (the group from ``init_parallel_env``; without
    one, the launcher's world size, which must then be 1). Any other
    degree above 1 raises: model, pipeline, sharding and sequence
    parallelism are not ported yet."""
    others = {"mp": mp, "pp": pp, "sharding": sharding, "sp": sp}
    bad = {k: v for k, v in others.items() if v != 1}
    if bad:
        raise InvalidArgumentError(
            f"build_mesh: degrees {bad} are not ported yet — model, "
            "pipeline, sharding (ZeRO) and sequence parallelism are slice "
            "4b of the port (ROADMAP.md); only dp is available")
    group = collective.get_group(0)
    if dp != group.nranks:
        raise InvalidArgumentError(
            f"build_mesh: dp={dp} needs {dp} ranks, the world has "
            f"{group.nranks} (init_parallel_env sets it from the "
            "launcher's PADDLE_TRAINERS_NUM / WORLD_SIZE)")
    return Mesh({"pp": 1, "dp": dp, "sharding": 1, "mp": 1, "sp": 1}, group)
