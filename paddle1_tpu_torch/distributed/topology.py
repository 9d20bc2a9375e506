"""The hybrid-parallel topology (port of
``paddle1_tpu/distributed/topology.py``: ``build_mesh``,
``CommunicateTopology``, ``HybridCommunicateGroup``,
``set_``/``get_hybrid_communicate_group``, ``MeshDescriptor``,
``mesh_descriptor``, ``plan_resize``, ``ensure_reshardable`` and
``ReshardError``).

The JAX package's mesh is one array of devices with named axes, driven by
one process, and XLA derives every collective from the axis names. Here
each rank is a process, so a mesh is a descriptor of this rank's place
in the same array: the degree of each axis in the JAX axis order
``("pp", "dp", "sharding", "mp", "sp")`` (outermost first), this rank's
coordinates (rank r sits where device r sits in the JAX mesh's
``reshape(shape)``), and one ``collective.Group`` per axis: the ranks
that differ from this one in that coordinate only. ``Mesh.data_group``
spans the data axes (``dp`` x ``sharding``: the ranks that hold different
rows of a batch and the same model shard); ``Mesh.group`` is that group,
which is the whole world on a data-parallel mesh.

``build_mesh`` is a collective call: every rank of the default process
group makes it with the same degrees, since each group of more than one
rank is a ``torch.distributed`` process group. An axis of degree 1 has no
process group: its collectives are the identity.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.errors import InvalidArgumentError
from . import collective

__all__ = ["Mesh", "CommunicateTopology", "HybridCommunicateGroup",
           "build_mesh", "get_hybrid_communicate_group",
           "set_hybrid_communicate_group", "MeshDescriptor",
           "mesh_descriptor", "plan_resize", "ensure_reshardable",
           "ReshardError"]

# the JAX package's axis order, outermost first (topology.py:39)
_AXIS_ORDER = ("pp", "dp", "sharding", "mp", "sp")


class Mesh:
    """This rank's view of the hybrid mesh: ``shape`` (each axis's degree,
    as the JAX mesh's ``shape``), ``devices`` (the global ranks, an array
    of that shape), ``rank`` (this process's global rank), ``coords``
    (its coordinate on each axis), ``groups`` (its ``collective.Group``
    along each axis) and ``data_group`` (along ``dp`` and ``sharding``
    together)."""

    axis_names = _AXIS_ORDER

    def __init__(self, shape: Dict[str, int], devices: np.ndarray,
                 rank: int, groups: Dict[str, collective.Group],
                 data_group: collective.Group):
        self.shape = {a: int(shape.get(a, 1)) for a in _AXIS_ORDER}
        self.devices = devices
        self.rank = rank
        where = np.argwhere(devices == rank)
        self.coords = {a: (int(where[0][i]) if len(where) else -1)
                       for i, a in enumerate(_AXIS_ORDER)}
        self.groups = dict(groups)
        self.data_group = data_group

    @property
    def group(self) -> collective.Group:
        """The data group (the ``dp`` x ``sharding`` ranks): the whole world
        on a data-parallel mesh."""
        return self.data_group

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def _comm_lists(devices: np.ndarray, axes: Sequence[int]) -> List[List[int]]:
    """The groups of ranks that differ only in the mesh dimensions
    ``axes``: one list a combination of the other dimensions'
    coordinates, in the order the JAX mesh lays them out."""
    others = [i for i in range(devices.ndim) if i not in axes]
    moved = np.transpose(devices, others + list(axes))
    flat = moved.reshape(-1, int(np.prod([devices.shape[i] for i in axes])))
    return [[int(r) for r in row] for row in flat]


def _groups_along(devices: np.ndarray, axes: Sequence[int], me: int,
                  name: str) -> collective.Group:
    """Build every group along ``axes`` (a collective call for each group
    of more than one rank) and return the one that holds ``me``."""
    mine = None
    for ranks in _comm_lists(devices, axes):
        g = collective.new_group(ranks, axis=name)
        if me in ranks:
            mine = g
    if mine is None:      # not a rank of this mesh
        mine = collective.Group(-1, 1, ranks=[], axis=name)
    return mine


def build_mesh(dp: int = 1, mp: int = 1, pp: int = 1, sharding: int = 1,
               sp: int = 1, devices: Optional[Sequence[int]] = None) -> Mesh:
    """The hybrid mesh over ``devices`` (global ranks; default every rank
    of the world, whose size must then be the product of the degrees), in
    the JAX axis order: rank ``devices[i]`` takes device i's place in the
    JAX mesh. Builds one process group per axis slice of more than one
    rank, and the data group. Every rank of the world calls it."""
    degrees = {"pp": pp, "dp": dp, "sharding": sharding, "mp": mp, "sp": sp}
    for k, v in degrees.items():
        if int(v) != v or v < 1:
            raise InvalidArgumentError(
                f"build_mesh: {k}={v!r} must be an int >= 1")
    total = int(np.prod(list(degrees.values())))
    world = collective.get_world_size()
    if devices is None:
        if total != world:
            what = ", ".join(f"{k}={v}" for k, v in degrees.items()
                             if v != 1) or "dp=1"
            raise InvalidArgumentError(
                f"build_mesh: {what} needs {total} ranks, the world has "
                f"{world} (init_parallel_env sets it from the launcher's "
                "PADDLE_TRAINERS_NUM / WORLD_SIZE)")
        devices = list(range(world))
    devices = [int(d) for d in devices]
    if total != len(devices):
        raise InvalidArgumentError(
            f"Mesh degrees {degrees} require {total} devices, "
            f"have {len(devices)}")
    if len(set(devices)) != len(devices) or \
            any(not 0 <= d < world for d in devices):
        raise InvalidArgumentError(
            f"build_mesh: devices {devices} must be distinct ranks of a "
            f"world of {world}")
    shape = tuple(int(degrees[a]) for a in _AXIS_ORDER)
    arr = np.asarray(devices).reshape(shape)
    me = collective.get_rank()
    groups = {a: _groups_along(arr, [i], me, a)
              for i, a in enumerate(_AXIS_ORDER)}
    if dp > 1 and sharding > 1:
        data = _groups_along(arr, [1, 2], me, "data")
    else:
        data = groups["sharding"] if sharding > 1 else groups["dp"]
    return Mesh(degrees, arr, me, groups, data)


class ReshardError(InvalidArgumentError):
    """A checkpoint's mesh cannot be resharded to the requested world
    size/topology (elastic resize). The message teaches the fix — these
    are configuration errors, never data corruption."""


@dataclass
class MeshDescriptor:
    """JSON-serializable identity of a hybrid mesh: the axis degrees in
    canonical order plus the device count (a checkpoint manifest records
    it, so a restore into a different world size can tell that it is a
    resharding restore and check that the resize is expressible). Pure
    host metadata."""

    axes: Dict[str, int] = field(default_factory=dict)
    device_count: int = 1

    def degree(self, axis: str) -> int:
        return int(self.axes.get(axis, 1))

    @property
    def data_degree(self) -> int:
        """Combined degree of the data axes (dp × sharding) — the axes
        an elastic resize is allowed to scale."""
        return self.degree("dp") * self.degree("sharding")

    @property
    def model_degree(self) -> int:
        """Combined degree of the non-resizable axes (mp × pp × sp)."""
        return self.degree("mp") * self.degree("pp") * self.degree("sp")

    def digest(self) -> str:
        blob = json.dumps({"axes": {k: int(v) for k, v in
                                    sorted(self.axes.items())},
                           "devices": int(self.device_count)},
                          sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def as_meta(self) -> Dict[str, object]:
        """Plain-JSON form for the checkpoint manifest."""
        return {"axes": {k: int(v) for k, v in self.axes.items()},
                "device_count": int(self.device_count),
                "digest": self.digest()}

    @classmethod
    def from_meta(cls, doc) -> Optional["MeshDescriptor"]:
        """Rebuild from manifest meta; None for absent/foreign shapes."""
        if isinstance(doc, MeshDescriptor):
            return doc
        if not isinstance(doc, dict) or "axes" not in doc:
            return None
        return cls(axes={str(k): int(v)
                         for k, v in dict(doc["axes"]).items()},
                   device_count=int(doc.get("device_count",
                                            int(np.prod([int(v) for v in
                                                dict(doc["axes"]).values()]
                                                or [1])))))

    def __eq__(self, other):
        if not isinstance(other, MeshDescriptor):
            return NotImplemented
        return (self.device_count == other.device_count and
                {k: v for k, v in self.axes.items() if v != 1} ==
                {k: v for k, v in other.axes.items() if v != 1})


def mesh_descriptor(mesh: Mesh) -> MeshDescriptor:
    """The :class:`MeshDescriptor` of a mesh."""
    axes = {str(name): int(size) for name, size in mesh.shape.items()}
    return MeshDescriptor(axes=axes, device_count=int(mesh.size))


def plan_resize(old: MeshDescriptor, new_device_count: int
                ) -> Dict[str, int]:
    """Degrees for the resized mesh: ``build_mesh(**plan_resize(...))``.
    Only the data axes scale (``mp``/``pp``/``sp`` keep their degrees);
    with both data axes active the ``sharding`` degree is kept and ``dp``
    scales. Raises :class:`ReshardError` when the new world size cannot
    carry the kept axes."""
    new_device_count = int(new_device_count)
    if new_device_count < 1:
        raise ReshardError(
            f"cannot resize to a world of {new_device_count} devices")
    fixed = old.model_degree
    if new_device_count % fixed:
        raise ReshardError(
            f"world size {new_device_count} cannot carry the "
            f"checkpoint's model-parallel topology (mp={old.degree('mp')}"
            f" x pp={old.degree('pp')} x sp={old.degree('sp')} = {fixed} "
            f"does not divide {new_device_count}): elastic resize scales "
            "the data axes (dp/sharding) only — pick a world size that "
            f"is a multiple of {fixed}, or retrain/export the checkpoint "
            "at the new model-parallel degrees")
    data = new_device_count // fixed
    degrees = {"mp": old.degree("mp"), "pp": old.degree("pp"),
               "sp": old.degree("sp")}
    old_dp, old_shard = old.degree("dp"), old.degree("sharding")
    if old_shard == 1:
        degrees["dp"], degrees["sharding"] = data, 1
    elif old_dp == 1:
        degrees["dp"], degrees["sharding"] = 1, data
    else:
        if data % old_shard:
            raise ReshardError(
                f"world size {new_device_count} cannot keep the "
                f"checkpoint's ZeRO sharding degree {old_shard} "
                f"(data capacity {data} is not a multiple of it): pick "
                f"a multiple of {fixed * old_shard}, or rebuild the "
                "engine with sharding=1 to let dp absorb the resize")
        degrees["dp"], degrees["sharding"] = data // old_shard, old_shard
    return degrees


def ensure_reshardable(saved: Optional[MeshDescriptor],
                       target: MeshDescriptor) -> bool:
    """Whether restoring a checkpoint saved on ``saved`` onto ``target``
    is a resharding restore (False: the same mesh). Raises
    :class:`ReshardError` when the target changes a model axis."""
    if saved is None or saved == target:
        return False
    for axis in ("mp", "pp", "sp"):
        if saved.degree(axis) != target.degree(axis):
            raise ReshardError(
                f"checkpoint was saved on a mesh with {axis}="
                f"{saved.degree(axis)} but the restore target has "
                f"{axis}={target.degree(axis)}: elastic resize scales "
                "the data axes (dp/sharding) only. Rebuild the target "
                f"mesh with {axis}={saved.degree(axis)} (plan_resize() "
                "computes the degrees for a new world size)")
    return True


class CommunicateTopology:
    """Rank-coordinate bookkeeping over the hybrid axes (reference
    topology.py:35). Pure arithmetic."""

    def __init__(self, hybrid_group_names: Sequence[str],
                 dims: Sequence[int]):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world_size = int(np.prod(self._dims)) if self._dims else 1
        coords = np.indices(self._dims).reshape(len(self._dims), -1).T
        self._coord_to_rank = {tuple(int(x) for x in c): r
                               for r, c in enumerate(coords)}
        self._rank_to_coord = {r: tuple(int(x) for x in c)
                               for r, c in enumerate(coords)}

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **axis_coords) -> int:
        coord = tuple(axis_coords[name] for name in self._parallel_names)
        return self._coord_to_rank[coord]

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return self._rank_to_coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on ``axis_name`` equals ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord_to_rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Groups of ranks that communicate along ``axis_name`` (one group
        per combination of the other axes' coordinates)."""
        axis = self._parallel_names.index(axis_name)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for coord, rank in sorted(self._coord_to_rank.items(),
                                  key=lambda kv: kv[1]):
            others = coord[:axis] + coord[axis + 1:]
            groups.setdefault(others, []).append(rank)
        return [sorted(g) for _, g in sorted(groups.items())]


_ALIASES = {"data": "dp", "model": "mp", "pipe": "pp", "sharding":
            "sharding", "sep": "sp"}


class HybridCommunicateGroup:
    """The fleet hybrid-parallel context (reference topology.py:111): the
    mesh and this rank's coordinates, with one real ``collective.Group``
    per axis (the JAX package hands out ``(mesh, axis)`` handles). Built
    from a ``mesh``, or from the topology's degrees (``build_mesh``, a
    collective call)."""

    def __init__(self, topology: CommunicateTopology,
                 mesh: Optional[Mesh] = None, rank: Optional[int] = None):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        degrees = {n: topology.get_dim(n) for n in names}
        self._mesh = mesh if mesh is not None else build_mesh(
            dp=degrees.get("data", degrees.get("dp", 1)),
            mp=degrees.get("model", degrees.get("mp", 1)),
            pp=degrees.get("pipe", degrees.get("pp", 1)),
            sharding=degrees.get("sharding", 1),
            sp=degrees.get("sep", degrees.get("sp", 1)))
        self._rank = rank if rank is not None else collective.get_rank()
        self._coord = topology.get_coord(self._rank % topology.world_size())
        self._names = names

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    def axis_name(self, logical: str) -> str:
        return _ALIASES.get(logical, logical)

    def _dim(self, *names) -> int:
        for n in names:
            if n in self._names:
                return self._topo.get_dim(n)
        return 1

    def _coord_of(self, *names) -> int:
        for n in names:
            if n in self._names:
                return self._coord[self._names.index(n)]
        return 0

    def get_global_rank(self) -> int:
        return self._rank

    def get_data_parallel_world_size(self) -> int:
        return self._dim("data", "dp")

    def get_data_parallel_rank(self) -> int:
        return self._coord_of("data", "dp")

    def get_model_parallel_world_size(self) -> int:
        return self._dim("model", "mp")

    def get_model_parallel_rank(self) -> int:
        return self._coord_of("model", "mp")

    def get_pipe_parallel_world_size(self) -> int:
        return self._dim("pipe", "pp")

    def get_stage_id(self) -> int:
        return self._coord_of("pipe", "pp")

    def get_sharding_parallel_world_size(self) -> int:
        return self._dim("sharding")

    def get_sharding_parallel_rank(self) -> int:
        return self._coord_of("sharding")

    def get_sep_parallel_world_size(self) -> int:
        return self._dim("sep", "sp")

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    def get_data_parallel_group(self) -> collective.Group:
        return self._mesh.groups["dp"]

    def get_model_parallel_group(self) -> collective.Group:
        return self._mesh.groups["mp"]

    def get_pipe_parallel_group(self) -> collective.Group:
        return self._mesh.groups["pp"]

    def get_sharding_parallel_group(self) -> collective.Group:
        return self._mesh.groups["sharding"]

    def get_sep_parallel_group(self) -> collective.Group:
        return self._mesh.groups["sp"]

    def topology(self) -> CommunicateTopology:
        return self._topo


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup) -> None:
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
