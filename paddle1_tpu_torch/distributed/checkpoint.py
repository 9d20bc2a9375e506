"""Sharded checkpoints (port of ``paddle1_tpu/distributed/checkpoint.py``).

The JAX package saves each shard of a ``jax.Array`` from the process
that owns it through orbax, and restores into the target's shardings.
The port writes its own format, one file a rank: each rank saves the
pieces it owns and nothing else, with no host gather, and a restore
reads, for each piece the target holds, the byte ranges of whichever
files cover it. Reading an orbax checkpoint of the JAX package is not
supported (ROADMAP.md Queue 3, departures).

A state tree is a dict, list or tuple, nested, whose leaves are
tensors or :class:`Piece`\\ s. A :class:`Piece` is a rank's contiguous
run of a tensor's elements (row-major, ``start`` the first): what a ZeRO
shard holds of a tensor, or a whole tensor as one run. Every rank saves
the pieces it is given; a plain tensor leaf is saved by global rank 0
only (a replicated value). The caller gives each piece to one rank
(``ParallelEngine.save_checkpoint`` leaves out the data, ``sp``, ``mp``
and ``pp`` replicas).

On disk a checkpoint directory holds ``shard-<rank>.pt`` (``torch.save``
of ``{"<key>@<start>": 1-D tensor}``, the key the leaf's path in the
JAX package's ``keystr`` form) and ``index.json``: every rank's records
``[key, start, numel, shape, dtype, file]`` and the mesh the state was
saved on. A restore reads the index, and for each target piece copies
the overlapping part of every record of its key; a piece that the
records do not cover in full, or whose shape or dtype differs, raises
:class:`CheckpointCorruptError`. So a checkpoint written at sharding n
restores at sharding m, or at world size 1: the layout of the pieces is
the target's own.

The fault-tolerance contract is the JAX package's:

* **Atomic commits** — :meth:`CheckpointManager.save` writes into a
  ``<step>.tmp-<pid>`` sibling (``<step>.tmp`` across processes, every
  rank writing its file there), stamps ``manifest.json`` (the tree spec
  ``(path, shape, dtype)`` of every leaf, its sha256 digest and the host
  metadata) and renames into place; a write killed at any point leaves a
  ``.tmp-*`` directory or a directory without a manifest, and both read
  as uncommitted.
* **Manifest verification** — a restore checks the saved tree spec
  against the target's before it reads a byte.
* **Fallback** — a restore without a step walks back from the newest
  committed checkpoint to the newest one that verifies and loads.
* **GC** — retention counts committed checkpoints only, and debris is
  swept (another process's only once stale).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.errors import EnforceNotMet

__all__ = ["save_sharded", "load_sharded", "latest_step",
           "committed_steps", "CheckpointCorruptError", "CheckpointManager",
           "MANIFEST_NAME", "write_manifest", "read_manifest",
           "verify_manifest", "tree_mesh_descriptor", "manifest_mesh",
           "read_sidecar", "Piece"]

MANIFEST_NAME = "manifest.json"
INDEX_NAME = "index.json"


class CheckpointCorruptError(EnforceNotMet, IOError):
    """No checkpoint under the directory survived verification."""


class Piece:
    """A rank's contiguous run of a tensor's elements: ``data`` (1-D,
    written in place by a restore), the run's first element ``start`` in
    the tensor's row-major order, the whole tensor's ``shape`` (default:
    ``data``'s), and the ``MeshDescriptor`` of the mesh it lives on
    (``mesh``, or None)."""

    __slots__ = ("data", "start", "shape", "mesh")

    def __init__(self, data: torch.Tensor, start: int = 0, shape=None,
                 mesh=None):
        self.data = data.reshape(-1)
        self.start = int(start)
        self.shape = tuple(int(s) for s in (
            data.shape if shape is None else shape))
        self.mesh = mesh

    @property
    def dtype(self):
        return self.data.dtype


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` in ``jax.tree_util``'s order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def _rebuild(tree, leaves: Dict[str, Any], path: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, f"{path}[{k!r}]")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[path]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _shape_dtype(leaf) -> Tuple[List[int], str]:
    if isinstance(leaf, Piece):
        return list(leaf.shape), _dtype_name(leaf.dtype)
    if isinstance(leaf, torch.Tensor):
        return [int(s) for s in leaf.shape], _dtype_name(leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return [int(s) for s in leaf.shape], str(leaf.dtype)
    return [], type(leaf).__name__


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else \
        torch.as_tensor(np.asarray(leaf))


def save_sharded(path: str, state: Dict[str, Any], *, force: bool = True):
    """Save a state tree: every rank writes the pieces it is given (global
    rank 0 the plain tensor leaves too) into ``shard-<rank>.pt``, and rank
    0 writes the index of every rank's records (a collective call when a
    process group exists: every rank calls it). Returns the path."""
    path = os.path.abspath(path)
    rank, world = _world()
    os.makedirs(path, exist_ok=True)
    fname = f"shard-{rank:05d}.pt"
    fp = os.path.join(path, fname)
    if os.path.exists(fp) and not force:
        raise FileExistsError(f"{fp} exists (force=False)")
    blobs, records = {}, []
    for key, leaf in _flatten(state):
        if isinstance(leaf, Piece):
            data, start, shape = leaf.data, leaf.start, leaf.shape
        elif rank == 0:
            t = _as_tensor(leaf)
            data, start, shape = t.reshape(-1), 0, tuple(t.shape)
        else:
            continue
        # a copy of the run alone (a view would save its whole storage)
        blobs[f"{key}@{start}"] = data.detach().to("cpu", copy=True)
        records.append([key, int(start), int(data.nelement()),
                        [int(s) for s in shape], _dtype_name(data.dtype),
                        fname])
    tmp = fp + f".tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(blobs, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fp)
    every = [records]
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, records)
    if rank == 0:
        mesh = tree_mesh_descriptor(state)
        doc = {"version": 1, "world": world,
               "mesh": None if mesh is None else mesh.as_meta(),
               "records": [r for rs in every for r in rs]}
        itmp = os.path.join(path, INDEX_NAME + ".tmp")
        with open(itmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(itmp, os.path.join(path, INDEX_NAME))
    if world > 1:
        dist.barrier()
    return path


def tree_mesh_descriptor(tree):
    """The ``MeshDescriptor`` of the first :class:`Piece` of the tree that
    names its mesh, or None (a tree of plain tensors)."""
    for _, leaf in _flatten(tree):
        if isinstance(leaf, Piece) and leaf.mesh is not None:
            return leaf.mesh
    return None


def manifest_mesh(path: str):
    """The ``MeshDescriptor`` stamped into a checkpoint's manifest meta,
    or None."""
    from .topology import MeshDescriptor
    doc = read_manifest(path)
    if doc is None:
        return None
    return MeshDescriptor.from_meta((doc.get("meta") or {}).get("mesh"))


def _read_index(path: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(path, INDEX_NAME)) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} has no readable {INDEX_NAME}: {e}") from e
    if not isinstance(doc, dict) or "records" not in doc:
        raise CheckpointCorruptError(f"checkpoint {path}: malformed index")
    return doc


# "not provided" sentinel for load_sharded's saved_mesh (None is a value:
# a checkpoint known to carry no mesh)
_MESH_UNKNOWN = object()


def load_sharded(path: str, target: Dict[str, Any], *,
                 saved_mesh=_MESH_UNKNOWN):
    """Restore into ``target``'s layout: each :class:`Piece` is filled in
    place from the records that cover it, each plain tensor leaf is
    returned as a new tensor on its device. Returns the restored tree.

    When the checkpoint's mesh (``saved_mesh``; by default the
    manifest's, else the index's) differs from the target's
    (:func:`tree_mesh_descriptor`), the resize is validated first
    (``topology.ensure_reshardable``: only the data axes dp/sharding may
    change degree), and each rank reads only the runs its new pieces
    cover."""
    path = os.path.abspath(path)
    index = _read_index(path)
    if saved_mesh is _MESH_UNKNOWN:
        from .topology import MeshDescriptor
        saved_mesh = manifest_mesh(path) or \
            MeshDescriptor.from_meta(index.get("mesh"))
    tgt_mesh = tree_mesh_descriptor(target)
    if tgt_mesh is not None:
        from .topology import ensure_reshardable
        if ensure_reshardable(saved_mesh, tgt_mesh):
            warnings.warn(
                f"resharding restore: checkpoint {os.path.basename(path)} "
                f"was saved on {saved_mesh.device_count} device(s) "
                f"{dict(saved_mesh.axes)}, restoring onto "
                f"{tgt_mesh.device_count} device(s) {dict(tgt_mesh.axes)}")
    by_key: Dict[str, list] = {}
    for key, start, numel, shape, dtype, fname in index["records"]:
        by_key.setdefault(key, []).append((start, numel, shape, dtype,
                                           fname))
    files: Dict[str, Dict[str, torch.Tensor]] = {}

    def blob(fname, name):
        if fname not in files:
            try:
                files[fname] = torch.load(os.path.join(path, fname),
                                          map_location="cpu", mmap=True,
                                          weights_only=True)
            except (OSError, RuntimeError, EOFError) as e:
                raise CheckpointCorruptError(
                    f"checkpoint {path}: {fname} is unreadable: {e}") from e
        try:
            return files[fname][name]
        except KeyError:
            raise CheckpointCorruptError(
                f"checkpoint {path}: {fname} lacks {name}") from None

    out = {}
    for key, leaf in _flatten(target):
        if isinstance(leaf, Piece):
            dest, lo, shape = leaf.data, leaf.start, leaf.shape
        else:
            t = _as_tensor(leaf)
            dest = torch.empty_like(t).reshape(-1)
            lo, shape = 0, tuple(t.shape)
        hi = lo + dest.nelement()
        covered = 0
        with torch.no_grad():
            for start, numel, rshape, dtype, fname in by_key.get(key, ()):
                a, b = max(lo, start), min(hi, start + numel)
                if a >= b:
                    continue
                if tuple(rshape) != tuple(shape) or \
                        dtype != _dtype_name(dest.dtype):
                    raise CheckpointCorruptError(
                        f"checkpoint {path}: {key} was saved as {dtype} "
                        f"{rshape}, the target is {_dtype_name(dest.dtype)} "
                        f"{list(shape)}")
                src = blob(fname, f"{key}@{start}")
                dest[a - lo:b - lo].copy_(src[a - start:b - start])
                covered += b - a
        if covered != hi - lo:
            raise CheckpointCorruptError(
                f"checkpoint {path}: {key} elements [{lo}, {hi}) are "
                f"covered for {covered} of {hi - lo}")
        out[key] = leaf if isinstance(leaf, Piece) else \
            dest.view(shape)
    return _rebuild(target, out)


# -- manifests ---------------------------------------------------------------

def _tree_spec(state) -> List[Tuple[str, List[int], str]]:
    """``(path, shape, dtype)`` per leaf, the JAX package's form: the
    structural identity of a checkpoint (a :class:`Piece` stands for its
    whole tensor)."""
    return [(key, *_shape_dtype(leaf)) for key, leaf in _flatten(state)]


def _spec_digest(spec) -> str:
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def _json_safe_meta(obj, keypath="meta"):
    """Checkpoint meta coerced to plain JSON types (numpy scalars
    narrowed, a ``MeshDescriptor`` flattened), naming the offending key
    on anything else."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    from .topology import MeshDescriptor
    if isinstance(obj, MeshDescriptor):
        return obj.as_meta()
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise CheckpointCorruptError(
                    f"checkpoint meta key {keypath}[{k!r}] is not a "
                    "string — manifest meta must be JSON-serializable")
            out[k] = _json_safe_meta(v, f"{keypath}.{k}")
        return out
    if isinstance(obj, (list, tuple)):
        return [_json_safe_meta(v, f"{keypath}[{i}]")
                for i, v in enumerate(obj)]
    raise CheckpointCorruptError(
        f"checkpoint meta value at {keypath} "
        f"({type(obj).__name__}) is not JSON-serializable — manifest "
        "meta carries small host state only (steps, seeds, cursors)")


def _write_sidecars(path: str,
                    sidecars: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Each sidecar as ``sidecar-<name>.npz`` inside the (uncommitted)
    step directory; returns the manifest entry of each (file, sha256)."""
    info: Dict[str, Any] = {}
    for name, arrays in sidecars.items():
        if not re.fullmatch(r"[A-Za-z0-9_.-]+", name):
            raise ValueError(
                f"sidecar name {name!r} must be a plain identifier "
                "(it becomes a filename inside the checkpoint)")
        fname = f"sidecar-{name}.npz"
        fp = os.path.join(path, fname)
        with open(fp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        with open(fp, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        info[name] = {"file": fname, "sha256": digest}
    return info


def read_sidecar(path: str, name: str) -> Dict[str, Any]:
    """One sidecar of a committed checkpoint, its sha256 verified against
    the manifest's; a missing sidecar or file, or a changed digest, raises
    :class:`CheckpointCorruptError`."""
    doc = read_manifest(path)
    if doc is None:
        raise CheckpointCorruptError(
            f"checkpoint {path} has no readable manifest — not a "
            "committed checkpoint")
    sidecars = (doc.get("meta") or {}).get("sidecars", {})
    info = sidecars.get(name)
    if info is None:
        raise CheckpointCorruptError(
            f"checkpoint {path} has no sidecar {name!r} "
            f"(manifest lists {sorted(sidecars)})")
    fp = os.path.join(path, info["file"])
    try:
        with open(fp, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CheckpointCorruptError(
            f"sidecar {name!r} of checkpoint {path} is unreadable: "
            f"{e}") from e
    digest = hashlib.sha256(blob).hexdigest()
    if digest != info["sha256"]:
        raise CheckpointCorruptError(
            f"sidecar {name!r} of checkpoint {path} failed digest "
            f"verification (manifest {info['sha256'][:12]}…, file "
            f"{digest[:12]}…) — treat this checkpoint as corrupt")
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def write_manifest(path: str, state, meta: Optional[Dict[str, Any]] = None):
    """Stamp ``manifest.json`` into a checkpoint directory: the commit
    marker, with the tree spec a restore verifies against its target."""
    spec = _tree_spec(state)
    doc = {"version": 1, "tree": spec, "digest": _spec_digest(spec),
           "meta": _json_safe_meta(meta or {})}
    tmp = os.path.join(path, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, MANIFEST_NAME))


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The manifest of a checkpoint directory, or None when absent or
    unreadable (both mean: not a committed checkpoint)."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or "tree" not in doc:
            return None
        return doc
    except (OSError, ValueError):
        return None


def verify_manifest(path: str, target) -> Dict[str, Any]:
    """Check a checkpoint's manifest against the restore target's tree
    spec; returns the manifest. A missing manifest or a structure, shape
    or dtype mismatch raises :class:`CheckpointCorruptError`."""
    doc = read_manifest(path)
    if doc is None:
        raise CheckpointCorruptError(
            f"checkpoint {path} has no readable manifest "
            "(partial write, or pre-manifest checkpoint)")
    saved = [[k, [int(x) for x in s], d] for k, s, d in doc["tree"]]
    want = [[k, list(s), d] for k, s, d in _tree_spec(target)]
    if saved != want:
        diff = next(((a, b) for a, b in zip(saved, want) if a != b),
                    ("<leaf-count>", (len(saved), len(want))))
        raise CheckpointCorruptError(
            f"checkpoint {path} does not match the restore target "
            f"({len(saved)} vs {len(want)} leaves; first difference: "
            f"saved={diff[0]} target={diff[1]})")
    return doc


# -- step-directory bookkeeping ----------------------------------------------

_STEP_RE = re.compile(r"\d+$")


def _step_of(name: str) -> Optional[int]:
    """A step directory's number; None for anything else (tmp
    directories, stray files, digits ``int`` rejects)."""
    return int(name) if _STEP_RE.fullmatch(name) else None


def committed_steps(directory: str) -> List[int]:
    """Ascending steps of committed checkpoints (a numeric directory with
    a readable manifest); partial writes and foreign files are skipped."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        s = _step_of(d)
        if s is None:
            continue
        p = os.path.join(directory, d)
        if os.path.isdir(p) and read_manifest(p) is not None:
            steps.append(s)
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """The largest committed step under ``directory``, or None."""
    steps = committed_steps(directory)
    return steps[-1] if steps else None


class CheckpointManager:
    """Step-numbered checkpoints with retention, atomic commits, manifest
    verification and the fallback past a corrupt checkpoint (see the
    module docstring). Across processes every rank calls :meth:`save`
    (each writes its pieces) and global rank 0 commits; every rank learns
    the outcome."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        if int(max_to_keep) < 1:
            raise ValueError(
                f"max_to_keep must be >= 1, got {max_to_keep} "
                f"(steps[:-0] would silently disable retention)")
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None,
             sidecars: Optional[Dict[str, Dict[str, Any]]] = None):
        """Atomically commit ``state`` as checkpoint ``step``: the pieces
        into ``<step>.tmp-<pid>``, the sidecar npz files beside them, the
        manifest (the commit marker, with each sidecar's sha256), then the
        rename. ``meta`` (small JSON host state) rides in the manifest;
        ``sidecars`` (``{name: {key: array}}``) are host arrays too large
        for it, committed by the same rename (:meth:`read_sidecar`)."""
        final = self._step_dir(step)
        rank, world = _world()
        tmp = f"{final}.tmp" if world > 1 else f"{final}.tmp-{os.getpid()}"
        save_sharded(tmp, state)
        commit_err: Optional[Exception] = None
        if rank == 0:
            try:
                from ..core import chaos
                chaos.check_checkpoint_write()
                if sidecars:
                    meta = dict(meta or {})
                    meta["sidecars"] = _write_sidecars(tmp, sidecars)
                write_manifest(tmp, state, meta=meta)
                if os.path.isdir(final):
                    # re-saving a step: the old commit moves aside first,
                    # so a crash mid-swap leaves one of the two committed
                    old = f"{final}.old-{os.getpid()}"
                    os.replace(final, old)
                    os.replace(tmp, final)
                    shutil.rmtree(old, ignore_errors=True)
                else:
                    os.replace(tmp, final)
                self._gc()
            except Exception as e:     # raised below, after every rank
                commit_err = e         # has learned the outcome
        if world > 1:
            outcome = [None] * world
            dist.all_gather_object(outcome, commit_err is None)
            if not outcome[0]:
                if commit_err is not None:
                    raise commit_err
                raise IOError(
                    f"checkpoint {step} commit failed on process 0")
        elif commit_err is not None:
            raise commit_err
        return final

    def restore(self, target: Dict[str, Any],
                step: Optional[int] = None):
        """Restore the newest checkpoint that verifies (or exactly
        ``step``), falling back past corrupt or partial ones. Returns
        ``(restored tree, step)``."""
        from .topology import MeshDescriptor, ReshardError

        def _load(path):
            doc = verify_manifest(path, target)
            mesh = MeshDescriptor.from_meta(
                (doc.get("meta") or {}).get("mesh"))
            return load_sharded(path, target, saved_mesh=mesh)

        if step is not None:
            return _load(self._step_dir(step)), int(step)
        candidates = committed_steps(self.directory)
        if not candidates:
            raise FileNotFoundError(
                f"no committed checkpoints under {self.directory}")
        errors = []
        for s in reversed(candidates):
            try:
                return _load(self._step_dir(s)), s
            except ReshardError:
                # a configuration error, not corruption: every older
                # checkpoint shares the mesh
                raise
            except Exception as e:      # corrupt or mismatched: fall back
                errors.append((s, e))
                warnings.warn(
                    f"checkpoint step {s} failed to restore "
                    f"({type(e).__name__}: {e}); falling back")
        raise CheckpointCorruptError(
            f"every checkpoint under {self.directory} failed to "
            f"restore: {[(s, str(e)) for s, e in errors]}")

    def read_meta(self, step: Optional[int] = None) -> \
            Optional[Dict[str, Any]]:
        """The host metadata stamped into a checkpoint's manifest."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        doc = read_manifest(self._step_dir(step))
        return None if doc is None else doc.get("meta", {})

    def read_sidecar(self, name: str,
                     step: Optional[int] = None) -> Dict[str, Any]:
        """The digest-verified sidecar arrays of checkpoint ``step`` (the
        newest committed one when omitted)."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise CheckpointCorruptError(
                f"no committed checkpoints under {self.directory}")
        return read_sidecar(self._step_dir(step), name)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def all_steps(self) -> List[int]:
        return committed_steps(self.directory)

    # debris younger than this may belong to a live writer in another
    # process: it is left for a later sweep
    _DEBRIS_MIN_AGE_S = 300.0

    def _gc(self):
        """Retention over committed checkpoints only, and a sweep of
        uncommitted debris: this process's own tmp directories at once,
        another's once stale; a numeric directory without a manifest (a
        foreign or legacy one) is kept and never counted."""
        committed = set(committed_steps(self.directory))
        for s in sorted(committed)[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        own = f"-{os.getpid()}"
        now = time.time()
        for d in os.listdir(self.directory):
            p = os.path.join(self.directory, d)
            if not os.path.isdir(p):
                continue
            try:
                stale = now - os.path.getmtime(p) > self._DEBRIS_MIN_AGE_S
            except OSError:
                continue        # gone under us
            if _step_of(d) is None and (".tmp" in d or ".old-" in d) and \
                    (d.endswith(own) or stale):
                shutil.rmtree(p, ignore_errors=True)
