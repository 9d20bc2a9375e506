"""Native host runtime of the port: the DataLoader's shared-memory arena.

``available()`` and :class:`ShmArena` are copied from the JAX package's
``core/native/__init__.py`` (its lines 127-128 and 198-262), over
``src/arena.cc``, the arena part of that package's ``native.cc``. The
library is built at first use with ``g++ -O2 -shared -fPIC -std=c++17
-pthread ... -lrt`` into ``paddle1_tpu_torch/_build/`` (gitignored), named
by a hash of its source and the flags, under a file lock in that
directory (the workers of several loaders may start together), and loaded
with :mod:`ctypes`. Nothing is built when this module is imported.

A failed build keeps g++'s whole output in the build directory
(``libarena-<hash>.failed-<pid>.log``, returned by :func:`build_error`),
and :func:`available` returns False from then on in this process: the
DataLoader then runs its thread-pool iterator, as the JAX package's does
without its native library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["available", "build_error", "library_path", "ShmArena"]

_SRC = Path(__file__).resolve().parent / "src" / "arena.cc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LIBS = ("-lrt",)

_lock = threading.Lock()
_lib = None
_failed: Optional[str] = None


def _build_dir() -> Path:
    return _SRC.parent.parent.parent.parent / "_build"


def library_path() -> Path:
    """Where the arena's library is (or will be) built: named by a hash
    of its source and the compiler flags."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(
        GXX_FLAGS + _LIBS).encode()).hexdigest()
    return _build_dir() / f"libarena-{digest[:16]}.so"


@contextlib.contextmanager
def _dir_lock(out_dir: Path):
    with open(out_dir / ".arena.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build(target: Path) -> Optional[str]:
    """Compile the arena into ``target``; None on success, else the
    failure's text (g++'s output is kept beside the library)."""
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *_LIBS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        out, rc = r.stdout + r.stderr, r.returncode
    except (OSError, subprocess.TimeoutExpired) as e:
        out, rc = repr(e), -1
    if rc != 0:
        kept = target.with_suffix(f".failed-{os.getpid()}.log")
        kept.write_text(" ".join(cmd) + "\n" + out)
        tmp.unlink(missing_ok=True)
        return f"g++ exit {rc}; its output kept in {kept}:\n{out.strip()}"
    os.replace(tmp, target)   # atomic: a reader never sees half a library
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.shm_arena_create.restype = ctypes.c_void_p
    lib.shm_arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.shm_arena_attach.restype = ctypes.c_void_p
    lib.shm_arena_attach.argtypes = [ctypes.c_char_p]
    lib.shm_arena_detach.argtypes = [ctypes.c_void_p]
    lib.shm_arena_unlink.argtypes = [ctypes.c_char_p]
    lib.shm_alloc.restype = ctypes.c_uint64
    lib.shm_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.shm_ptr.restype = ctypes.c_void_p
    lib.shm_ptr.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.shm_incref.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.shm_decref.restype = ctypes.c_int64
    lib.shm_decref.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.shm_arena_reset.argtypes = [ctypes.c_void_p]
    lib.shm_arena_used.restype = ctypes.c_uint64
    lib.shm_arena_used.argtypes = [ctypes.c_void_p]
    lib.shm_arena_size.restype = ctypes.c_uint64
    lib.shm_arena_size.argtypes = [ctypes.c_void_p]
    return lib


def _load():
    global _lib, _failed
    if _lib is not None or _failed is not None:
        return _lib
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        target = library_path()
        if not target.exists():
            target.parent.mkdir(parents=True, exist_ok=True)
            with _dir_lock(target.parent):
                if not target.exists():
                    _failed = _build(target)
        if _failed is None:
            try:
                _lib = _bind(ctypes.CDLL(str(target)))
            except OSError as e:
                _failed = f"loading {target} failed: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the arena is unavailable in this process (None when it built
    and loaded, or was never asked for)."""
    return _failed


# ---------------------------------------------------------------------------
# ShmArena — zero-copy multiprocess tensor transfer.
# ---------------------------------------------------------------------------


class ShmArena:
    """Named shared-memory arena; numpy arrays move between processes as
    (offset, shape, dtype) descriptors (reference mmap_allocator.cc)."""

    def __init__(self, name: str, size: int = 1 << 28, create: bool = True):
        import numpy as np
        self._np = np
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_failed}")
        self._lib = lib
        self.name = name.encode() if isinstance(name, str) else name
        if create:
            self._base = lib.shm_arena_create(self.name, size)
        else:
            self._base = lib.shm_arena_attach(self.name)
        if not self._base:
            raise RuntimeError(f"shm arena {name!r} mmap failed")
        # the creator's header is authoritative (attachers must not trust
        # their local default)
        self.size = int(lib.shm_arena_size(self._base))

    def put_array(self, arr) -> tuple:
        np = self._np
        arr = np.ascontiguousarray(arr)
        off = self._lib.shm_alloc(self._base, arr.nbytes)
        if off == 0:
            raise MemoryError("shm arena full")
        ctypes.memmove(self._lib.shm_ptr(self._base, off),
                       arr.ctypes.data, arr.nbytes)
        return (off, arr.shape, arr.dtype.str)

    def view_array(self, desc):
        """The block ``desc`` as a numpy array over the arena's memory, no
        copy: valid until the arena is reset or closed."""
        np = self._np
        off, shape, dtype = desc
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        ptr = self._lib.shm_ptr(self._base, off)
        buf = (ctypes.c_uint8 * n).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def get_array(self, desc):
        return self.view_array(desc).copy()

    def incref(self, desc):
        """Extra reader share of a block (multi-consumer broadcast)."""
        self._lib.shm_incref(self._base, desc[0])

    def decref(self, desc):
        self._lib.shm_decref(self._base, desc[0])

    def reset(self):
        self._lib.shm_arena_reset(self._base)

    def used(self) -> int:
        return int(self._lib.shm_arena_used(self._base))

    def close(self, unlink: bool = False):
        if self._base:
            self._lib.shm_arena_detach(self._base)
            self._base = None
        if unlink:
            self._lib.shm_arena_unlink(self.name)
