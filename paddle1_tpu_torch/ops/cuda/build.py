"""Build the port's CUDA kernels from the repo's sources, at first use.

Each ``*.cu`` file in this directory is compiled on its own by a plain
``nvcc -shared -Xcompiler -fPIC`` call for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`. No PyTorch
headers are included, so a build takes seconds, and no ``ninja`` is
needed. Libraries land in ``paddle1_tpu_torch/_build/`` (gitignored),
named by a hash of their source, the directory's shared ``*.cuh`` headers
and the flags, so an edited source or header is never served by a stale
library. Sources are compiled in parallel, one
``nvcc`` per file, all started together. A file lock in the build
directory serializes builds across processes (the ranks of a job start
together), so a source is compiled once and the others load it.

A failed build raises :class:`KernelBuildError` carrying nvcc's stderr,
and keeps nvcc's whole output in the build directory
(``lib<name>-<hash>.failed-<pid>.log``, one file a failed build, never
overwritten). :func:`load_file` builds a source from outside this
directory (another tree's kernel, for a benchmark) the same way.
Nothing here runs at import time: this module imports neither CUDA nor
a compiler until :func:`load` or :func:`build_all` is called.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

from ...core.errors import KernelBuildError

__all__ = ["SOURCES", "build_all", "load", "load_file", "build_dir",
           "build_log", "function", "error_string"]

_SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("layer_norm", "paged_attention", "flash_attention",
           "flash_attention_bwd", "fused_adam", "fused_bn", "fused_bn_bwd",
           "softmax")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def build_dir() -> Path:
    return _SRC_DIR.parent.parent / "_build"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH) — the port's kernels are built from source at first use")


_extra: Dict[str, Path] = {}   # sources outside this directory, by name


def _source(name: str) -> Path:
    return _extra.get(name, _SRC_DIR / f"{name}.cu")


def _target(name: str) -> Path:
    src = _source(name).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


@contextlib.contextmanager
def _dir_lock(out_dir: Path):
    """Exclusive lock on ``out_dir/.lock`` across processes."""
    with open(out_dir / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(names: List[str]) -> None:
    """Compile every missing library in ``names``, one nvcc each, all in
    flight together, under the build directory's lock; raise on the first
    failure after all have ended."""
    if all(_target(n).exists() for n in names):
        return
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with _dir_lock(out_dir):
        _compile_locked([n for n in names if not _target(n).exists()],
                        out_dir)


def _compile_locked(todo: List[str], out_dir: Path) -> None:
    if not todo:
        return
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out_dir / f".{_target(name).name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_SRC_DIR), "-o", str(tmp),
               str(_source(name))]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, tmp, proc in procs:
        out, err = proc.communicate()
        _logs[name] = out + err
        if proc.returncode != 0:
            kept = _target(name).with_suffix(f".failed-{os.getpid()}.log")
            kept.write_text(" ".join(cmd) + "\n" + _logs[name])
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode}; "
                            f"its output kept in {kept}) ---\n{err.strip()}")
            tmp.unlink(missing_ok=True)
            continue
        _log_path(name).write_text(_logs[name])
        os.replace(tmp, _target(name))  # atomic: readers never see half
    if failures:
        raise KernelBuildError("building the CUDA kernels failed:\n"
                               + "\n".join(failures))


def build_all() -> Dict[str, Path]:
    """Build every kernel of the package (parallel nvcc); return
    ``{name: library path}``."""
    with _lock:
        _compile(list(SOURCES))
    return {n: _target(n) for n in SOURCES}


def _log_path(name: str) -> Path:
    return _target(name).with_suffix(".log")


def build_log(name: str) -> Optional[str]:
    """nvcc's output (``-Xptxas -v`` register/shared-memory report) of the
    build of ``name``: this process's, else the one kept beside the
    library by the process that built it; None when there is neither."""
    log = _logs.get(name)
    if log is None and _log_path(name).exists():
        log = _log_path(name).read_text()
    return log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name`` (building every
    missing kernel first)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if name not in SOURCES:
        raise KernelBuildError(f"unknown kernel source {name!r}; "
                               f"known: {SOURCES}")
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile(list(SOURCES))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib


def load_file(path, name: str) -> ctypes.CDLL:
    """The loaded library built from the CUDA source ``path`` (outside
    this directory; it may include this directory's headers), named
    ``name`` in the build directory; built on first use as the package's
    own sources are."""
    path = Path(path).resolve()
    with _lock:
        if name in SOURCES or _extra.get(name, path) != path:
            raise KernelBuildError(f"load_file: name {name!r} is taken")
        _extra[name] = path
        lib = _libs.get(name)
        if lib is None:
            _compile([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def _lib(name: str) -> ctypes.CDLL:
    return load_file(_extra[name], name) if name in _extra else load(name)


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of kernel source ``name`` with its ``argtypes`` set and
    an ``int`` (cudaError_t) result."""
    fn = getattr(_lib(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def error_string(name: str, code: int) -> str:
    """CUDA's text for error ``code``, from source ``name``'s
    ``p1t_<name>_error_string``."""
    fn = getattr(_lib(name), f"p1t_{name}_error_string")
    fn.restype = ctypes.c_char_p
    return fn(int(code)).decode()
