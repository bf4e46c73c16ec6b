"""Build the hand-written CUDA kernels with ``nvcc`` at first use.

Each ``hydragnn_tpu_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds, not minutes). Libraries land in
``build/hydragnn_tpu_torch/`` at the root of the checkout, keyed by a hash
of the source, the shared headers and the compiler flags: an edited kernel
is rebuilt, an unchanged one is loaded as it is. A failed build or load
raises ``RuntimeError`` with the compiler's output.

Nothing here runs when the package is imported; the first wrapper that
launches a kernel on a CUDA tensor triggers its build. Processes that share
a checkout (the replicas of a serving fleet) build under one file lock:
the first builds what is missing, the others wait and load it.
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
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hydragnn_tpu_torch"

# Hopper only: the "a" target keeps wgmma/setmaxnreg available to later
# revisions of the kernels; -Xptxas -v reports registers, shared memory and
# spills per kernel (kept in ``build_log``)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> loaded library; name -> compiler output of the build that made it
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}
# libraries ``build`` found already built (hits) or had to build (misses):
# the compile plane's cache counters (train/compile_plane.py)
build_counts: Dict[str, int] = {"hits": 0, "misses": 0}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of hydragnn_tpu_torch cannot be built"
        )
    return found


def _sources(name: str):
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise RuntimeError(f"no kernel source {src}")
    return src, sorted(CSRC.glob("*.cuh"))


def _source_hash(name: str):
    src, headers = _sources(name)
    h = hashlib.sha256()
    for p in (src, *headers):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h


def source_digest(name: str) -> str:
    """sha256 (16 hex digits) of the kernel's source and the shared
    headers: its ``KERNEL_VERSION`` in the tuned table (tune/plans.py), so
    an edited kernel never reads the plans swept for the old one."""
    return _source_hash(name).hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library for the current source of ``name`` lives."""
    h = _source_hash(name)
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    stdout, _ = proc.communicate()
    build_log[name] = stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build kernel {name!r} (exit {proc.returncode}):\n"
            f"{stdout}"
        )
    os.replace(tmp, out)


@contextlib.contextmanager
def _process_lock():
    """An exclusive ``flock`` on the build directory's lock file: across
    processes what ``_lock`` is across threads."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build every named kernel whose library is missing, one ``nvcc`` per
    source, all started together, under the build directory's file lock.
    Returns seconds per kernel built (0.0 for a kernel whose library was
    already there)."""
    names = list(names)
    compiler = nvcc()
    with _process_lock():
        return _build_locked(compiler, names)


def _build_locked(compiler: str, names) -> Dict[str, float]:
    started = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            build_counts["hits"] += 1
            seconds[name] = 0.0
            continue
        build_counts["misses"] += 1
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(_sources(name)[0])],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in started.items():
        try:
            _finish(name, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
        seconds[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: Optional[Dict[str, tuple]] = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    ``signatures`` maps each C function to ``(restype, argtypes)``."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            path = library_path(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load kernel library {path}: {e}") from e
            for fn, (restype, argtypes) in (signatures or {}).items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _libs[name] = lib
        return lib
