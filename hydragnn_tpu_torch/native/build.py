"""Build the host data plane's C++ with ``g++`` at first use.

Counterpart of ``hydragnn_tpu/native/build.py``, over the port's own copies
of the sources in this directory. Each ``<name>.cpp`` compiles on its own
into a shared library loaded with ``ctypes``. Libraries land in
``build/hydragnn_tpu_torch/native/`` at the root of the checkout, beside the
CUDA kernels' (ops/_build.py), named by a hash of the source and the
compiler flags: an edited source is rebuilt, an unchanged one is loaded as
it is (a content hash, not file times, which git does not keep). A failed
build raises ``RuntimeError`` with the compiler's output.

Nothing here runs when the package is imported.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hydragnn_tpu_torch" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
GXX_LIBS = ("-lrt", "-pthread")

_lock = threading.Lock()


def library_path(name: str) -> Path:
    """Where the library of the current source of ``name`` lives."""
    src = HERE / f"{name}.cpp"
    if not src.exists():
        raise RuntimeError(f"no native source {src}")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"_{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str) -> str:
    """Compile ``<name>.cpp`` if its library is missing; return the
    library's path. Several processes may build at once: each writes its
    own temporary file and renames it into place."""
    out = library_path(name)
    with _lock:
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(HERE / f"{name}.cpp"), *GXX_LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: the native {name!r} library cannot be "
                               "built") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build the native {name!r} library (exit "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return str(out)
