"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, under
``build/kernels/`` at the root of the checkout.  The file name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  No PyTorch header is compiled: the wrappers pass
``tensor.data_ptr()`` and the current stream as ``c_void_p``.

Only the CUDA branches of the wrappers import this module, so CPU-only
callers never look for ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (restype is always int: a cudaError_t)
_ENTRIES = {
    "fpl_conv3d_bias_relu": [_P, _P, _P, _P] + [_I] * 8 + [_P],
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfpl_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless the library is already built.

    Returns ``(path, seconds spent compiling)``; the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills per kernel) is kept
    beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
