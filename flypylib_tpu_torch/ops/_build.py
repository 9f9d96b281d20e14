"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together), and the objects are linked into
one shared library with a plain C interface, at first use, under
``build/kernels/`` at the root of the checkout.  The file name carries a
hash of the sources, the headers they share (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded.  No PyTorch header is compiled: the wrappers pass
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
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *GENCODE,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (restype is always int: a cudaError_t)
_ENTRIES = {
    "fpl_conv3d_bias_relu": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "fpl_conv3d_ci1": [_P] * 4 + [_I] * 12 + [_P],
    "fpl_conv3d_wgmma": [_P] * 5 + [_I] * 13 + [_P],
    "fpl_conv3d_f32": [_P] * 4 + [_I] * 12 + [_P],
    "fpl_tail_stage": [_P] * 6 + [_I] * 8 + [_P],
    "fpl_tail_stage_f32": [_P] * 5 + [_I] * 11 + [_P],
    "fpl_tail_stage_wgmma": [_P] * 8 + [_I] * 12 + [_P],
    "fpl_stage_bias_relu_wgmma": [_P] * 5 + [_I] * 12 + [_P],
    "fpl_tail_logits": [_P] * 4 + [ctypes.c_longlong, _I, _I, _I, _P],
    "fpl_parity_split": [_P, _P] + [_I] * 6 + [_P],
    "fpl_wino_conv": [_P] * 4 + [_I] * 9 + [_P],
    "fpl_wino_conv_wgmma": [_P] * 5 + [_I] * 12 + [_P],
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
    for src in [*_sources(), *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfpl_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless the library is already built.

    Returns ``(path, seconds spent compiling and linking)``; the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills per kernel) is
    kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(_sources(), objs)
    ]
    logs = [p.communicate()[0] for p in procs]  # waits for every compile
    log = "".join(logs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        failed = [link.returncode] if link.returncode != 0 else []
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
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
