"""Build and load the hand-written CUDA kernels.

``csrc/*.cu`` is compiled on first use with ``nvcc`` into a shared library
with a plain C interface and loaded with :mod:`ctypes` (no PyTorch headers,
so a build takes seconds).  The library lands in
``vulkan_raytracer_tpu_torch/build/``, named by a hash of the sources and the
flags, so an edited source builds anew and an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false -prec-div=true
-prec-sqrt=true`` without ``--use_fast_math``, so the kernels round exactly
as the plain PyTorch versions do (see the note in ``csrc/dense_sweep.cu``).

Nothing here runs at import time: :func:`library` builds and loads on its
first call and caches the handle.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = (CSRC / "dense_sweep.cu",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of each C launcher: (device, table, n_tris, 6 ray columns, ...)
_SIGNATURES = {
    "dense_closest_launch": [_I, _P, _I] + [_P] * 6 + [_P, _P, _P, _P, _I, _P],
    "dense_shadow_launch": [_I, _P, _I] + [_P] * 6 + [_P, _P, _I, _P],
    "dense_pdf_launch": [_I, _P, _I] + [_P] * 6 + [_P, _F, _P, _I, _P],
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the CUDA kernels are built from csrc/ on first use and need the CUDA toolkit"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if no library for these sources exists yet."""
    out = BUILD_DIR / f"libvkrt_dense_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dense_sweep_error_string.argtypes = [ctypes.c_int]
    lib.dense_sweep_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.dense_sweep_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
