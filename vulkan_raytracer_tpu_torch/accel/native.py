"""ctypes binding of the repository's native threaded-BVH builder.

Port of ``bvh_build_native`` (vulkan_raytracer_tpu/accel/native.py:109).  The
C++ source is the repository's ``native/accel_build.cpp``, compiled as it is
with g++ on first use into ``vulkan_raytracer_tpu_torch/build/`` (named by a
hash of the source, so an edited source builds anew); nothing is written
beside the source.  Without g++, or with ``VKRT_DISABLE_NATIVE`` set,
:func:`bvh_build_native` returns None and ``accel.bvh.build_bvh`` runs its
NumPy builder, as the JAX package does.  This is a host-side build step, not
a device kernel.  The grid binning of the same library is not ported (the
grid traversal is on ROADMAP.md's do-not-port list).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..utils import logging as log

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "accel_build.cpp"
BUILD_DIR = _PKG / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libvkrt_accel_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain: NumPy builder
        log.warn("native BVH build unavailable (%s); using the NumPy builder", e)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return True


@functools.lru_cache(maxsize=1)
def get_lib():
    """The loaded native library (compiled on first use), or None."""
    if os.environ.get("VKRT_DISABLE_NATIVE") or not SOURCE.exists():
        return None
    out = _library_path()
    if not out.exists() and not _compile(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        log.warn("failed to load the native BVH builder: %s", e)
        return None
    lib.vkrt_bvh_build.restype = ctypes.c_int32
    lib.vkrt_bvh_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def bvh_build_native(v0, v1, v2, leaf_size):
    """Threaded-BVH build; returns (node_min, node_max, first, miss, slots)
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    t = v0.shape[0]
    n_leaves = -(-t // leaf_size)
    max_nodes = 4 * max(n_leaves, 1) + 3
    max_slots = (2 * n_leaves + 2) * leaf_size + t
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    slots = np.empty(max_slots, np.int32)
    n_slots = np.zeros(1, np.int32)
    n_nodes = lib.vkrt_bvh_build(
        _ptr(v0), _ptr(v1), _ptr(v2), t, leaf_size,
        _ptr(node_min), _ptr(node_max), _ptr(first), _ptr(miss), _ptr(slots),
        _ptr(n_slots),
    )
    ns = int(n_slots[0])
    return (
        node_min[:n_nodes].copy(),
        node_max[:n_nodes].copy(),
        first[:n_nodes].copy(),
        miss[:n_nodes].copy(),
        slots[:ns].copy(),
    )
