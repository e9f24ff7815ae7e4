"""Build, load and launch the hand-written CUDA kernels.

``csrc/*.cu`` is compiled on first use with ``nvcc`` into one shared library
with a plain C interface and loaded with :mod:`ctypes` (no PyTorch headers,
so a build takes seconds).  Each source compiles to an object file in its
own ``nvcc`` process, all started together, and one link makes the library.
It lands in ``vulkan_raytracer_tpu_torch/build/``, named by a hash of the
sources, their headers and the flags, so an edited source builds anew and
an unchanged one is reused.  ptxas's per-kernel report (registers, shared memory, spills) is
kept beside it as ``<library>.ptxas.txt``.

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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = (CSRC / "dense_sweep.cu", CSRC / "bvh_walk.cu", CSRC / "graph_loops.cu",
           CSRC / "shade.cu", CSRC / "wave.cu", CSRC / "trace.cu")
#: Headers the sources include: part of the library's hash.
HEADERS = (CSRC / "lane_math.cuh", CSRC / "hit_finish.cuh", CSRC / "graph_test.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_RAYS = [_P] * 6  # ox, oy, oz, dx, dy, dz
_STREAMS = [_P, _P, _I]  # nodes, tris, num_nodes

#: argtypes of each C function: the kernel launchers take the device index
#: first and the stream last; the graph functions (csrc/graph_loops.cu) take
#: graphs and nodes as pointers and hand back what they make through
#: pointers
_SIGNATURES = {
    # (device, table, n_tris, rays, ...)
    "dense_closest_launch": [_I, _P, _I] + _RAYS + [_P, _P, _P, _P, _I, _P],
    "dense_shadow_launch": [_I, _P, _I] + _RAYS + [_P, _P, _I, _P],
    "dense_pdf_launch": [_I, _P, _I] + _RAYS + [_P, _F, _P, _I, _P],
    # (device, shadow, streams, [tl_box, tl_group, tl_lim, n_treelets,] rays, t_lo,
    #  t_init, t_out, slot_out, n_rays, stream)
    "bvh_walk_launch": [_I, _I] + _STREAMS + _RAYS + [_P, _P, _P, _P, _I, _P],
    "treelet_walk_launch": [_I, _I] + _STREAMS + [_P, _P, _P, _I] + _RAYS
    + [_P, _P, _P, _P, _I, _P],
    # (device, wide, rows, num_wide, rays, active, t_min, pdf_out, n_rays, stream)
    "emissive_walk_launch": [_I] + _STREAMS + _RAYS + [_P, _F, _P, _I, _P],
    # (graph, out: nodes, out: type of the first node a conditional body may not hold)
    "graph_loops_check": [_P, _P, _P],
    "graph_loops_versions": [_P, _P],  # (out: driver, out: runtime)
    "graph_loops_create": [_P],  # (out: graph)
    "graph_loops_add_child": [_P, _P, _P],  # (graph, in/out: tail node, child graph)
    "graph_loops_handle": [_P, _P],  # (graph, out: handle)
    "graph_loops_add_test": [_P, _P, _P],  # (graph, in/out: tail, the test's parameters)
    # (graph, in/out: tail, dst, src (null: zeroes), int64 words)
    "graph_loops_add_copy": [_P, _P, _P, _P, ctypes.c_longlong],
    # (graph, in/out: tail, handle, is_while, out: body graph)
    "graph_loops_add_conditional": [_P, _P, ctypes.c_uint64, _I, _P],
    "graph_loops_instantiate": [_I, _P, _P],  # (device, graph, out: exec)
    "graph_loops_launch": [_I, _P, _P],  # (device, exec, stream)
    "graph_loops_destroy": [_P, _P],  # (graph, exec)
    # (device, pointers [shade.SLOTS], counts [shade.INTS], stream)
    "shade_hit_launch": [_I, _P, _P, _P],
    "shade_scatter_launch": [_I, _P, _P, _P],
    "shade_resolve_launch": [_I, _P, _P, _P],
    # (device, pointers [wave.SLOTS], counts [wave.INTS], stream)
    "primary_rays_launch": [_I, _P, _P, _P],
    "alpha_commit_launch": [_I, _P, _P, _P],
    "wave_sum_launch": [_I, _P, _P, _P],
    "frame_post_launch": [_I, _P, _P, _P],
    # (device, pointers [trace.SLOTS], counts [trace.INTS], floats [trace.REALS], stream)
    "hit_finish_launch": [_I, _P, _P, _P, _P],
    "instance_step_launch": [_I, _P, _P, _P, _P],
    "coherence_key_launch": [_I, _P, _P, _P, _P],
    "permute_launch": [_I, _P, _P, _P, _P],
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
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the kernels if no library for these sources exists yet."""
    out = BUILD_DIR / f"libvkrt_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    report = []
    for cmd, proc in zip(cmds, procs):
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
        report.append(text)
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
    for obj in objs:
        obj.unlink()
    out.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def ptxas_report() -> str:
    """ptxas's register / shared-memory / spill lines for the built library."""
    path = build().with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


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
    lib.graph_loops_node_type_name.argtypes = [ctypes.c_int]
    lib.graph_loops_node_type_name.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.dense_sweep_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(fn: str, device: torch.device, *args) -> None:
    """Call C launcher ``fn`` on ``device``'s current stream; tensors pass as
    pointers, Python ints and floats as they are.  Raises on a CUDA error."""
    lib = library()
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    check(lib, getattr(lib, fn)(index, *c_args, stream), fn)


class Columns:
    """The arguments of one launch of a kernel that takes one pointer per
    column, in the order of its source's ``enum Slot`` (``slots``: name ->
    index), and counts, in the order of its ``enum Int`` (``ints``, the
    lanes ``I_N`` among them; name -> index): filled column by column, each
    checked against what the kernel reads (``ops/shade.py``,
    ``ops/wave.py``)."""

    def __init__(self, slots: dict, ints: dict, n: int, device, what: str):
        self.slots, self.int_index, self.what = slots, ints, what
        self.n, self.device = n, device
        self.ptrs = (ctypes.c_void_p * len(slots))()
        self.ints = (ctypes.c_longlong * len(ints))()
        self.ints[ints["I_N"]] = n

    def put(self, name: str, t: torch.Tensor, dtype, shape=None) -> None:
        """Column ``name``: ``t``, of ``dtype`` on the launch's device,
        contiguous, and of ``shape`` where given."""
        if t.device != self.device or t.dtype != dtype:
            raise ValueError(f"{self.what} column {name}: expected {dtype} on {self.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{self.what} column {name}: expected a contiguous "
                             f"{shape or 'table'}, got {tuple(t.shape)} strides {t.stride()}")
        self.ptrs[self.slots[name]] = t.data_ptr()

    def lane(self, name: str, t, dtype=torch.float32) -> None:
        """A column of one element a lane."""
        self.put(name, t, dtype, (self.n,))

    def lane3(self, name: str, v) -> None:
        """A 3-vector's columns, ``name`` + X, Y, Z."""
        for c, t in zip("XYZ", v):
            self.lane(name + c, t)

    def count(self, name: str, value: int) -> None:
        self.ints[self.int_index[name]] = int(value)

    def launch(self, fn: str) -> None:
        """Call C launcher ``fn`` with the two arrays (:func:`launch`)."""
        launch(fn, self.device, ctypes.addressof(self.ptrs), ctypes.addressof(self.ints))
