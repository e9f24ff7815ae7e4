#!/usr/bin/env python3
"""Is float32 ``sqrt`` correctly rounded on the card and on the CPU, on
every input?

    python3 tools/check_torch_sqrt.py [--out FILE.json]

Run from the root of a checkout on a machine with an NVIDIA card.  Card
against CPU frames (``tools/torch_lane_diff.py``) have named ``sqrt`` as
the op of a 1-ulp lane: the op recomputed on the CPU from the card's own
inputs gave another result.  A correctly rounded ``sqrt`` cannot differ on
equal inputs, so this tool asks each ``sqrt`` the port can run for every
non-negative finite float32 (every bit pattern from +0 to the largest
float, subnormals included, 2,139,095,040 inputs), in chunks on the card:

* ``aten``: ``torch.sqrt`` on the card (the plain versions' op);
* ``sqrtf``: a kernel built here with nvcc and the kernels' own flags
  (``ops/_ext.py``: ``-prec-sqrt=true``, no fast math), as the hand-written
  kernels call it;
* ``cpu``: ``torch.sqrt`` on the CPU, on a copy of the same chunk;

against the correctly rounded result, the float64 ``sqrt`` of the input
rounded to float32 (on the card; a float64 ``sqrt`` rounded to float32 is
the correctly rounded float32 ``sqrt``: 53 >= 2 x 24 + 2).  One JSON line:
each one's inputs whose result differs, in all, by the input's exponent
field (0: zero and the subnormals) and the first few of the subnormal and
of the normal inputs, with the card's name and power limit.  It imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LAST = 0x7F7FFFFF  # the largest finite float32
CHUNK = 1 << 27
FIRST = 8

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void sqrt_kernel(const float* x, float* y, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i < n) y[i] = sqrtf(x[i]);
}
extern "C" int sqrt_launch(const float* x, float* y, long long n, void* stream) {
  if (n > 0)
    sqrt_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
"""


def build(tmp: Path) -> ctypes.CDLL:
    """The probe's ``sqrtf`` kernel, built with the kernels' flags."""
    sys.path.insert(0, str(ROOT))
    from vulkan_raytracer_tpu_torch.ops import _ext

    src, lib = tmp / "sqrt_probe.cu", tmp / "libsqrt_probe.so"
    src.write_text(SOURCE)
    flags = [f for f in _ext.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_ext._nvcc(), *flags, "-shared", "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.sqrt_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p]
    dll.sqrt_launch.restype = ctypes.c_int
    return dll


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("check_torch_sqrt.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    wrong = {k: {"inputs": 0, "by_exponent": {}, "first_subnormal": [], "first_normal": []}
             for k in ("aten", "sqrtf", "cpu")}
    with tempfile.TemporaryDirectory() as tmp:
        dll = build(Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, LAST + 1, CHUNK):
            hi = min(lo + CHUNK, LAST + 1)
            x = torch.arange(lo, hi, dtype=torch.int32, device="cuda").view(torch.float32)
            want = torch.sqrt(x.double()).float()
            mine = torch.empty_like(x)
            code = dll.sqrt_launch(x.data_ptr(), mine.data_ptr(), x.numel(), stream)
            if code:
                raise RuntimeError(f"sqrt_launch: CUDA error {code}")
            got = {"aten": torch.sqrt(x), "sqrtf": mine}
            got["cpu"] = torch.sqrt(x.cpu()).cuda()
            for k, y in got.items():
                w = wrong[k]
                bad = torch.nonzero(y.view(torch.int32) != want.view(torch.int32)).flatten()
                w["inputs"] += bad.numel()
                exps = torch.bincount(((bad + lo) >> 23).to(torch.int64), minlength=256)
                for e in torch.nonzero(exps).flatten().tolist():
                    w["by_exponent"][e] = w["by_exponent"].get(e, 0) + int(exps[e])
                normal = (bad + lo) >= (1 << 23)
                for name, idx in (("first_subnormal", bad[~normal]), ("first_normal", bad[normal])):
                    for i in idx[:FIRST - len(w[name])].tolist():
                        w[name].append({"x_bits": hex(lo + i), "x": float(x[i]),
                                        "got": float(y[i]), "want": float(want[i])})
        torch.cuda.synchronize()
    line = json.dumps({"inputs": LAST + 1, "wrong": wrong, "nvidia_smi": smi,
                       "torch": torch.__version__, "cuda": torch.version.cuda})
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
