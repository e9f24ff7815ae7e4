#!/usr/bin/env python3
"""The frame's tail (``frame_post_kernel``) timed cold on the card.

    python3 tools/bench_torch_frame_post.py [--root DIR] [--out FILE]

Run from the root of a checkout on a machine with an NVIDIA card.  It times
``wave.frame_image`` (a sum over 16 samples in block order, tonemapped
uint8) at 512x512, 960x540 and 1920x1080 and ``wave.frame_progressive``
(sample 5 at the frame's size) at 512x512, each launch after launch on
copies of its inputs spanning four times the L2, captured in one CUDA
graph and timed with CUDA events (``tools/check_torch_trace.py``'s
``_cold_ms``), with its bytes bound (``wave.frame_post_bytes`` at 3.35
TB/s), and, where the package has it, ``empty_kernel`` launched the same
way on the 512x512 image's grid and on one block: the floor one launch
sets.  ``--root DIR`` times the ``vulkan_raytracer_tpu_torch`` package of
another checkout (an earlier commit unpacked under ``out/``), so parent
and change can be timed in turns, each in a fresh process.  It prints one
JSON line with the card's name and power limit (and writes it to
``--out``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3 (NVIDIA's data sheet)
SIZES = ((512, 512), (960, 540), (1920, 1080))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(ROOT), help="the checkout whose package is timed")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_frame_post.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    from check_torch_trace import _cold_ms, _copies

    from vulkan_raytracer_tpu_torch.ops import wave
    from vulkan_raytracer_tpu_torch.render import integrator

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(23)

    def hdr(n):
        return (torch.rand((n, 3), generator=g, device=dev) * 2.0) ** 4

    def timed(fn, call_args, nbytes):
        ms = _cold_ms(fn, _copies(call_args, nbytes))
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        return {"us": 1e3 * ms, "bound_us": 1e3 * bound, "share_of_bound": bound / ms}

    out = {"root": args.root, "nvidia_smi": smi, "image_uint8": {}}
    for w, h in SIZES:
        n = w * h
        out["image_uint8"][f"{w}x{h}"] = timed(
            wave.frame_image, (hdr(n) * 16.0, integrator.block_lanes(w, h, dev), 16, True, True),
            wave.frame_post_bytes(n, 3 * n, progressive=False))
    n = 512 * 512
    out["progressive_512x512"] = timed(
        wave.frame_progressive,
        (hdr(n), hdr(n), torch.tensor([5], device=dev), 512, 512, 512, 512),
        wave.frame_post_bytes(n, 3 * n, progressive=True))
    if hasattr(wave, "empty_launch"):
        blocks = -(-n // wave.SUM_THREADS)  # the 512x512 image's grid: a thread a lane
        out["empty_kernel_us"] = {
            f"{b}_blocks": 1e3 * _cold_ms(lambda k: wave.empty_launch(k, dev), [(b,)] * 2)
            for b in (blocks, 1)}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
