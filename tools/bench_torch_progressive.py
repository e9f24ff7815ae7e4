#!/usr/bin/env python3
"""The progressive ``Renderer``'s frame time on the card.

    python3 tools/bench_torch_progressive.py [--root DIR] [--runs 2] [--out FILE]

Run from the root of a checkout on a machine with an NVIDIA card.  It
renders the built-in Cornell box at 512x512, depth 4, through
``renderer.Renderer``: the preview frame and 16 samples, one
``draw_frame`` each, every frame timed from an idle card to its image on
the host.  A first sequence warms up (kernels build, the frame's wave
captures); then ``--runs`` sequences are timed, each on a new ``Renderer``
of the same tables: the median, least and most ms a frame, the rays, and
a digest of the sequence's images and final accumulation (sha256), which
two versions that render alike share.

``--root DIR`` renders with the ``vulkan_raytracer_tpu_torch`` package of
another checkout (for example an unpacked earlier commit), so one call can
time two versions in turns, each in a fresh process.  It prints one JSON
line with the card's name and power limit (and writes it to ``--out`` if
given).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 17  # the preview and 16 samples


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(ROOT),
                   help="checkout whose vulkan_raytracer_tpu_torch package renders")
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_progressive.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    from vulkan_raytracer_tpu_torch.render import renderer
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    tables = cornell_box_scene().upload("cuda")
    out = {"root": args.root, "nvidia_smi": smi, "frames": FRAMES, "runs": []}
    for run in range(args.runs + 1):
        camera = Camera(position=np.array([0.0, 1.0, 2.4]),
                        direction=np.array([0.0, 0.0, -1.0]), aspect=1.0)
        r = renderer.Renderer(tables, camera, 512, 512, 4)
        times, digest = [], hashlib.sha256()
        for _ in range(FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = r.draw_frame()  # returns the image on the host
            times.append(time.perf_counter() - t0)
            digest.update(img.tobytes())
        rays = r.rays_traced
        digest.update(r.accum.cpu().numpy().tobytes())
        if run:  # the first sequence warms up
            out["runs"].append({"ms_median": 1e3 * statistics.median(times),
                                "ms_min": 1e3 * min(times), "ms_max": 1e3 * max(times),
                                "rays": rays, "digest": digest.hexdigest()[:16]})
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
