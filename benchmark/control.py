"""The comparison's control: the reference computed in bfloat16, the
precision below the configuration's float32, put in the program's place.

    python3 benchmark/control.py --workload cornell.batch --seeds 11,12,13 [--samples N]

For each seed it renders what a run of the cell compares (the pixels the
seed picks; a batch frame's samples from the seed's first, or a
progressive frame's samples 1..N) in bfloat16 and in float32, and prints
the comparison's number for each.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import camera as cam_math  # noqa: E402
from benchmark import compare  # noqa: E402
from benchmark.harness import seeded  # noqa: E402
from benchmark.reference import pathtracer  # noqa: E402
from benchmark.spec import Spec  # noqa: E402


def reading(spec: Spec, workload: str, seed: int, samples: int, device, dtype) -> float:
    """The comparison's number of the reference in ``dtype`` against the
    reference in float32, for what a run of ``workload`` at ``seed``
    compares."""
    cell = spec.workload(workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    pick = seeded(seed, config, traffic)
    data = spec.scene_builder(config)(**config.get("scene_args", {}))
    w, h, depth = traffic["width"], traffic["height"], traffic["depth"]
    view_inv, proj_inv = cam_math.matrices(pick["position"], pick["direction"], w, h)
    pixels = torch.as_tensor(pick["pixels"], device=device)
    if traffic["mode"] == "batch":
        first, count = pick["first"], traffic["spp"]
    else:
        first, count = 1, samples
    out = []
    for dt in (torch.float32, dtype):
        scene = pathtracer.RefScene(data, device, dt)
        mean = pathtracer.pixel_means(scene, view_inv, proj_inv, w, h, pixels, first, count,
                                      depth)
        out.append(pathtracer.tonemap_u8(mean.float()).cpu().numpy())
    return compare.u8_mean_abs(out[1], out[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--samples", type=int, default=0,
                   help="a progressive frame's samples (what a run's last frame holds)")
    args = p.parse_args(argv)
    spec = Spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        value = reading(spec, args.workload, seed, args.samples, torch.device("cuda"),
                        torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed, "samples": args.samples,
                          "control_u8_mean_abs": value,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
