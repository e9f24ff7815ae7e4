#!/usr/bin/env python3
"""The whole-stream walk (K4') against the treelet walk (K5') on the card.

    python3 tools/bench_torch_walks.py [--rays 524288] [--reps 10] [--out FILE.json]

Run from the root of a checkout on a machine with an NVIDIA card.  For each
of the bench scenes of cfg2-cfg5 (the procedural stand-ins, 98k-262k
triangles) it makes one wave of ``--rays`` rays with ``chip_smoke.bench_wave``
(camera rays of the configuration's camera and bounce-like rays off random
surface points, with per-lane bounds and 20% inactive lanes) and times both
walks, closest hit and occlusion, on the scene's own streams with CUDA events
in turns K4', K5', K5', K4'.  The two walks return the same t on every lane
(they differ only at exact-t ties), so the ratio answers whether a per-ray
walk gains from treelet windows.  It prints one JSON line per scene (and
writes them to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rays", type=int, default=2 * 512 * 512)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_walks.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    device = torch.device("cuda", 0)
    lines = []
    for key, build, cam, _ in cs.bench_configs():
        tables = build().upload(device)
        s = tables.pbvh
        x = cs._walk_inputs(cs.bench_wave(tables, args.rays, seed=7, device=device, cam=cam))
        runs = {
            "closest": (x["t_lo"], x["t_init"], False),
            "shadow": (x["zeros"], x["t_sh"], True),
        }
        out = {"config": key, "nvidia_smi": smi, "rays": args.rays,
               "triangles": tables.num_triangles, "nodes": s.num_nodes,
               "treelets": s.n_treelets}
        for kind, (t_lo, t_init, shadow) in runs.items():
            def k4():
                return tr.bvh_walk(s, x["cols"], t_lo, t_init, shadow)

            def k5():
                return tr.treelet_walk(s, x["cols"], t_lo, t_init, shadow)

            (t4, s4), (t5, s5) = k4(), k5()
            if not torch.equal(t4, t5) or not torch.equal(s4 >= 0, s5 >= 0):
                raise AssertionError(f"{key} {kind}: K4' and K5' disagree")
            a, b, c, d = (cs.time_ms(f, args.reps) for f in (k4, k5, k5, k4))
            out[kind] = {"k4_ms": (a + d) / 2, "k5_ms": (b + c) / 2,
                         "k4_ms_runs": [a, d], "k5_ms_runs": [b, c],
                         "k5_over_k4": (b + c) / (a + d), "hits": int((s4 >= 0).sum())}
        line = json.dumps(out)
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
