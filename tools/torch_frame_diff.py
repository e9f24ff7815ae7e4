#!/usr/bin/env python3
"""Whole frames of two versions of the port, compared pixel by pixel.

    python3 tools/torch_frame_diff.py --root DIR --out FILE.npz [--configs cfg1,cfg4,...]
    python3 tools/torch_frame_diff.py --compare A.npz B.npz [--out FILE.json]

Run from the root of a checkout on a machine with an NVIDIA card.  The
first form renders each config of ``tools/profile_torch_wave.py``
(``CONFIGS`` and ``FRAMES``: its scene, camera, size, spp and depth) as one
linear ``render_image`` frame with the ``vulkan_raytracer_tpu_torch``
package of ``--root`` (this checkout's, or an earlier commit unpacked under
``out/``), and writes each frame and its ray count to ``--out``.  The
second compares two such files: for each config the RMSE, the largest
difference, the pixels that differ by more than 1e-6 and whether the rays
are equal, one JSON line each, then a summary line.  Each form prints the
card's name and power limit in its lines.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def render(root: str, configs: list, out: str) -> int:
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_frame_diff.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    import profile_torch_wave as ptw

    from vulkan_raytracer_tpu_torch.render import renderer
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    frames = {}
    for name in configs:
        scene, pos, direction = ptw.CONFIGS[name]
        w, h, spp, depth = ptw.FRAMES[name]
        if scene == "gallery":
            import chip_smoke

            pos, direction = chip_smoke.gallery_camera()
        tables = ptw._scene(scene).upload(
            "cuda", **({"instancing": True} if scene == "alpha_gallery" else {}))
        camera = Camera(position=np.array(pos), direction=np.array(direction))
        img, rays = renderer.render_image(tables, camera, w, h, spp, max_depth=depth,
                                          tonemap=False)
        frames[f"{name}_img"] = img
        frames[f"{name}_rays"] = np.int64(rays)
        print(json.dumps({"config": name, "root": root, "rays": int(rays),
                          "finite": bool(np.isfinite(img).all())}), flush=True)
        del tables
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **frames)
    return 0


def compare(a: str, b: str, out: str | None) -> int:
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    fa, fb = np.load(a), np.load(b)
    lines = []
    for key in sorted(k for k in fa.files if k.endswith("_img")):
        name = key[:-4]
        x, y = fa[key].astype(np.float64), fb[key].astype(np.float64)
        d = np.abs(x - y).max(axis=-1)
        lines.append({"config": name, "rmse": float(np.sqrt(np.mean((x - y) ** 2))),
                      "max_abs": float(d.max()), "differing_pixels": int((d > 1e-6).sum()),
                      "bit_equal": bool(np.array_equal(fa[key], fb[key])),
                      "rays_equal": int(fa[f"{name}_rays"]) == int(fb[f"{name}_rays"]),
                      "nvidia_smi": smi})
    lines.append({"summary": True, "configs": len(lines),
                  "bit_equal": [x["config"] for x in lines if x["bit_equal"]],
                  "max_rmse": max((x["rmse"] for x in lines), default=0.0),
                  "rays_equal": all(x["rays_equal"] for x in lines)})
    text = "\n".join(json.dumps(x) for x in lines)
    print(text, flush=True)
    if out:
        Path(out).write_text(text + "\n")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(ROOT), help="the checkout whose package renders")
    p.add_argument("--configs", default="cfg1,cfg2,cfg4,cfg5,gltf,textured,instanced,soup,"
                                        "alpha_gallery")
    p.add_argument("--out", help="the frames' .npz (render) or the lines' file (compare)")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = p.parse_args(argv)
    if args.compare:
        return compare(*args.compare, args.out)
    return render(args.root, [c for c in args.configs.split(",") if c], args.out)


if __name__ == "__main__":
    sys.exit(main())
