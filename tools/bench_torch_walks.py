#!/usr/bin/env python3
"""The whole-stream walk (K4') against the treelet walk (K5') on the card.

    python3 tools/bench_torch_walks.py [--root DIR] [--rays 524288] [--reps 10] [--out FILE]

Run from the root of a checkout on a machine with an NVIDIA card.  For each
of the bench scenes of cfg2-cfg5 (the procedural stand-ins, 98k-262k
triangles) and the 147,136-triangle glTF (``tools/torch_glb_assets.py``), it
makes one wave of ``--rays`` rays with ``chip_smoke.bench_wave`` (camera rays
of the configuration's camera and bounce-like rays off random surface points,
with per-lane bounds and 20% inactive lanes) and times both walks, closest
hit and occlusion, on the scene's own streams with CUDA events in turns K4',
K5', K5', K4'.  The two walks return the same t on every lane (they differ
only at exact-t ties), so the ratio answers whether a per-ray walk gains from
treelet windows.

``--root DIR`` walks with the ``vulkan_raytracer_tpu_torch`` package of
another checkout (for example an unpacked earlier commit) over the same
waves, which this checkout makes; so one call can time two versions of the
kernels in turns.  Each line carries the streams' bytes, the walks' ptxas
figures and a digest of the closest hits (t and triangle) and occlusion
flags, which two versions must share.  At cfg4 (the hall) each walk also
carries the share of its warps' triangle-test slots that test a triangle
for a lane, under the kernels' schedule (``tris / tri_slots`` of
``walk_visits``) and under one whole leaf in the turn of its node (``tris /
tri_slots_in_turn``), counted on the plain walk; a package whose
``walk_visits`` has no ``tri_slots`` gives none.  It prints one JSON line
per scene (and writes them to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GLTF_TRIANGLES = 147136


def _smoke():
    """This checkout's chip_smoke.py, whichever package is imported."""
    spec = importlib.util.spec_from_file_location("_bench_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scenes(cs, tmp: Path):
    """(name, scene builder, camera) of cfg2-cfg5 and the 147k glTF."""
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch import bench

    glb = torch_glb_assets.write_bigasset_glb(tmp, big=True)
    out = [(c["key"], c["build"], c["cam"]) for c in bench.CONFIGS[:-1]]
    out.append(("gltf147k", lambda: cs._load_glb(glb, GLTF_TRIANGLES, 5)[0], cs.BIGASSET_CAM))
    return out


def _digest(tr, tables, wave) -> str:
    """sha256 of the closest hits' t and triangle and the occlusion flags."""
    t, tri, _, _ = tr.bvh_closest(tables, wave["o"], wave["d"], t_min=wave["t_min"],
                                  t_max=wave["t_max"], active=wave["active"])
    occ = tr.bvh_shadow(tables, wave["o"], wave["d"], t_max=wave["t_shadow"],
                        active=wave["active"])
    h = hashlib.sha256()
    for x in (t, tri, occ):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(ROOT),
                   help="checkout whose vulkan_raytracer_tpu_torch package is timed")
    p.add_argument("--rays", type=int, default=2 * 512 * 512)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    pkg_root = Path(args.root).resolve()
    sys.path[:0] = [str(pkg_root), str(ROOT / "tools")]
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_walks.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    cs = _smoke()

    from vulkan_raytracer_tpu_torch.ops import _ext
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    if not Path(tr.__file__).resolve().is_relative_to(pkg_root):
        raise RuntimeError(f"imported {tr.__file__}, not the package under {pkg_root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    ptxas = {k: v for k, v in cs.ptxas_table(_ext.ptxas_report()).items() if "walk" in k}
    device = torch.device("cuda", 0)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        scenes = _scenes(cs, Path(tmp))
        for key, build, cam in scenes:
            tables = build().upload(device)
            s = tables.pbvh
            wave = cs.bench_wave(tables, args.rays, seed=7, device=device, cam=cam)
            x = cs._walk_inputs(wave)
            runs = {
                "closest": (x["t_lo"], x["t_init"], False),
                "shadow": (x["zeros"], x["t_sh"], True),
            }
            stream_bytes = sum(getattr(s, f.name).nbytes for f in dataclasses.fields(s)
                               if isinstance(getattr(s, f.name), torch.Tensor))
            out = {"root": str(pkg_root), "config": key, "nvidia_smi": smi,
                   "rays": args.rays, "triangles": tables.num_triangles,
                   "nodes": s.num_nodes, "treelets": s.n_treelets,
                   "stream_bytes": stream_bytes, "digest": _digest(tr, tables, wave),
                   "ptxas": ptxas}
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
                if key.startswith("cfg4"):
                    for walk, treelets in (("k4", False), ("k5", True)):
                        v = tr.walk_visits(s, x["cols"], t_lo, t_init, shadow, treelets)
                        if "tri_slots" in v:
                            tris = int(v["tris"].sum())
                            out[kind][f"{walk}_tri_slot_share"] = tris / int(v["tri_slots"].sum())
                            out[kind][f"{walk}_tri_slot_share_in_turn"] = (
                                tris / int(v["tri_slots_in_turn"].sum()))
            line = json.dumps(out)
            print(line, flush=True)
            lines.append(line)
            del tables, s, wave, x
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
