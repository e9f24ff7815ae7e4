#!/usr/bin/env python3
"""Where one bench wave of the torch port spends its time on a card.

    python3 tools/profile_torch_wave.py [--config cfg1|cfg2|gltf|textured|instanced] [--reps 3]
                                        [--out FILE.json]

Run from the root of a checkout on a machine with an NVIDIA card.  It
renders one wave of a bench configuration at 512x512, depth 4: samples 1
and 2 of all 262,144 pixels, 524,288 lanes, exactly the first wave
``render_image`` runs (of 32 for cfg1, the built-in Cornell box on the dense
kernels; of 2 for cfg2, the 262,280-triangle dragon on the BVH walks; of 2
for gltf, the 147,136-triangle textured .glb of tests/test_bigasset_glb.py,
written by tools/torch_glb_assets.py, on the BVH walks with the alpha
resample loop; of 8 for textured, the 12-triangle .glb of
tests/test_textured_glb.py at 16 spp, on the dense kernels with the alpha
loop; of 2 for instanced, ``chip_smoke.gallery_scene()``: 64 instances of the
262,144-triangle dragon mesh, a floor and two emissive panels, uploaded
instanced, on the two-level traversal of ``ops/instanced.py``), through
``renderer._render_wave``:

1. once to build the kernels and warm the allocator;
2. ``--reps`` times unprofiled: the wall of each, CUDA-synchronised;
3. once under ``torch.profiler`` (CPU + CUDA activities): the same wave's
   wall, and from its trace the device kernels (count, summed time, the
   span they cover), the aten ops the host issued, the hand-written
   kernels' launches and device time, and the alpha loop's iterations.

For instanced it also reports the instance steps, the steps skipped by the
box test, the live lanes of each ``instanced_closest`` call (one a bounce),
and the same wave's wall with the box test's host synchronisation taken out
(every instance launched), alternating with the walls of step 2.

It prints one JSON object (and writes it to ``--out`` if given).  The device
busy share is kernel time over wall, against the profiled wall (the same
run as the kernel time) and against the median unprofiled wall (the same
wave rerun; profiling slows the host, so this one is the higher share);
the idle share is one minus it.  The wave is deterministic, so every run
traces the same rays.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WIDTH = HEIGHT = 512
DEPTH = 4
SAMPLES = [1, 2]  # the first wave of a 64-spp render_image (start_sample 1)
#: the port's hand-written kernels, by the names the trace gives them
PORT_KERNELS = ("closest_kernel", "shadow_kernel", "pdf_kernel", "bvh_walk_kernel",
                "treelet_walk_kernel")
#: config -> (scene: a built-in name or a generated .glb, camera position, direction)
CONFIGS = {
    "cfg1": ("cornell", [0.0, 1.0, 2.4], [0.0, 0.0, -1.0]),
    "cfg2": ("dragon", [0.0, 2.2, 4.5], [0.0, -0.25, -1.0]),
    "gltf": ("bigasset.glb", [0.0, 1.7, 4.6], [0.0, -0.28, -1.0]),
    "textured": ("textured.glb", [0.0, 0.0, 2.8], [0.0, 0.0, -1.0]),
    "instanced": ("gallery", None, None),  # the camera is chip_smoke.gallery_camera()
}


def _scene(name: str):
    from vulkan_raytracer_tpu_torch.cli import BUILTIN_SCENES
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Scene

    if name in BUILTIN_SCENES:
        return BUILTIN_SCENES[name]()
    if name == "gallery":
        import chip_smoke

        return chip_smoke.gallery_scene()
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_glb_assets

    scene = Scene()
    with tempfile.TemporaryDirectory() as tmp:
        if name == "textured.glb":
            scene.load_model(torch_glb_assets.write_textured_glb(tmp))
        else:
            scene.load_model(torch_glb_assets.write_bigasset_glb(tmp, big=True))
    return scene


def _wave(tables, camera, width: int = WIDTH, height: int = HEIGHT):
    """The first wave of a ``width`` x ``height`` render: a function that
    runs it (synchronised on a card) and returns (radiance, rays)."""
    import torch

    from vulkan_raytracer_tpu_torch.render import renderer

    view_inv, proj_inv = renderer.camera_uniforms(camera)
    lanes = torch.as_tensor(renderer.block_order(width, height)[0], device=tables.device)

    def run():
        with torch.inference_mode():
            radiance, rays = renderer._render_wave(tables, view_inv, proj_inv, width, height,
                                                   DEPTH, SAMPLES, lanes, "reference")
            if tables.device.type == "cuda":
                torch.cuda.synchronize()
        return radiance, int(rays)

    return run


def _instanced_extras(run, reps: int) -> dict:
    """The gallery wave's live lanes per ``instanced_closest`` call, and its
    wall when every instance is launched (no host test of the box mask)
    beside the wall as the package runs it, alternating."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import instanced
    from vulkan_raytracer_tpu_torch.render import integrator

    closest, untouched = integrator.instanced_closest, instanced._untouched
    live = []

    def counting(tables, o, d, *, t_min, t_max, active):
        live.append(int(active.sum()))
        return closest(tables, o, d, t_min=t_min, t_max=t_max, active=active)

    def always(touches):
        instanced.STATS["steps"] += 1
        return False

    try:
        integrator.instanced_closest = counting  # the name the integrator calls
        _, want, _ = _timed(run)
        integrator.instanced_closest = closest
        walls = {"host_test": [], "launch_always": []}
        for _ in range(reps):
            for name, fn in (("host_test", untouched), ("launch_always", always)):
                instanced._untouched = fn
                secs, got, _ = _timed(run)
                walls[name].append(secs)
                if not torch.equal(got, want):
                    raise AssertionError(f"the wave's radiance changed under {name}")
    finally:
        integrator.instanced_closest, instanced._untouched = closest, untouched
    return {"live_lanes_per_closest_call": live, "wall_s": walls,
            "wall_s_median": {k: statistics.median(v) for k, v in walls.items()},
            "radiance_equal": True}


def _timed(run):
    t0 = time.perf_counter()
    radiance, rays = run()
    return time.perf_counter() - t0, radiance, rays


def _trace_summary(prof) -> dict:
    """Device kernels and host aten ops of one profiled run."""
    from torch.autograd import DeviceType

    kernels, aten, aten_top = [], 0, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            kernels.append((evt.name, evt.time_range.start, evt.time_range.end))
        elif evt.name.startswith("aten::"):
            aten += 1
            parent = evt.cpu_parent
            if parent is None or not parent.name.startswith("aten::"):
                aten_top += 1
    if not kernels:
        return {"device_events": 0, "aten_ops": aten, "aten_ops_top_level": aten_top}
    kernels.sort(key=lambda k: k[1])
    busy_us, end = 0.0, float("-inf")
    for _, s, e in kernels:  # union of the kernels' intervals
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name: dict[str, float] = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    port_us = {k: sum(us for name, us in by_name.items() if k in name) for k in PORT_KERNELS}
    port_n = {k: sum(k in name for name, _, _ in kernels) for k in PORT_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device_events": len(kernels),
        "kernel_ms_sum": sum(e - s for _, s, e in kernels) / 1e3,
        "kernel_ms_busy": busy_us / 1e3,
        "kernel_span_ms": (kernels[-1][2] - kernels[0][1]) / 1e3,
        "port_kernel_ms": {k: us / 1e3 for k, us in port_us.items() if us},
        "port_kernel_launches": {k: n for k, n in port_n.items() if n},
        "aten_ops": aten,
        "aten_ops_top_level": aten_top,
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="cfg1")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_wave.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    from vulkan_raytracer_tpu_torch.ops import instanced
    from vulkan_raytracer_tpu_torch.render import integrator
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    scene, pos, direction = CONFIGS[args.config]
    if scene == "gallery":
        import chip_smoke

        pos, direction = chip_smoke.gallery_camera()
    tables = _scene(scene).upload("cuda")
    camera = Camera(position=np.array(pos), direction=np.array(direction),
                    aspect=WIDTH / HEIGHT)
    run = _wave(tables, camera)
    warm_s, _, rays = _timed(run)
    walls = [_timed(run)[0] for _ in range(args.reps)]

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    integrator.reset_alpha_loop()
    instanced.reset_stats()
    with torch.profiler.profile(activities=activities) as prof:
        prof_s, radiance, prof_rays = _timed(run)
    alpha_loop = dict(integrator.ALPHA_LOOP)
    trace = _trace_summary(prof)
    median = statistics.median(walls)
    out = {
        "config": f"{args.config} wave: {scene} 512x512 depth 4, samples 1-2, 524,288 lanes",
        "nvidia_smi": smi, "torch": torch.__version__,
        "rays": rays, "rays_profiled": prof_rays,
        "radiance_finite": bool(torch.isfinite(radiance).all()),
        "warm_wall_s": warm_s, "wall_s": walls, "wall_s_median": median,
        "profiled_wall_s": prof_s, "alpha_loop": alpha_loop, **trace,
    }
    if tables.inst is not None:
        out["instanced"] = {"instances": tables.inst.num_instances, **instanced.STATS,
                            **_instanced_extras(run, args.reps)}
    if trace["device_events"]:
        busy_ms = trace["kernel_ms_busy"]
        out["busy_share_profiled"] = busy_ms / (prof_s * 1e3)
        out["busy_share_unprofiled"] = busy_ms / (median * 1e3)
        out["idle_share_profiled"] = 1.0 - out["busy_share_profiled"]
        out["idle_share_unprofiled"] = 1.0 - out["busy_share_unprofiled"]
        out["wall_us_per_top_level_aten_op"] = (
            median * 1e6 / max(trace["aten_ops_top_level"], 1))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
