#!/usr/bin/env python3
"""Does what a process did before it renders change how fast it renders?

    python3 tools/bench_torch_process_state.py [--variants fresh,profiler,...]
        [--rounds 1] [--root DIR] [--out FILE.json]

Run from the root of a checkout on a machine with an NVIDIA card.  Each
variant runs in a fresh Python process (one after another, never two at
once) that builds or loads the kernels, does the variant's preparation, and
then renders the port's bench cfg1 (the built-in Cornell box, 512x512, 64 spp)
and cfg5 (the multi-model scene, 1920x1080, 8 spp) the way
``vulkan_raytracer_tpu_torch/bench.py`` does: upload, gate, warm-up, then 3
timed frames of each, in turns cfg1, cfg5, cfg1, ...  The variants:

- ``fresh``: nothing;
- ``phase8``: no cfg1 / cfg5 schedule of its own, but ``bench.run(device,
  reps=1)``, the call ``chip_smoke.py``'s phase 8 makes, alone in a fresh
  process (one frame of each of the five configs);
- ``smoke_phase8``: what ``chip_smoke.py`` does up to and through phase 8
  (its log level, the kernel build and ptxas report, the native builder,
  ``bench_phase`` with its checks), in a fresh process;
- ``profiler``: one ``torch.profiler`` session with CPU and CUDA activities
  over 20 small launches, as ``chip_smoke.device_ms`` opens one;
- ``profiler_teardown``: the same with ``TEARDOWN_CUPTI=1`` in the
  process's environment, which asks the profiler's CUPTI back end to shut
  down after the session;
- ``held``: ``chip_smoke.py``'s phases 3-7 with no profiler (the dense
  kernels against their plain versions, the cfg1 CLI render, the walks
  against theirs and their CUDA-event times, the BVH against the dense
  sweeps, two cfg2 CLI renders), every scene and tensor they made held;
- ``held_empty_cache``: ``held``, then ``torch.cuda.empty_cache()``;
- ``held_gc_freeze`` / ``held_gc_disable``: ``held``, then ``gc.freeze()`` /
  ``gc.disable()``;
- ``smoke``: phases 3-7 as ``chip_smoke.py`` runs them (with their
  profiler sessions), their tensors held.

Each process reports its frames' Mrays/s (best, median, min and max), the
host microseconds per launch of a one-element ``add_`` on the card (best of
3 runs of 2,000 launches, no synchronise between them) before and after the
preparation, the Python objects the collector tracks and the collections it
ran during the frames and their seconds, and the card's name and power limit.
``--root DIR`` imports the package (and its bench) from another checkout,
e.g. the parent commit unpacked under ``out/``, for an A/B in one call.
Prints one JSON line per process and, last, a summary by variant.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("fresh", "phase8", "smoke_phase8", "profiler", "profiler_teardown", "held", "held_empty_cache", "held_gc_freeze",
            "held_gc_disable", "smoke")
REPS = 3
CHILD_TIMEOUT_S = 900


def host_us_per_launch(device, n: int = 2000, runs: int = 3) -> float:
    """Best host microseconds per enqueued one-element ``add_``."""
    import torch

    x = torch.zeros(1, device=device)
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        best = min(best, (time.perf_counter() - t0) * 1e6 / n)
        torch.cuda.synchronize()
    return best


def _profiler_session(device) -> None:
    import torch

    x = torch.zeros(1 << 16, device=device)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(20):
            x.add_(1.0)
        torch.cuda.synchronize()
    prof.events()


def smoke_phases_3_to_7(device, profiled: bool) -> list:
    """``chip_smoke.py``'s phases 3-7 (with their profiler sessions only if
    ``profiled``); returns what they made, to be held."""
    import tempfile

    sys.path += [str(ROOT), str(ROOT / "tools")]  # after --root's package
    import chip_smoke as cs
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch import cli
    from vulkan_raytracer_tpu_torch.scene import procedural
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    cornell = cornell_box_scene().upload(device)
    soup = cs.soup_scene(1000, seed=7).upload(device)
    n = 2 * 512 * 512
    held = [cornell, soup, cs.check_kernels({"cornell": cornell, "soup1000": soup},
                                            (n, n - 37), device)]
    if profiled:
        held += [cs.time_kernels(cornell, n, device), cs.time_cfg1_shadow(cornell)]
    with tempfile.TemporaryDirectory() as out_dir:
        held.append(cli.run(cs.CFG1 + ["--device", "cuda", "--output", f"{out_dir}/cfg1.png"]))
    held.append(procedural.dragon_scene())
    dragon = held[-1].upload(device)
    with tempfile.TemporaryDirectory() as tmp:
        glb = torch_glb_assets.write_bigasset_glb(Path(tmp), big=True)
        bigasset = cs._load_glb(glb, triangles=147136, textures=5)[0].upload(device)
        for label, tables, cam in (("cfg2", dragon, cs.CFG2_CAM),
                                   ("gltf147k", bigasset, cs.BIGASSET_CAM)):
            held.append(cs.check_walks(tables, (n, n - 37), device, label, cam))
            held.append(cs.time_walks(tables, n, device, label, cam))
        if profiled:
            held.append(cs.time_recorded(device, bigasset, Path(tmp)))
    cs.bvh_vs_dense(device)
    held += [cs.render_cfg2(reps=2), dragon, bigasset]
    return held


def child(variant: str) -> dict:
    import torch

    from vulkan_raytracer_tpu_torch import bench

    device = torch.device("cuda", 0)
    if variant in ("phase8", "smoke_phase8"):
        if variant == "phase8":
            others, c1, _ = bench.run(device, reps=1)
            lines = [c.line() for c in (c1, *others)]
        else:
            sys.path += [str(ROOT), str(ROOT / "tools")]
            import chip_smoke as cs

            from vulkan_raytracer_tpu_torch.accel import native
            from vulkan_raytracer_tpu_torch.ops import _ext

            _ext.build()
            _ext.library()
            native.get_lib()
            cs.ptxas_table(_ext.ptxas_report())
            lines = cs.bench_phase(cs.PathLaunches())
        out = {"variant": variant, "device": torch.cuda.get_device_name(0),
               "nvidia_smi": bench.nvidia_smi_line()}
        for line in lines:
            rates = [line["rays"] / t / 1e6 for t in line["times_s"]]
            out[line["metric"][6:10]] = {"mrays_per_s": rates, "best": max(rates),
                                         "median": statistics.median(rates),
                                         "seconds": line["times_s"]}
        return out
    build_s = bench._setup(device)
    before = host_us_per_launch(device)
    t0 = time.perf_counter()
    held = []
    if variant.startswith("profiler"):
        _profiler_session(device)
    elif variant.startswith("held") or variant == "smoke":
        held = smoke_phases_3_to_7(device, profiled=variant == "smoke")
        if variant == "held_empty_cache":
            torch.cuda.empty_cache()
        elif variant == "held_gc_freeze":
            gc.freeze()
        elif variant == "held_gc_disable":
            gc.disable()
    prep_s = time.perf_counter() - t0
    after = host_us_per_launch(device)

    goldens = bench.load_goldens()
    cfg5 = next(c for c in bench.CONFIGS if c["key"].startswith("cfg5"))
    configs = [bench._Cfg(bench.cornell_config(), goldens, device, REPS),
               bench._Cfg(dict(cfg5, reps=REPS), goldens, device, REPS)]
    collections = {"runs": 0, "seconds": 0.0}
    started = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            collections["runs"] += 1
            collections["seconds"] += time.perf_counter() - started.pop()

    tracked = len(gc.get_objects())
    gc.callbacks.append(on_gc)
    try:
        for _ in range(REPS):
            for c in configs:
                c.rep(1)
    finally:
        gc.callbacks.remove(on_gc)
    out = {"variant": variant, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": bench.nvidia_smi_line(), "kernel_build_s": build_s,
           "prepare_s": prep_s, "held_objects": len(held),
           "host_us_per_launch": {"before": before, "after": after},
           "gc": {"tracked_objects": tracked, "frozen": gc.get_freeze_count(),
                  "enabled": gc.isenabled(), **collections}}
    for c in configs:
        rates = [c.rays / t / 1e6 for t in c.times]
        out[c.key[:4]] = {"mrays_per_s": rates, "best": max(rates),
                          "median": statistics.median(rates), "min": min(rates),
                          "max": max(rates), "seconds": c.times, "rays": c.rays,
                          "gate_rmse": c.rmse}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--out", default=None)
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    if args.child:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("bench_torch_process_state.py: CUDA is not available")
        print(json.dumps(child(args.child)), flush=True)
        return 0
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; choose from {VARIANTS}")
    results = []
    for r in range(args.rounds):
        for v in variants if r % 2 == 0 else variants[::-1]:
            env = dict(os.environ, **({"TEARDOWN_CUPTI": "1"} if v == "profiler_teardown"
                                      else {"VKRT_LOG_LEVEL": "WARN"} if v == "smoke_phase8"
                                      else {}))
            try:
                proc = subprocess.run([sys.executable, __file__, "--child", v, "--root",
                                       args.root], capture_output=True, text=True,
                                      timeout=CHILD_TIMEOUT_S, env=env)
            except subprocess.TimeoutExpired as e:
                line = {"variant": v, "error": "timeout", "stderr": str(e.stderr)[-3000:]}
            else:
                line = ({"variant": v, "error": proc.returncode, "stderr": proc.stderr[-3000:]}
                        if proc.returncode else json.loads(proc.stdout.strip().splitlines()[-1]))
            line.update(round=r, root=args.root)
            print(json.dumps(line), flush=True)
            results.append(line)
            if args.out:  # after each process, so a cut run keeps what it measured
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps({"runs": results}, indent=1))
    summary = {}
    for v in variants:
        mine = [x for x in results if x["variant"] == v and "error" not in x]
        if not mine:
            continue
        summary[v] = {cfg: {"best": max(x[cfg]["best"] for x in mine),
                            "medians": [x[cfg]["median"] for x in mine]}
                      for cfg in ("cfg1", "cfg5")}
        summary[v]["host_us_per_launch_after"] = [x["host_us_per_launch"]["after"]
                                                  for x in mine if "host_us_per_launch" in x]
    print(json.dumps({"summary": summary}), flush=True)
    failed = [x["variant"] for x in results if "error" in x]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": results, "summary": summary}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
