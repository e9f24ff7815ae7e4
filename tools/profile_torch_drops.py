#!/usr/bin/env python3
"""Whether ``torch.profiler``'s trace of a wave holds every launch the
counters count: the trace started just before the run, after a warm-up
step, or with a pause on each side of the run.

    python3 tools/profile_torch_drops.py [--tries 15] [--gap-ms 50] [--out FILE]

Run from the root of a checkout on a machine with an NVIDIA card.

``chip_smoke.py``'s phase 27 holds each hand-written kernel's launches in
the trace of one profiled wave against the launch counters, on the
host-read replay and eager.  This tool repeats that check ``--tries`` times
on phase 9's forced-BVH dragon (32x32, 2 spp, depth 3: ~1 ms) and twice as
many times on cfg1's first wave (~2 ms), each try profiled once in each
mode, in an order that turns from try to try:

- ``plain``: the trace starts just before the run and stops just after it;
- ``warm_up``: one run under the profiler's warm-up step first
  (``torch.profiler.schedule(warmup=1, active=1)``: the tracer on, its
  records left out);
- ``gap``: the card idle for ``--gap-ms`` after the trace starts and again
  before it stops (phase 27's way).

One profiler session runs first, as the smoke's profiled timings do before
phase 27.  One JSON line a try, side and mode (where the trace and the
counters differ, with both, the first kernels of the trace and how long
after the trace's first host event the first kernel starts), then the
count of tries whose trace equals the counters per case, side and mode;
the nvidia-smi line first.  It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def profiled(cs, run, mode: str, gap_s: float):
    """(trace summary, counted launches, the trace's kernels by start, the
    first host event's start) of one profiled ``run``."""
    import time

    import torch
    from profile_torch_wave import trace_summary
    from torch.autograd import DeviceType

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    if mode == "warm_up":
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
            run()
            prof.step()
            cs._reset_launches()
            cs._timed_sync(run)
            prof.step()
    else:
        pause = gap_s if mode == "gap" else 0.0
        cs._reset_launches()
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(pause)
            cs._timed_sync(run)
            time.sleep(pause)
    counted = {k: n for by_module in cs._launch_counts().values() for k, n in by_module.items()}
    events = prof.events()
    kernels = sorted((e.time_range.start, e.name) for e in events
                     if e.device_type == DeviceType.CUDA)
    host0 = min((e.time_range.start for e in events if e.device_type != DeviceType.CUDA),
                default=0)
    return trace_summary(prof), counted, kernels, host0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tries", type=int, default=15)
    p.add_argument("--gap-ms", type=float, default=50.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    os.environ.setdefault("VKRT_LOG_LEVEL", "WARN")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_drops.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from profile_torch_wave import _by_kernel, first_wave, wave

    from vulkan_raytracer_tpu_torch.scene import procedural
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    emit({"nvidia_smi": cs.nvidia_smi_line()})
    device = torch.device("cuda", 0)
    x = torch.ones(1 << 20, device=device)
    cs.device_ms(lambda: x.mul_(1.0), "elementwise", 20)  # a profiler session first
    cases = (("forced-BVH dragon", procedural.dragon_scene(detail=12).upload(
                  device, traversal="bvh"), cs.CFG2_CAM, (32, 32, 2, 3), args.tries),
             ("cfg1", cornell_box_scene().upload(device), cs.CFG1_CAM, (512, 512, 64, 4),
              2 * args.tries))
    modes = ("plain", "warm_up", "gap")
    summary: dict = {}
    for label, tables, cam, (w, h, spp, depth), tries in cases:
        camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]), aspect=w / h)
        lanes, samples, _ = first_wave(tables, w, h, spp)
        run = wave(tables, camera, w, h, depth, lanes, samples)
        for t in range(tries):
            for mode in modes[t % 3:] + modes[:t % 3]:
                for side, ctx in (("replay", cs._loops_on_host), ("eager", cs._eager)):
                    with ctx():
                        run()
                        trace, counted, kernels, host0 = profiled(cs, run, mode,
                                                                  args.gap_ms / 1e3)
                    want, got = _by_kernel(counted), trace.get("port_kernel_launches", {})
                    equal = got == want
                    tally = summary.setdefault(f"{label} {side} {mode}", [0, 0])
                    tally[0] += equal
                    tally[1] += 1
                    line = {"case": label, "side": side, "mode": mode, "try": t,
                            "equal": equal}
                    if not equal:
                        line.update(traced=got, counted=want,
                                    first_kernels=[n[:40] for _, n in kernels[:4]],
                                    first_kernel_after_first_host_event_us=(
                                        kernels[0][0] - host0) if kernels else None)
                    emit(line)
    emit({"equal_of_tries": summary})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
