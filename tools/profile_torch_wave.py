#!/usr/bin/env python3
"""Where one bench wave of the torch port spends its time on a card, with
the wavefront repack and without it.

    python3 tools/profile_torch_wave.py
        [--config cfg1|cfg2|cfg3|cfg4|gltf|textured|instanced|soup|cfg5|alpha_gallery]
        [--reps 3]
        [--out FILE.json]
        [--root DIR]
        [--frames-only]

Run from the root of a checkout on a machine with an NVIDIA card.  It
renders the first wave ``render_image`` runs for a bench configuration:
cfg1, the built-in Cornell box at 512x512, 64 spp, on the dense kernels;
cfg2, the 262,280-triangle dragon at 512x512, 4 spp, on the BVH walks;
gltf, the 147,136-triangle textured .glb of tests/test_bigasset_glb.py
(written by tools/torch_glb_assets.py) at 512x512, 4 spp, on the BVH walks
with the alpha resample loop; textured, the 12-triangle .glb of
tests/test_textured_glb.py at 512x512, 16 spp, on the dense kernels with
the alpha loop; instanced, ``chip_smoke.gallery_scene()`` at 512x512, 4 spp:
64 instances of the 262,144-triangle dragon mesh, a floor and two emissive
panels on the two-level traversal of ``ops/instanced.py``; soup,
``chip_smoke.emitter_soup_scene(100000, 5000, seed=31)`` at 512x512, 4 spp,
cfg1's camera, whose pdf probes walk the emissive BVH; cfg5,
``multi_scene`` at 1920x1080, 8 spp, whose first wave is one band of 64,800
pixels x 8 samples; alpha_gallery, ``chip_smoke.alpha_gallery_scene()``
uploaded instanced at 128x128, 16 spp (MASK and BLEND instances on the
resample loop's encoded ids).  All at depth 4 (cfg5: 8).  The wave is the one the
package's rules pick: a scene on the repacked wavefront whose frame cannot
hold min(spp, 8) samples in one wave starts with a band
(``renderer._banded_preferred``), any other with samples 1.. of every
pixel.  It runs the wave through ``renderer._render_wave`` on up to
four sides: the package as it runs (``device``: the wave one captured
program whose loops run on the card, ``render/graphs.py``, where
``graphs._graphs_preferred`` picks graphs, with the re-sorts and the width
ladder where ``integrator._repack_preferred`` turns them on), the same
program as the host-read replay (``replay``: ``graphs._device_loops_preferred``
patched off, each part launched and each condition read from the host),
with graphs patched off (``eager``), and, on a repacked scene, with the
repack patched off too (``unsorted``):

1. each side once to build the kernels, capture the program and warm the
   allocator (the captures' count, seconds and pool bytes are reported,
   and the graph nodes a launch of the program runs, ``program_nodes``;
   ``--nodes`` stops there);
2. ``--reps`` times each side unprofiled, in turns (device, replay, eager,
   unsorted, unsorted, eager, replay, device, ...): the wall of each,
   CUDA-synchronised, and the radiance, which must be bit-equal between the
   sides, with equal rays, equal launches per kernel (the unsorted side's
   without the re-sort's key and permutation and the wave's tail, one
   launch there and two repacked; on an instanced scene the
   program sides' instance launches that their IF nodes skipped counted in,
   as the eager side launches every instance: ``walks`` has the IFs and
   those skipped per side), equal bounce widths
   and, on an alpha scene (gltf, textured), equal alpha-loop counts;
3. each side once with ``torch.cuda.set_sync_debug_mode("warn")``: the
   host synchronisations of the wave, the harness's included (its
   ``torch.cuda.synchronize()`` after the wave and its read of the ray
   count, which brings the device loops' counts in: 2 a wave, the wave
   itself none), those made while a program launches
   (``host_syncs_in_launches``: 0 through the device loops, the condition
   reads on the replay), and the peak of allocated device memory over that
   run (a program's temporaries lie in the graphs' pool, reserved once:
   ``pool_bytes``);
4. each eager side once recorded: the width and live lanes of each bounce,
   and the live lanes and live 128-lane blocks of each K4'/K5' launch
   (counting them synchronises, so this run is eager and not timed; the
   program sides run the same lanes);
5. each side once under ``torch.profiler`` (CPU + CUDA activities): the
   wall, and from the trace the device kernels (count, summed time, the
   span they cover), the aten ops the host issued, the hand-written
   kernels' launches and device time, each walk launch's device µs in
   issue order (beside step 4's live lanes of the same launch), the
   sorts' device time, and the alpha loop's passes (in all, per call, the
   most in one call).  On the replay, eager and unsorted sides each
   hand-written kernel's launches in the trace must equal the launch
   counters over the same run: on the replay side this is what shows that
   the parts launch what their captures counted.  The device side's trace
   misses most reruns of a conditional body's nodes (CUPTI): each kernel
   counted must appear and
   none more often than counted (``check_device_trace``); its device
   time is the program's own, from CUDA events around its launch in the
   unprofiled reps (``program_ms``), beside the replay side's busy time.

A lone wave synchronises after it, so its wall holds the host's set-up of
the wave in full; a frame's waves, which read nothing back, overlap the
host's set-up of a wave with the card's run of the one before.  So, before
any profiler session, ``--reps`` whole frames of the config
(``render_image``, linear) run on each side in turns too, the unsorted
side aside (without the repack a frame may band otherwise, which sums its
samples in another order) (``frame``: the
wall of each, its waves, the wall per wave, the frame's host
synchronisations, 1 where the frame reads only its result at its end, and
on the device side the programs' device ms from CUDA events around their
launches, over the frame's wall its busy share, and on the program sides
the program launches a frame: one where the frame renders whole, one a
wave where it bands); their images and rays must be equal on every side.
``--frames-only`` times only those frames, on the device side.  Each side
carries a digest of its frame's image (``image_sha256``), which two trees
with bit-equal kernels share.

For instanced it also reports the instance steps (every one launches) and
the live lanes of each ``instanced_closest`` call (one a bounce).
``--root`` imports another checkout's package (e.g. the parent commit
unpacked under ``out/parent``) to time it with this tool.

It prints one JSON object (and writes it to ``--out`` if given).  The device
busy share is kernel time over wall, against the profiled wall (the same
run as the kernel time) and against the median unprofiled wall (the same
wave rerun; profiling slows the host, so this one is the higher share);
the idle share is one minus it.  The wave is deterministic, so every run
traces the same rays.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
#: the port's hand-written kernels, by the names the trace gives them
PORT_KERNELS = ("closest_kernel", "shadow_kernel", "pdf_kernel", "bvh_walk_kernel",
                "treelet_walk_kernel", "emissive_walk_kernel", "shade_hit_kernel",
                "shade_scatter_kernel", "shade_resolve_kernel", "primary_rays_kernel",
                "alpha_commit_kernel", "wave_sum_kernel", "frame_post_kernel",
                "hit_finish_kernel", "instance_step_kernel", "coherence_key_kernel",
                "permute_kernel", "loop_cond_kernel")
#: each launch counter (``LAUNCHES`` of ops/dense.py, ops/traverse.py,
#: ops/shade.py, ops/wave.py, ops/trace.py and render/graphs.py) -> the kernel whose
#: launches it counts, by the name the trace gives it
KERNEL_OF = {"closest": "closest_kernel", "shadow": "shadow_kernel", "pdf": "pdf_kernel",
             "bvh_closest": "bvh_walk_kernel", "bvh_shadow": "bvh_walk_kernel",
             "treelet_closest": "treelet_walk_kernel", "treelet_shadow": "treelet_walk_kernel",
             "emissive_pdf": "emissive_walk_kernel", "hit": "shade_hit_kernel",
             "scatter": "shade_scatter_kernel", "resolve": "shade_resolve_kernel",
             "primary_rays": "primary_rays_kernel", "alpha_commit": "alpha_commit_kernel",
             "wave_sum": "wave_sum_kernel", "frame_post": "frame_post_kernel",
             "hit_finish": "hit_finish_kernel", "instance_step": "instance_step_kernel",
             "coherence_key": "coherence_key_kernel", "permute": "permute_kernel",
             "permute_copy": "permute_kernel",
             "loop_cond": "loop_cond_kernel"}
WALK_BLOCK = 128  # rays per block of the BVH walks (csrc/bvh_walk.cu kThreads)
#: config -> (scene: a built-in name, a generated .glb or a smoke scene,
#: camera position, direction)
CONFIGS = {
    "cfg1": ("cornell", [0.0, 1.0, 2.4], [0.0, 0.0, -1.0]),
    "cfg2": ("dragon", [0.0, 2.2, 4.5], [0.0, -0.25, -1.0]),
    "cfg3": ("chess", [0.0, 4.0, 7.0], [0.0, -0.5, -1.0]),
    "gltf": ("bigasset.glb", [0.0, 1.7, 4.6], [0.0, -0.28, -1.0]),
    "textured": ("textured.glb", [0.0, 0.0, 2.8], [0.0, 0.0, -1.0]),
    "instanced": ("gallery", None, None),  # the camera is chip_smoke.gallery_camera()
    "soup": ("emitter_soup", [0.0, 1.0, 2.4], [0.0, 0.0, -1.0]),
    "cfg5": ("multi", [-9.0, 2.0, 1.5], [1.0, -0.1, -0.15]),
    "alpha_gallery": ("alpha_gallery", [0.0, 0.0, 2.8], [0.0, 0.0, -1.0]),
    "cfg4": ("hall_sky", [-9.0, 1.8, 0.0], [1.0, 0.0, 0.0]),
}
#: config -> (width, height, spp, depth) of its render
FRAMES = {"cfg1": (512, 512, 64, 4), "cfg2": (512, 512, 4, 4), "cfg3": (512, 512, 4, 6),
          "gltf": (512, 512, 4, 4),
          "textured": (512, 512, 16, 4), "instanced": (512, 512, 4, 4),
          "soup": (512, 512, 4, 4), "cfg5": (1920, 1080, 8, 8),
          "alpha_gallery": (128, 128, 16, 4), "cfg4": (960, 540, 8, 4)}


def _scene(name: str):
    from vulkan_raytracer_tpu_torch.cli import BUILTIN_SCENES
    from vulkan_raytracer_tpu_torch.scene import procedural
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Scene

    if name in BUILTIN_SCENES:
        return BUILTIN_SCENES[name]()
    if name == "multi":
        return procedural.multi_scene()
    if name == "hall_sky":  # bench cfg4's scene
        from vulkan_raytracer_tpu_torch import bench

        return bench._hall_sky()
    if name in ("gallery", "emitter_soup", "alpha_gallery"):
        import chip_smoke

        if name == "gallery":
            return chip_smoke.gallery_scene()
        if name == "alpha_gallery":
            return chip_smoke.alpha_gallery_scene()
        return chip_smoke.emitter_soup_scene(100000, 5000, seed=31)
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_glb_assets

    scene = Scene()
    with tempfile.TemporaryDirectory() as tmp:
        if name == "textured.glb":
            scene.load_model(torch_glb_assets.write_textured_glb(tmp))
        else:
            scene.load_model(torch_glb_assets.write_bigasset_glb(tmp, big=True))
    return scene


def first_wave(tables, width: int, height: int, spp: int):
    """The pixel lanes and samples of the first wave ``render_image`` runs
    (start sample 1), and the frame's bands (0 whole)."""
    from vulkan_raytracer_tpu_torch.render import renderer

    order = renderer.block_order(width, height)[0]
    if renderer._banded_preferred(tables, width, height, spp):
        chunk, per, bands = renderer.band_plan(width, height, spp)
        return order[:per], list(range(1, chunk + 1)), bands
    return order, list(range(1, renderer.samples_per_wave(width * height, spp) + 1)), 0


def wave(tables, camera, width: int, height: int, depth: int, lanes, samples):
    """A function that runs the wave (synchronised on a card) and returns
    (radiance, rays)."""
    import torch

    from vulkan_raytracer_tpu_torch.render import graphs, renderer

    view_inv, proj_inv = renderer.camera_uniforms(camera)
    lanes = torch.as_tensor(lanes, device=tables.device)

    def run():
        with torch.inference_mode():
            radiance, rays = renderer._render_wave(tables, view_inv, proj_inv, width, height,
                                                   depth, samples, lanes, "reference")
            if tables.device.type == "cuda":
                torch.cuda.synchronize()
        return radiance, graphs.settle(rays)[0]

    return run


def frame(tables, camera, width: int, height: int, spp: int, depth: int):
    """A function that renders the config's whole frame (``render_image``,
    linear; its one read of the device at its end) and returns (image,
    rays)."""
    from vulkan_raytracer_tpu_torch.render import renderer

    def run():
        return renderer.render_image(tables, camera, width, height, spp, max_depth=depth,
                                     tonemap=False)

    return run


def time_frames(sides: dict, run, reps: int) -> dict:
    """``reps`` frames of ``run`` on each side in turns, then each side's
    host synchronisations of one frame; images and rays must be equal on
    every side."""
    from vulkan_raytracer_tpu_torch.render import renderer

    out = {name: {"wall_s": [], "program_ms": [], "program_launches": []} for name in sides}
    want = None
    for r in range(reps + 1):  # the first turn warms up
        for name in list(sides)[::1 if r % 2 == 0 else -1]:
            _patch(*sides[name])
            _reset()
            with ProgramEvents() as events:
                secs, img, rays = _timed(run)
            if want is None:
                want = (img, rays)
            if not (np.array_equal(img, want[0]) and rays == want[1]):
                raise AssertionError(f"the {name} frame differs from the first one")
            if r:
                out[name]["wall_s"].append(secs)
                out[name]["program_launches"].append(len(events.events))
                if name == "device":
                    out[name]["program_ms"].append(events.ms())
            out[name]["waves"] = renderer.LAST_RENDER["waves"]
            out[name]["image_sha256"] = hashlib.sha256(np.ascontiguousarray(img)).hexdigest()[:16]
    for name, o in out.items():
        _patch(*sides[name])
        o["host_syncs"], o["host_sync_lines"] = count_syncs(run)
        median = statistics.median(o["wall_s"])
        o.update(wall_s_median=median, ms_per_wave=1e3 * median / o["waves"])
        if o["program_ms"]:
            o["busy_share"] = statistics.median(o["program_ms"]) / (1e3 * median)
        else:
            del o["program_ms"]
    return out


def record_bounces(run) -> dict:
    """Run the wave once, eagerly, with the bounce loop and the BVH walks
    wrapped: each bounce's width and live lanes, and each walk launch's
    kind, lanes, live lanes (``t_init >= 0``) and 128-lane blocks with a
    live lane."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import traverse
    from vulkan_raytracer_tpu_torch.render import graphs, integrator

    bounce, walk, preferred = integrator._bounce, traverse._walk, graphs._graphs_preferred
    bounces, walks = [], []

    def recording_bounce(tables, s, b, *args):
        bounces.append({"bounce": b, "width": int(s["active"].shape[0]),
                        "live": int(s["active"].sum())})
        return bounce(tables, s, b, *args)

    def recording_walk(kind, s, rays, t_lo, t_init, shadow):
        live = (t_init >= 0).to(torch.int32)
        blocks = torch.nn.functional.pad(live, (0, -live.shape[0] % WALK_BLOCK))
        blocks = blocks.reshape(-1, WALK_BLOCK).amax(1)
        walks.append({"walk": f"{kind}_{'shadow' if shadow else 'closest'}",
                      "lanes": live.shape[0], "live": int(live.sum()),
                      "live_blocks": int(blocks.sum()), "blocks": blocks.shape[0]})
        return walk(kind, s, rays, t_lo, t_init, shadow)

    try:
        integrator._bounce, traverse._walk = recording_bounce, recording_walk
        graphs._graphs_preferred = lambda tables: False
        run()
    finally:
        integrator._bounce, traverse._walk, graphs._graphs_preferred = bounce, walk, preferred
    return {"bounces": bounces, "walk_launches": walks}


def live_per_closest_call(run) -> list:
    """The live lanes of each ``instanced_closest`` call of one eager run."""
    from vulkan_raytracer_tpu_torch.render import graphs, integrator

    closest, preferred = integrator.instanced_closest, graphs._graphs_preferred
    live = []

    def counting(tables, o, d, *, t_min, t_max, active, **kw):  # kw: a resample pass's raw
        live.append(int(active.sum()))
        return closest(tables, o, d, t_min=t_min, t_max=t_max, active=active, **kw)

    try:
        integrator.instanced_closest = counting  # the name the integrator calls
        graphs._graphs_preferred = lambda tables: False
        run()
    finally:
        integrator.instanced_closest, graphs._graphs_preferred = closest, preferred
    return live


def count_syncs(run) -> tuple:
    """Host synchronisations of one run, from the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``: (count, {"file:line" of the
    Python line that synchronised, its directory's name first: count})."""
    import warnings

    import torch

    # the mode is set outside the recording: the first setting in a process
    # warns once from torch/cuda/__init__.py, which is no synchronisation
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    where: dict[str, int] = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            path = Path(w.filename)
            key = f"{path.parent.name}/{path.name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return sum(where.values()), where


def _timed(run):
    t0 = time.perf_counter()
    radiance, rays = run()
    return time.perf_counter() - t0, radiance, rays


def trace_summary(prof) -> dict:
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
    # K4'/K5' launches in issue order (each one's device µs; the trace may
    # drop a few records), and the device time of the sorts (argsort's
    # radix-sort kernels)
    walks_us = [e - s for name, s, e in kernels
                if "walk_kernel" in name and "emissive" not in name]
    sort_us = sum(e - s for name, s, e in kernels if "sort" in name.lower())
    return {
        "device_events": len(kernels),
        "kernel_ms_sum": sum(e - s for _, s, e in kernels) / 1e3,
        "kernel_ms_busy": busy_us / 1e3,
        "kernel_span_ms": (kernels[-1][2] - kernels[0][1]) / 1e3,
        "port_kernel_ms": {k: us / 1e3 for k, us in port_us.items() if us},
        "port_kernel_launches": {k: n for k, n in port_n.items() if n},
        "walk_launch_us": walks_us,
        "sort_ms": sort_us / 1e3,
        "aten_ops": aten,
        "aten_ops_top_level": aten_top,
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top},
    }


def _by_kernel(counted: dict) -> dict:
    want: dict[str, int] = {}
    for k, n in counted.items():
        if n:
            want[KERNEL_OF[k]] = want.get(KERNEL_OF[k], 0) + n
    return want


def check_traced_launches(trace: dict, counted: dict, label: str) -> dict:
    """Each hand-written kernel's launches in a profiled run's trace against
    the launch counters over the same run (reset just before it).  A
    replayed graph runs no Python: its counts are those its capture took,
    and this is where a replay is seen to launch them.  Returns the traced
    launches; raises where they differ."""
    want = _by_kernel(counted)
    got = trace.get("port_kernel_launches", {})
    if got != want:
        raise AssertionError(f"{label}: the trace launched {got}, the counters say {want}")
    return got


def check_device_trace(trace: dict, counted: dict, label: str) -> dict:
    """The same check on a run through the device loops, whose trace misses
    most reruns of a conditional body's nodes (CUPTI): every kernel counted
    appears, and none more often than counted.  Returns {kernel: [traced,
    counted]}."""
    want = _by_kernel(counted)
    got = trace.get("port_kernel_launches", {})
    if set(got) != set(want) or any(got[k] > want[k] for k in got):
        raise AssertionError(f"{label}: the trace launched {got}, the counters say {want}")
    return {k: [got[k], want[k]] for k in want}


class LaunchSyncs:
    """Host synchronisations while a program launches (``graphs._Program.launch``
    wrapped), within :func:`count_syncs`: those the wave itself makes, none
    on the device loops, the condition reads on the host-read replay.  The
    warnings go on to the outer count."""

    def __enter__(self):
        import warnings

        from vulkan_raytracer_tpu_torch.render import graphs

        self.count = 0
        self._launch = launch = graphs._Program.launch

        def counted(program, device_loops):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                launch(program, device_loops)
            self.count += sum("synchroniz" in str(w.message) for w in caught)
            for w in caught:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)

        graphs._Program.launch = counted
        return self

    def __exit__(self, *exc):
        from vulkan_raytracer_tpu_torch.render import graphs

        graphs._Program.launch = self._launch


class ProgramEvents:
    """CUDA events around each launch of a program through the device loops
    while active (``graphs._Program.launch`` wrapped): ``ms()`` is their
    device time in all; ``events`` holds one entry a launch (None for a
    host-read replay's)."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        import torch

        from vulkan_raytracer_tpu_torch.render import graphs

        self._launch = launch = graphs._Program.launch

        def timed(program, device_loops):
            if not device_loops:
                self.events.append(None)
                return launch(program, device_loops)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            launch(program, device_loops)
            end.record()
            self.events.append((start, end))

        graphs._Program.launch = timed
        return self

    def __exit__(self, *exc):
        from vulkan_raytracer_tpu_torch.render import graphs

        graphs._Program.launch = self._launch

    def ms(self) -> float:
        total = 0.0
        for start, end in filter(None, self.events):
            end.synchronize()
            total += start.elapsed_time(end)
        return total


def _side(walls, prof_s, trace, record) -> dict:
    """One side's numbers: walls, trace, busy share, the recorded run."""
    median = statistics.median(walls)
    out = {"wall_s": walls, "wall_s_median": median, "wall_s_min": min(walls),
           "wall_s_max": max(walls), "profiled_wall_s": prof_s, **trace, **record}
    if trace["device_events"]:
        busy_ms = trace["kernel_ms_busy"]
        out["busy_share_profiled"] = busy_ms / (prof_s * 1e3)
        out["busy_share_unprofiled"] = busy_ms / (median * 1e3)
        out["idle_share_profiled"] = 1.0 - out["busy_share_profiled"]
        out["idle_share_unprofiled"] = 1.0 - out["busy_share_unprofiled"]
        out["wall_us_per_top_level_aten_op"] = (
            median * 1e6 / max(trace["aten_ops_top_level"], 1))
    return out


def _sides(rule) -> dict:
    """side -> (graphs predicate, device-loops predicate, repack predicate)
    patched in for it."""
    from vulkan_raytracer_tpu_torch.render import graphs

    def off(tables):
        return False

    g, loops = graphs._graphs_preferred, graphs._device_loops_preferred
    return {"device": (g, loops, rule), "replay": (g, off, rule), "eager": (off, off, rule),
            "unsorted": (off, off, off)}


def _patch(g, loops, rule) -> None:
    from vulkan_raytracer_tpu_torch.render import graphs, integrator

    graphs._graphs_preferred, graphs._device_loops_preferred = g, loops
    integrator._repack_preferred = rule


#: the re-sort's kernels, which the unsorted side does not launch, and the
#: wave's tail, which a repacked wave launches twice (its scatter, its sum)
#: and the unsorted side once
RESORT = ("coherence_key", "permute", "wave_sum")


def _launches(resort: bool = True) -> dict:
    """The hand-written kernels' launches, which every side shares (the
    unsorted side those of the re-sort apart: ``resort`` False), with the
    instance launches a program's IF nodes skipped counted in, as the eager
    side launches every instance (in a checkout without those IFs, the
    launches alone)."""
    import inspect

    from vulkan_raytracer_tpu_torch.render import integrator

    kw = ({"skipped": True} if "skipped" in inspect.signature(integrator.launch_counts).parameters
          else {})
    return {k: n for d in integrator.launch_counts(loops=False, **kw).values()
            for k, n in d.items() if resort or k not in RESORT}


def _walks() -> dict:
    """The instance launches behind IF nodes since the last reset, and those
    skipped (none in a checkout without those IFs)."""
    from vulkan_raytracer_tpu_torch.render import graphs

    return {"walks": graphs.STATS.get("walks", 0),
            "walks_skipped": graphs.STATS.get("walks_skipped", 0)}


def _widths() -> dict:
    """The bounce widths, which every side but the unsorted one shares."""
    from vulkan_raytracer_tpu_torch.render import integrator

    return dict(integrator.BOUNCE_WIDTHS)


def _counted() -> dict:
    """Each launch counter, ``loop_cond_kernel``'s included."""
    from vulkan_raytracer_tpu_torch.render import integrator

    return {k: n for d in integrator.launch_counts().values() for k, n in d.items()}


def _reset() -> None:
    from vulkan_raytracer_tpu_torch.render import integrator

    integrator.reset_counters()


def _alpha_loop() -> dict:
    from vulkan_raytracer_tpu_torch.render import integrator

    loop = dict(integrator.ALPHA_LOOP)
    loop["passes_per_call"] = loop["iterations"] / loop["calls"] if loop["calls"] else 0.0
    return loop


def program_nodes(cache) -> dict:
    """The device graph nodes one launch of each program in ``cache`` runs,
    from one host-read replay of it (``_Program.interpret``, which keeps the
    rows the tests keep on the card): each part's nodes times the runs of
    its body (a WHILE's ``then`` IF's too, where the checkout has one), and
    the test nodes, each node's entry tests and each WHILE's closing tests
    but a resample loop's whose passes test themselves (a condition with a
    control block ``word``); an instance launch's IF (role ``walk``) has no
    test, its step sets it: ``walk_ifs`` counts its tests, ``walks_skipped``
    those that skipped the launch."""
    from vulkan_raytracer_tpu_torch.render import graphs

    out = []
    for program in cache.graphs.values():
        rows = [[0] * getattr(graphs, "ROW_WORDS", 4) for _ in program.conds]
        program.interpret(program.nodes, rows)

        def parts(nodes, times):
            n = 0
            for node in nodes:
                if isinstance(node, graphs._Part):
                    n += node.graph.nodes() * times
                    continue
                n += parts(node.body, rows[node.row][0])
                then = getattr(node, "then", None)
                if then is not None:
                    n += parts(then.body, rows[then.row][0])
            return n

        tests = walk_ifs = walks_skipped = 0
        for node in program.conds:
            runs, entries = rows[node.row][:2]
            if node.role == "walk":
                walk_ifs += entries
                walks_skipped += entries - runs
                continue
            if node.cond is None:
                continue
            closing = node.kind == "while" and getattr(node.cond, "word", None) is None
            tests += entries + (runs if closing else 0)
        part_nodes = parts(program.nodes, 1)
        out.append({"part_nodes": part_nodes, "test_nodes": tests, "nodes": part_nodes + tests,
                    "walk_ifs": walk_ifs, "walks_skipped": walks_skipped})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="cfg1")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=None)
    p.add_argument("--root", default=str(ROOT), help="the checkout whose package is timed")
    p.add_argument("--nodes", action="store_true",
                   help="only capture the wave's program and count the graph nodes a launch "
                        "runs (program_nodes)")
    p.add_argument("--frames-only", action="store_true",
                   help="only time --reps whole frames on the device side (frame): walls, "
                        "program launches and device ms, busy share, captures and pool bytes")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_wave.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    from vulkan_raytracer_tpu_torch.ops import instanced
    from vulkan_raytracer_tpu_torch.render import graphs, integrator
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    scene, pos, direction = CONFIGS[args.config]
    width, height, spp, depth = FRAMES[args.config]
    if scene == "gallery":
        import chip_smoke

        pos, direction = chip_smoke.gallery_camera()
    tables = _scene(scene).upload("cuda", **({"instancing": True} if scene == "alpha_gallery"
                                              else {}))
    camera = Camera(position=np.array(pos), direction=np.array(direction),
                    aspect=width / height)
    lanes, samples, bands = first_wave(tables, width, height, spp)
    run = wave(tables, camera, width, height, depth, lanes, samples)
    rule = integrator._repack_preferred
    sides = _sides(rule)
    kept = sides["device"]
    if args.frames_only:
        graphs.reset_stats()
        frames = time_frames({"device": kept}, frame(tables, camera, width, height, spp, depth),
                             args.reps)
        cache = graphs.cache(tables)
        line = json.dumps({"config": f"{args.config} frame: {scene} {width}x{height} depth "
                                     f"{depth}, {spp} spp", "root": args.root, "nvidia_smi": smi,
                           "bands": bands, "frame": frames["device"],
                           "captures": {k: graphs.STATS[k] for k in ("captured", "capture_s")},
                           "programs": len(cache.graphs), "pool_bytes": cache.pool_bytes()})
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(line + "\n")
        return 0
    if not rule(tables):
        del sides["unsorted"]
    walls = {name: [] for name in sides}
    program_ms = []  # the device side's program, CUDA-event timed in the unprofiled reps
    radiance, rays, launches, loops, widths, walks = {}, {}, {}, {}, {}, {}
    try:
        graphs.reset_stats()
        for name, patch in sides.items():  # warm up: kernels build, the program captures
            _patch(*patch)
            _reset()
            radiance[name], rays[name] = _timed(run)[1:]
            launches[name], loops[name], widths[name] = _launches(), _alpha_loop(), _widths()
            walks[name] = _walks()
        captures = {**graphs.STATS, "programs": len(graphs.cache(tables).graphs),
                    "pool_bytes": graphs.cache(tables).pool_bytes(),
                    "mirror_bytes": graphs.cache(tables).mirror_bytes(),
                    "graphs_preferred": kept[0](tables),
                    "program_nodes": program_nodes(graphs.cache(tables))}
        if args.nodes:
            line = json.dumps({"config": args.config, "root": args.root, "nvidia_smi": smi,
                               "program_nodes": captures["program_nodes"],
                               "launches": launches["device"], "walks": walks["device"]})
            print(line, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(line + "\n")
            return 0
        for r in range(args.reps):
            for name in list(sides)[::1 if r % 2 == 0 else -1]:
                _patch(*sides[name])
                _reset()
                with ProgramEvents() as events:
                    secs, got, got_rays = _timed(run)
                walls[name].append(secs)
                if name == "device":
                    program_ms.append(events.ms())
                differ = [k for k, same in (
                    ("radiance", torch.equal(got, radiance["device"])),
                    ("rays", got_rays == rays["device"]),
                    ("launches", _launches(name != "unsorted") == {
                        k: n for k, n in launches["device"].items()
                        if name != "unsorted" or k not in RESORT}),
                    ("alpha loop", _alpha_loop() == loops["device"]),
                    ("bounce widths", name == "unsorted" or _widths() == widths["device"]))
                    if not same]
                if differ:
                    raise AssertionError(f"the {name} wave's {differ} differ from the device "
                                         f"one's")
        frames = time_frames({k: v for k, v in sides.items() if k != "unsorted"},
                             frame(tables, camera, width, height, spp, depth), args.reps)
        out_sides = {}
        for name, patch in sides.items():
            _patch(*patch)
            _reset()
            torch.cuda.reset_peak_memory_stats()
            with LaunchSyncs() as inside:
                syncs, sync_lines = count_syncs(run)
            peak = torch.cuda.max_memory_allocated()
            record = record_bounces(run) if name in ("eager", "unsorted") else {}
            _reset()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                prof_s = _timed(run)[0]
            trace = trace_summary(prof)
            label = f"{args.config} {name}"
            if name == "device":
                traced = check_device_trace(trace, _counted(), label)
            else:
                traced = check_traced_launches(trace, _counted(), label)
            out_sides[name] = {**_side(walls[name], prof_s, trace, record),
                               "host_syncs": syncs, "host_sync_lines": sync_lines,
                               "host_syncs_in_launches": inside.count,
                               "peak_allocated_bytes": peak, "traced_launches": traced,
                               "alpha_loop": _alpha_loop(), "frame": frames.get(name)}
            if name == "device":
                out_sides[name].update(program_ms=program_ms,
                                       program_ms_median=statistics.median(program_ms),
                                       loop_cond_launches=graphs.LAUNCHES["loop_cond"])
        if "replay" in out_sides and "kernel_ms_busy" in out_sides["replay"]:
            # the device side's trace misses reruns of its loop bodies: its
            # busy time is the replay's, which runs the same kernels
            busy = out_sides["replay"]["kernel_ms_busy"]
            d = out_sides["device"]
            d["busy_share_unprofiled_from_replay"] = busy / (d["wall_s_median"] * 1e3)
            d["idle_share_unprofiled_from_replay"] = 1.0 - d["busy_share_unprofiled_from_replay"]
    finally:
        _patch(*kept)
    out = {
        "config": f"{args.config} wave: {scene} {width}x{height} depth {depth}, {spp} spp",
        "nvidia_smi": smi, "torch": torch.__version__, "root": args.root,
        "repack_preferred": rule(tables), "bands": bands, "pixels": len(lanes),
        "samples": samples, "lanes": len(lanes) * len(samples), "rays": rays["device"],
        "launches": launches["device"], "captures": captures, "walks": walks,
        "radiance_finite": bool(torch.isfinite(radiance["device"]).all()),
        "radiance_bit_equal": True, "sides": out_sides,
    }
    if tables.inst is not None:
        instanced.reset_stats()
        out["instanced"] = {"instances": tables.inst.num_instances,
                            "live_lanes_per_closest_call": live_per_closest_call(run),
                            **instanced.STATS}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
