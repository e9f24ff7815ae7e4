#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and ends the run with a
nonzero exit code.  They run in the order of their numbers but two: 8
(bench) runs right after 2, and the ``torch.profiler`` timings of 3 and 5
run after 26 and 28-30, with 25 and 27.  A profiler session slows every render that
follows it in the same process (``tools/bench_torch_process_state.py``,
PERF.md §7), so no render phase runs after one but those that compare
sides of one wave in turns.

On the card every wave is one captured program launched once
(``render/graphs.py``), and a frame that renders whole or a progressive
frame is one program with its waves and its tail: its straight code as
CUDA graphs, its bounce loop,
the width ladder's phases and (with alpha: the two glTF containers, the
forced-BVH and the instanced alpha uploads) each resample loop as a
conditional WHILE node whose condition ``loop_cond_kernel``
(``csrc/graph_loops.cu``) sets on the card, its re-sorts as IF nodes; the
host reads nothing inside a wave, and a frame's one read of its ray count
(``graphs.settle``) brings the loops' counts in.  A render phase's line says
how its bounces ran since its counters were reset (``bounces``: "graphs",
"eager", or both where the CPU renders the same frame); phases that record
what a bounce calls run eagerly.

1. device   — CUDA must be available (no CPU fallback); the card's name and
   power limit from nvidia-smi.
2. build    — compile the CUDA kernels from ``vulkan_raytracer_tpu_torch/csrc``
   (one nvcc per source, started together) and the native BVH builder; each
   kernel variant's registers, stack frame and spills from ptxas.  Every
   kernel variant must use no stack and spill nothing.  The CUDA driver's
   and runtime's versions (conditional nodes nest from 12.4 on), and
   torch's ``CUDAGraph(keep_graph=True).raw_cuda_graph``, which the device
   loops need.
3. kernels  — each dense kernel against its plain PyTorch version on the
   card, over the Cornell box and over a 1,000-triangle soup (several
   shared-memory chunks), at bench cfg1's wave of 524,288 rays and at a
   ragged 524,251 (a block partly past the last ray), with t bounds before,
   across, at and beyond the hits, and the pdf at both t_min the render
   uses; the live lanes 80% of the rays, then none, one, 0.1%, 5%, 50% and
   all of them (the sparse shares with one all-live and one all-dead block
   among mixed ones); the pdf exactly +0 on lanes whose gate is 0.  Then
   (after phase 24) the times at the cfg1 wave: each kernel's own device
   time from torch.profiler and the wrapper's host microseconds per call,
   with the bounds.
4. render   — the CLI's headless path for bench cfg1 (Cornell, 512x512,
   depth 4, 64 spp, camera 0,1,2.4 -> 0,0,-1) on ``cuda``; every dense kernel
   must have been launched by it, every bounce at the wave's full width (no
   repack on a dense scene), each shading kernel and the hit's finish once a
   bounce, and the image
   must be finite and lit; the shading's plain versions (and ``eval_hit``, ``sample_material``,
   ``material_bsdf``, ``material_pdf``), the wave kernels' (``camera_rays``,
   ``alpha_test``) and the trace kernels' (``winner_uv``) raise if called
   meanwhile; one primary-ray launch a wave.
5. walks    — both BVH walks (K4' whole-stream, K5' treelet; closest and
   shadow) against their plain versions on the streams of the full cfg2
   dragon (262,280 triangles, 128 treelets) and of the 147,136-triangle glTF
   of phase 12, each at a wave of 524,288 rays of its camera (camera rays
   and bounce-like rays off surface points) and at a ragged 524,251, with
   per-lane bounds, bounds at exactly the hit t and inactive lanes: t and
   slot bit-equal; K4' against K5'; the streams within 25 MB.  Then the
   times at both waves, each with its bound from the visits the plain
   walk counts (``walk_visits``).  Then (after phase 24) one wave each of
   the glTF 147k render and of the textured glb render (samples 1-2,
   524,288 lanes) with every dense sweep call recorded: each recorded K1 and K3 call against
   its plain version (K1 bit-equal; K3 as above), then K3 at the glTF
   launch with the most live lanes (256 emissive triangles) and K1 at the
   first alpha re-launch, each timed on the card with its bound, live lanes
   and plain time.
6. bvh_vs_dense — the BVH walks against the dense kernels on a
   60,000-triangle soup: hit and occlusion flags equal on >= 99.99% of lanes,
   t bit-equal where the triangle agrees.
7. render_cfg2 — the CLI's headless path for bench cfg2 (the dragon, 512x512,
   depth 4, 4 spp, camera 0,2.2,4.5 -> 0,-0.25,-1), twice; each must
   launch K5' (both variants) and K3; seconds, Mrays/s and the upload split.
8. bench    — the port's bench (``vulkan_raytracer_tpu_torch/bench.py``,
   bench.py's five configs at their full frames) with one rep of each: each
   config's gate crop on the card against its committed NumPy-oracle golden
   (``bench_goldens.npz`` for cfg2-cfg5, ``bench_goldens_torch.npz`` for the
   built-in Cornell box of cfg1): RMSE < 2e-3; its warm-up frame, which
   captures every graph the rep replays; one timed frame, which must capture
   no graph, launch K1-K3 (cfg1) or K5' closest, K5' shadow and K3
   (cfg2-cfg5), be lit, trace between one and 3 x (depth + 1) rays a
   sample, and run the bands and waves of ``render_image``'s plan (cfg1 whole in 32 waves; 2, 2, 8 and 32
   bands for cfg2-cfg5).  Every frame's linear accumulation (gate crops,
   warm-up and timed frames) must be finite, and cfg5's two lit.  One
   line per config, cfg1 first, with its Mrays/s, launches, peak memory and
   set-up seconds; then the bench's summary.
9. bvh_forced — a 712-triangle dragon uploaded with ``traversal="bvh"`` (one
   treelet: the whole-stream walk K4'), 32x32, 2 spp, depth 3, on the card
   against the same render on the CPU (the plain versions): RMSE < 2e-3, ray
   counts within 0.1%; it must launch K4' (both variants).
10. cpu     — Cornell 32x32, 2 spp, depth 3 through the port on ``cuda``
   against the same render on the CPU, where the port runs the plain
   versions that tests/test_torch_render.py holds against the JAX renderer
   and its NumPy oracle; per-pixel RMSE < 2e-3, ray counts within 0.1%.
   Every such card-against-CPU frame (phases 9, 10, 10b, 13, 15 and 18) goes
   through ``tools/torch_lane_diff.py``: the pixels that differ by more than
   1e-6, their lanes by class, by first bounce, by field and by the aten op
   the tool names (``cuda`` and ``cpu`` builds of it round differently); a
   lane of class ii (a fault) or one whose result depends on its wave fails
   the phase.
10b. cfg4_parity — the bench's cfg4 (the hall under its HDR sky) at its gate
   crop, 16x16, 2 spp, depth 3, on the card against the CPU as above, and
   each side's RMSE against the crop's committed oracle golden.
11. gltf_dense — the small textured .glb of tests/test_textured_glb.py
   (written jax-free by tools/torch_glb_assets.py: PNG and JPEG textures, a
   normal map, MASK and BLEND alpha, an emissive texture, a sparse
   accessor) through ``Scene.load_model``: 12 triangles, 6 textures (none
   1x1, the JPEG one 8x8), alpha and textures flagged; then the CLI's
   headless path on ``cuda`` at 512x512, depth 4, 16 spp, camera 0,0,2.8 ->
   0,0,-1.  It must launch K1 and K3, run every bounce in a program and
   give a finite, lit image; seconds, Mrays/s and the alpha loop's
   iterations per ``_closest`` call.
12. gltf_bvh — the gallery-class .glb of tests/test_bigasset_glb.py (147,136
   triangles, 9 materials, 5 textures) through ``cli.run`` on ``cuda``, twice
   at 512x512, depth 4, 4 spp, camera 0,1.7,4.6 -> 0,-0.28,-1; each
   must launch K5' closest and K3 and replay every bounce from graphs.
   Load (parse, image decode) and upload (BVH build, streams, copy) seconds
   apart from the render's.
13. gltf_parity — both containers at 32x32, 2 spp, depth 3 on ``cuda``
   against the same render on the CPU, and the small one once more uploaded
   with ``traversal="bvh"`` (K4' closest runs the alpha loop): RMSE < 2e-3,
   ray counts within 0.1%.  tests/test_torch_gltf.py and
   tests/test_torch_alpha.py tie the CPU renders to the JAX renders and the
   NumPy oracle.
14. emissive_walk — the emissive-pdf walk against its plain version on an
   all-emissive 20,000-triangle soup at 524,288 and 524,251 rays with 20% of
   the lanes inactive, at both t_min the render uses: bit-equal on active
   lanes (any lane that differs fails), +0 elsewhere; then its time, the
   plain version's and its bound from the visits the plain walk counts on
   the binary tree.
15. render_emissive_bvh — a soup of 100,000 grey and 5,000 emissive
   triangles (above both the dense cap and ``EMISSIVE_MAX_TRIS``) through
   ``Scene.upload`` and ``render_image`` at 512x512, depth 4, 4 spp: K5'
   carries the rays and the emissive walk every pdf probe, the MIS probe
   (t_min EPS) and the NEE probe (t_min 0) each with live lanes; a finite,
   lit image; every probe launch of the frame, its inputs kept, once more
   against the plain version bit for bit, with its live lanes and its µs;
   then 32x32 on the card against the CPU.
16. (bench cfg5 at its own frame is phase 8's: 32 bands of 64,800 pixels x
   8 samples, a finite and lit linear accumulation.)

17. instanced_parity — a gallery of 8 instances (5 of the cfg2 dragon's
   262,144-triangle mesh, which walk their shared BLAS, a floor and two
   emissive panels, which take the dense sweeps): ``instanced_closest`` /
   ``instanced_shadow`` on ``cuda`` at 524,288 and 524,251 seeded rays with
   dead lanes and per-lane bounds against the same calls on the CPU: ids and
   flags bit-equal, t within rtol 1e-6; the launches of K1, K2 and K5'
   counted.
18. render_instanced — the full gallery: 64 dragon instances with seeded
   rotations and scales, a floor and two emissive panels (16.8 M triangles
   flattened, 262,148 stored); ``Scene.upload(instancing="auto")`` must pick
   instancing by itself.  512x512, depth 4, 4 spp through ``render_image``,
   once to warm up and once timed: seconds, Mrays/s, instance steps (every
   instance of every call launches its kernel: no host test), launches per
   kernel, peak device memory; it must launch K1, K2, K3 and K5' (both
   variants).  Then the same scene at 32x32 on the card against the CPU.
19. instanced_vs_flattened — the dragon x 4 instances uploaded both ways on
   the card (``tools/torch_lane_diff.py check_uploads``): the bounce-0 first
   hits of 128x128 x 32 samples lane by lane (where both hit one triangle, t
   within 512 ulps; another triangle, or a hit on one route only, only at a
   tie or at a crack within 1e-3 of the nearer triangle's edge, cracks at
   most 1e-4 of the lanes), and the 128x128, 32 spp, depth 3 image: RMSE <
   2e-3, which one flipped path cannot cross at 32 spp.
20. refit — one node of the cfg2 dragon scene and one instance of the
   gallery move; ``Scene.refit`` against a fresh ``upload`` on the card: the
   same image (atol 1e-5 flattened, RMSE < 2e-3 instanced) and the seconds
   of each (a refit more than twice as slow as the rebuild fails).  Then
   (``refit_frame``) the 512x512, 4 spp, depth 4 frame right after a refit
   and the one after it, graphs and eager in turns, each turn on a refit of
   its own, after one frame on the tables before the refits: a refit keeps
   the tables' signature, so the graphs side's first frame captures no
   graph, copies the new tables into the cache's mirror once (its device
   seconds and bytes, the mirror's bytes beside the pool's) and must be no
   slower than the eager first frame.  Images bit-equal, and the old
   tables' frame after the turns bit-equal to theirs before; seconds of
   each.  A third case, phase 15's emitter soup with its emissive mesh's
   node moved: each refit's wide emissive table has the tables' shape and
   new boxes, and every side's frames launch the emissive walk.  On the
   gallery, with one instance lifted past the union box first, the graphs
   side's frames re-sort with the refit's union box (``key_box``): it
   differs from the tables', the refit's tables and the cache's mirror hold
   it, equal to the refit's root bounds, and the key kernel over the mirror
   is bit-equal to the plain key over the refit's tables.
21. progressive — the progressive ``Renderer`` on Cornell 512x512, depth 4:
   the preview frame and 16 samples, whose mean must equal
   ``render_image(spp=16)`` within atol 1e-5, each frame one program
   launch (its wave and its ``frame_post_kernel`` tail); ms per frame;
   ``pipeline=True`` gives the same images one call late; then ``cli.run``
   with ``--progressive`` and a ``--checkpoint`` / ``--resume`` pair (8 + 8
   spp equal 16 spp).  Then (``frame_post``) every instance of the kernel
   against its plain version: the headless image in every (tonemap, uint8)
   mode at 30x17, 512x512, 960x540 and 1920x1080, and the progressive
   frame's preview and a later sample at the frame's size and in display
   cells (4x7 of 30x17, 120x160 of 512x512), bit-equal; timed cold (the
   image at the three larger sizes, the progressive frame at 512x512) with
   their bounds, beside an empty kernel launched alike.
22. shard_one — bench cfg1 through ``cli.run`` with ``--shard`` on the mesh
   of the one card: image and rays equal to phase 4's bit for bit; two
   renders of each path in turns (shard, plain, plain, shard), seconds and
   Mrays/s.
23. shard_two — bench cfg2 through ``render_image_sharded`` on two shards of
   the one card (``[cuda:0, cuda:0]``; one wave of 4 samples x 131,072
   pixels each) against ``render_image`` (two bands of 131,072 pixels x 4
   samples, ``renderer._banded_preferred``), in turns: bit-equal (the same
   waves), equal rays; it must launch K5' (both variants) and K3.
24. fleet — two processes started with ``torch.multiprocessing`` in spawn
   mode form a gloo group (meeting at a file); rank 1 doubles a column of its
   tables before ``broadcast_scene_tables``; both render cfg1 through
   ``render_image_multihost`` (one shard each on cuda:0) between barriers.
   Both images equal, and equal phase 4's within rtol 1e-5 / atol 1e-6, with
   its rays; the fleet's wall seconds and Mrays/s beside those of one process
   spawned and warmed up the same way before it (a fleet of one, whose image
   must be phase 4's bit for bit), the card's utilization in each window from
   ``nvidia-smi`` every 100 ms, and the all-gather of one rank's block timed
   alone.  The kernels were built in phase 2, so the ranks only load them.

25. repack — the first wave of the cfg2 render and of the glTF 147k render
   (one band of 131,072 pixels x 4 samples, 524,288 lanes each) through
   ``renderer._render_wave`` with the package's rule, which re-sorts the
   lanes between bounces, re-sorts the NEE rays and steps the width ladder,
   and with ``integrator._repack_preferred`` patched to False, in turns
   (repacked, unsorted, unsorted, repacked): radiance bit-equal and rays
   equal; the width and live lanes of each bounce, the live lanes and live
   128-lane blocks of each K5' launch, and each side's wall, device time
   and K5' device time from ``torch.profiler``.

26. graphs  — ten configs three ways: through the device loops (the
   package), the host-read replay of the same programs
   (``graphs._device_loops_preferred`` patched off: each condition read on
   the host) and eagerly (``graphs._graphs_preferred`` patched off), each
   side warmed up once (the programs capture there), then in turns
   (device, replay, eager, eager, replay, device): bench cfg1's whole frame,
   cfg2's frame, cfg5's first band, the emitter soup, the gallery, the
   progressive ``Renderer`` (preview + 16 frames), and with alpha the glTF
   147k frame (phase 12's), the textured glb frame (phase 11's), the
   forced-BVH textured glb and ``alpha_gallery_scene()`` at 128x128.
   Images bit-equal, equal rays, launches per kernel, bounce widths and
   alpha-loop calls, passes and most passes a call; per side the wall per
   frame and per wave and the host synchronisations
   (``torch.cuda.set_sync_debug_mode("warn")``), in all, a frame (the
   harness's own reads of the progressive run's accumulation and ray count
   aside) and while a program launches: on the device side exactly one a
   frame, its read at its end (the waves' sample numbers, lanes and camera
   are written on the device), and none inside a wave; on the program
   sides one program launch a whole frame (and a progressive frame) and no
   frame tail launched outside a program, one program a wave and one tail
   on a banded frame; the programs the first frame captured and those kept
   (one a wave or frame shape), their capture seconds, their pool's bytes and the mirror's, the
   nodes a bounce's parts hold (``cudaGraphGetNodes``; a resample pass and
   a re-sort apart), and ``loop_cond_kernel``'s launches.
28. shade   — after phase 26, before any profiler session: the three shading
   kernels (``csrc/shade.cu``) against their plain versions on every bounce
   state of the first wave of cfg1-cfg4, glTF 147k, the textured glb, the
   emitter soup, the gallery, the glass sphere under analytic lights and a
   wall of 1,024 materials whose anisotropy rotations span every float32
   magnitude (``tools/check_torch_shade.py``, eager): every lane bit-equal,
   or named by kernel, field, bounce and ulps as class i (<= 4 ulps); a class
   ii lane fails.  Each kernel's first call (bounce 0) on cfg1, cfg2, cfg3,
   glTF 147k and the gallery timed in a captured graph, launch after launch
   on copies of its inputs that exceed the L2 four times over, against its
   plain version, with its bytes bound.
29. wave    — after phase 28: the wave's three kernels (``csrc/wave.cu``) against
   their plain versions on the first wave of cfg1-cfg5, glTF 147k, the
   textured glb, the emitter soup, the gallery and the instanced alpha
   gallery, and bench cfg4's gate crop under its HDR sky
   (``tools/check_torch_wave.py``, eager), and one sample of the whole
   frame of cfg1 and of the repacked cfg2, as the progressive frame and
   ``render_sample`` run it (in pixel order where repacked): the
   primary-ray kernel's initial state, the wave's tail (``wave_sum_kernel``:
   the deferred sky, a repacked wave's scatter, the sum over its samples;
   on every wave with the radiance both asked for and not, each on the same
   inputs, so that every instance of the kernel is held; any lane that
   differs fails), and on the alpha scenes every resample pass's commit and
   count of pending lanes, every lane bit-equal or named by kernel, field
   and ulps as class i; a class ii lane fails.  Each kernel's first call on
   cfg1, cfg2, glTF 147k, the textured glb, cfg4's gate crop and the real
   cfg4 and cfg5 band waves (8 samples) timed in a captured graph on
   copies of its inputs that exceed the L2 four times over (the commit's
   restored and the L2 flushed before each timed replay) against its plain
   version, with its bytes bound; on the glTF 147k and textured glb waves
   every alpha pass timed so, with its pending lanes and bound (the line's
   ``alpha_passes``).  Then the commit on synthetic passes
   (``check_torch_wave.synthetic``): none, one lane, ~1% and every lane
   pending over the alpha gallery instanced, flattened and untextured, at
   1, 1,025 and 524,287 lanes, state and count bit-equal (any differing
   case fails), each share timed at 524,288 lanes.
30. trace   — after phase 29: the four kernels around the traversal launches
   (``csrc/trace.cu``) against their plain versions on the first wave of
   cfg1-cfg5, glTF 147k, the gallery, the textured glb, the emitter soup and
   the instanced alpha gallery (``tools/check_torch_trace.py``, eager):
   every closest hit's finish, every instance step, every re-sort's key and
   every gather, scatter and copy, every lane bit-equal: a lane that differs
   at all fails.  One call of each kernel on cfg1, cfg2, the gallery and
   cfg5 timed in a captured graph, launch after launch on copies of its
   inputs that together exceed the L2 four times over, so that its bytes
   bound at the memory rate holds, against its plain version; the
   permutation also against ``index_select`` over the same columns (its
   ``library_ms``), the key one launch over the box the tables keep; and
   every permutation launch of those waves timed so, by (mode, columns,
   lanes) (the line's ``permute_launches``).  Then the permutation on
   synthetic permutations (``check_torch_trace.synthetic``: identity,
   reversed, 1,024-lane blocks shuffled, random; 1, 3, 1,025, 4,099 and
   524,288 lanes of a wave state's 21 columns; each mode), every column
   bit-equal (any differing case fails), each kind and mode timed at
   524,288 lanes with its spread.  Then (``walk_ifs``) the gallery
   (512x512, 4 spp) and the instanced alpha gallery (128x128, 16 spp),
   whose programs put each instance's launch behind an IF its step sets,
   against the eager mask path in turns: images bit-equal, rays and
   launches (the skipped ones counted in) equal, an IF an instance step,
   some skipped; the walks launched and skipped.
27. graphs_busy — after the profiled timings: one wave each of cfg1, the
   gallery, the emitter soup, phase 9's forced-BVH dragon and the glTF 147k
   under ``torch.profiler`` three ways, counters reset just before, the card
   idle for 50 ms after the trace starts and before it stops (the tracer
   places a launch up to ~0.25 ms early and leaves out what falls before
   its start: ``tools/profile_torch_drops.py``).  On the
   host-read replay (each part a graph launched from the host) and eager
   sides each hand-written kernel's launches in the trace must equal the
   counters': a replayed part runs no Python, so its counts are those its
   capture took, and this is where the parts are seen to launch them, every
   kernel variant over the five waves.  The device side's trace holds
   fewer: CUPTI misses most reruns of a conditional body's nodes; its
   traced launches are reported against the counters, each kernel counted
   must appear, none more often than counted, and its bounces, passes and
   re-sorts must equal the replay's (the same parts run as often).  The busy share (the union of the
   kernels' intervals over the wall) from the replay's trace over each
   side's wall, and the program's own device time (CUDA events around its
   launch); on the glTF wave the alpha loop's passes per call.

Scenes above 65,536 triangles (cfg2, the glTF 147k, the emitter soup, cfg5,
the gallery) run the repacked wavefront in every phase that renders them,
on the card and on the CPU alike; cfg1 and the other dense scenes keep lane
order, and phase 4 checks that every cfg1 bounce ran at the full width.

Then it times ``loop_cond_kernel`` (a WHILE of 1,000 runs of a one-thread
add and of two, on the card and as the host-read replay) and prints the
kernel summary (one JSON object: each kernel's launches
over the paths driven with reset counters, in all and by phase; its time,
its plain version's and its bound at the shape named, with what bounds it;
its ptxas figures; for the walks also their numbers at the glTF wave, for
K1 and K3 at the recorded launches), the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  A bound is the larger of the launch's
operations at the card's float32 peak (67 TFLOP/s) and its bytes at its
memory rate (3.35 TB/s), each input read once and each output written once;
the operations are 54 per triangle test, 27 per box test and 36 more per
pdf hit (its weighted term; 39 in the emissive walk, which divides by the
normal's length), counted on the inputs timed: the dense sweeps
test only live lanes (t_init > t_lo, t_hi > 0, gate != 0), whose ray
columns are the only ones read, and their test stops at det (16
operations) or at u (28) where the full test would reject there.
Neither the script nor the port imports jax or the JAX package; the last
phase checks that.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
_START = time.perf_counter()
RMSE_BAR = 2e-3
EPS = 1e-7
INF = 1e32
DENSE_SRC = "vulkan_raytracer_tpu_torch/csrc/dense_sweep.cu"
BVH_SRC = "vulkan_raytracer_tpu_torch/csrc/bvh_walk.cu"
LOOPS_SRC = "vulkan_raytracer_tpu_torch/csrc/graph_loops.cu"
SHADE_SRC = "vulkan_raytracer_tpu_torch/csrc/shade.cu"
WAVE_SRC = "vulkan_raytracer_tpu_torch/csrc/wave.cu"
TRACE_SRC = "vulkan_raytracer_tpu_torch/csrc/trace.cu"
# name -> (counter module, counter key (or keys, summed), source, TPU kernel it replaces)
KERNELS = {
    "dense_closest": ("dense", "closest", DENSE_SRC,
                      "vulkan_raytracer_tpu/ops/pallas_dense.py:112"),
    "dense_shadow": ("dense", "shadow", DENSE_SRC,
                     "vulkan_raytracer_tpu/ops/pallas_dense.py:144"),
    "dense_emissive_pdf": ("dense", "pdf", DENSE_SRC,
                           "vulkan_raytracer_tpu/ops/pallas_dense.py:318"),
    "bvh_walk_closest": ("traverse", "bvh_closest", BVH_SRC,
                         "vulkan_raytracer_tpu/ops/pallas_bvh.py:425"),
    "bvh_walk_shadow": ("traverse", "bvh_shadow", BVH_SRC,
                        "vulkan_raytracer_tpu/ops/pallas_bvh.py:425"),
    "treelet_walk_closest": ("traverse", "treelet_closest", BVH_SRC,
                             "vulkan_raytracer_tpu/ops/pallas_bvh.py:727"),
    "treelet_walk_shadow": ("traverse", "treelet_shadow", BVH_SRC,
                            "vulkan_raytracer_tpu/ops/pallas_bvh.py:727"),
    # an XLA while_loop in the JAX package, not a Pallas kernel
    "emissive_walk": ("traverse", "emissive_pdf", BVH_SRC,
                      "vulkan_raytracer_tpu/ops/traverse.py:241"),
    # the bounce loop's lax.while_loop (and the ladder's and resample loops'),
    # device-side control flow in the JAX package, not a Pallas kernel
    "loop_cond_kernel": ("graphs", "loop_cond", LOOPS_SRC,
                         "vulkan_raytracer_tpu/render/integrator.py:1069"),
    # the bounce's shading: what XLA fuses of the JAX bounce body
    # (integrator.py:961-1046) between the Pallas calls, not a Pallas kernel
    "shade_hit": ("shade", "hit", SHADE_SRC, "vulkan_raytracer_tpu/render/integrator.py:961"),
    "shade_scatter": ("shade", "scatter", SHADE_SRC,
                      "vulkan_raytracer_tpu/render/integrator.py:961"),
    "shade_resolve": ("shade", "resolve", SHADE_SRC,
                      "vulkan_raytracer_tpu/render/integrator.py:961"),
    # the wave's initial state and an alpha pass's test and commit: what XLA
    # fuses of the JAX wave around the bounce loop and beside the Pallas call
    # of each resample pass, not a Pallas kernel
    "primary_rays": ("wave", "primary_rays", WAVE_SRC,
                     "vulkan_raytracer_tpu/render/integrator.py:403"),
    "alpha_commit": ("wave", "alpha_commit", WAVE_SRC,
                     "vulkan_raytracer_tpu/render/integrator.py:130"),
    # the wave's tail (the deferred sky fetch, the repacked wave's scatter and
    # the sum over its samples) and the frame's post-processing: XLA fusions
    # of the JAX wave and of _frame_step / _postprocess, not Pallas kernels
    "wave_sum": ("wave", "wave_sum", WAVE_SRC, "vulkan_raytracer_tpu/render/integrator.py:1128"),
    "frame_post": ("wave", "frame_post", WAVE_SRC,
                   "vulkan_raytracer_tpu/render/renderer.py:244"),
    # what XLA fuses around the traversal launches, none a Pallas kernel: the
    # closest hit's finish (pallas_closest's (u, v) :282, packet_closest's
    # _slot_to_tri and _winner_uv, the instanced finish), a step of the
    # instance scans (the lax.scan body), the re-sort's key and its gathers
    "hit_finish": ("trace", "hit_finish", TRACE_SRC,
                   "vulkan_raytracer_tpu/ops/pallas_dense.py:282"),
    "instance_step": ("trace", "instance_step", TRACE_SRC,
                      "vulkan_raytracer_tpu/ops/instanced.py:189"),
    "coherence_key": ("trace", "coherence_key", TRACE_SRC,
                      "vulkan_raytracer_tpu/render/integrator.py:316"),
    "permute": ("trace", ("permute", "permute_copy"), TRACE_SRC,
                "vulkan_raytracer_tpu/render/integrator.py:352"),
}
#: the shading phase's configs (tools/check_torch_shade.py); the kernels are
#: timed on the first five
SHADE_CONFIGS = ("cfg1", "cfg2", "cfg3", "gltf147k", "gallery", "cfg4", "textured", "soup",
                 "glass_lights", "wild_aniso")
SHADE_TIMED = ("cfg1", "cfg2", "cfg3", "gltf147k", "gallery")
#: the wave kernels' phase's configs (tools/check_torch_wave.py); the kernels
#: are timed on the first four (the alpha commit on the two with alpha)
WAVE_CONFIGS = ("cfg1", "cfg2", "gltf147k", "textured", "cfg4_gate", "cfg3", "cfg4", "cfg5",
                "soup", "gallery", "alpha_gallery", "cfg1_sample", "cfg2_sample")
WAVE_TIMED = ("cfg1", "cfg2", "gltf147k", "textured", "cfg4_gate", "cfg4", "cfg5")
#: the trace kernels' phase's configs (tools/check_torch_trace.py); the
#: kernels are timed on the first four
TRACE_CONFIGS = ("cfg1", "cfg2", "gallery", "cfg5", "cfg3", "gltf147k", "cfg4", "textured",
                 "soup", "alpha_gallery")
TRACE_TIMED = ("cfg1", "cfg2", "gallery", "cfg5")
CFG1 = ["-m", "cornell", "-r", "512,512", "-b", "4", "--spp", "64",
        "-c", "0,1,2.4", "-d", "0,0,-1"]
CFG2 = ["-m", "dragon", "-r", "512,512", "-b", "4", "--spp", "4",
        "-c", "0,2.2,4.5", "-d", "0,-0.25,-1"]
CFG2_CAM = ([0.0, 2.2, 4.5], [0.0, -0.25, -1.0])
CFG1_CAM = ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0])
TEXTURED_CAM = ([0.0, 0.0, 2.8], [0.0, 0.0, -1.0])  # tests/test_textured_glb.py:245
BIGASSET_CAM = ([0.0, 1.7, 4.6], [0.0, -0.28, -1.0])  # tests/test_bigasset_glb.py:324
# peak rates of one H100 SXM (NVIDIA's data sheet, at the 700 W power limit):
# float32 outside the tensor cores, and the HBM3's bandwidth
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# operations per test, counted from the kernels' arithmetic
MT_OPS = 54  # one Moller-Trumbore test
# the dense sweeps' test (csrc/dense_sweep.cu mt_inside) stops where det is
# near 0, or else where u falls outside [0, 1]
MT_DET_OPS = 16
MT_U_OPS = 28
SLAB_OPS = 27  # one ray-box slab test
PDF_OPS = MT_OPS + 36  # one emissive-pdf hit: the test and its weighted term
WALK_TERM_OPS = 39  # the emissive walk's term: the normal over its length (sqrt, 3 divides)
PROFILE_TRIES = 3  # profiled runs of one launch shape before device_ms gives up
# the card idle this long after a wave's trace starts and before it stops: the
# tracer places a launch up to ~0.25 ms early and leaves out a launch that
# falls before its start (tools/profile_torch_drops.py)
PROFILE_GAP_S = 0.05
# the BVH streams of the cfg2 dragon and of the 147k glTF must fit half the L2
STREAM_BYTES_MAX = 25e6


def _cam_flags(cam):
    return ["-c", ",".join(map(str, cam[0])), "-d", ",".join(map(str, cam[1]))]


GLTF_DENSE = ["-r", "512,512", "-b", "4", "--spp", "16", *_cam_flags(TEXTURED_CAM)]
GLTF_BVH = ["-r", "512,512", "-b", "4", "--spp", "4", *_cam_flags(BIGASSET_CAM)]


def emit(obj) -> None:
    """Print one JSON line; a phase's line also says how many seconds after
    the script's start it was printed."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _START, 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def soup_scene(n_tris: int, seed: int):
    """A random triangle soup in the Cornell volume, every triangle emissive
    (so the pdf table has n_tris rows too)."""
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Material, Scene

    r = np.random.default_rng(seed)
    base = r.uniform([-1.0, 0.0, -1.0], [1.0, 2.0, 1.0], (n_tris, 3)).astype(np.float32)
    offs = r.normal(0.0, 0.15, (n_tris, 2, 3)).astype(np.float32)
    pos = np.concatenate([base, base + offs[:, 0], base + offs[:, 1]], axis=1).reshape(-1, 3)
    nrm = np.cross(offs[:, 0], offs[:, 1])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
    m = Material()
    m.emissive_factor = np.full(3, 2.0, np.float32)
    s = Scene()
    s.add_raw_mesh(pos, np.repeat(nrm, 3, axis=0).astype(np.float32),
                   np.arange(3 * n_tris, dtype=np.uint32), m)
    return s


def emitter_soup_scene(n_tris: int, n_emissive: int, seed: int, spread: float = 0.03):
    """A grey triangle soup in the Cornell volume with ``n_emissive`` small
    emissive triangles among it (two meshes), sparse enough that paths pass
    between the triangles and reach the emitters after a bounce."""
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Material, Scene

    r = np.random.default_rng(seed)
    s = Scene()
    light = Material()
    light.emissive_factor = np.full(3, 4.0, np.float32)
    for n, material in ((n_tris, Material()), (n_emissive, light)):
        base = r.uniform([-1.0, 0.0, -1.0], [1.0, 2.0, 1.0], (n, 3)).astype(np.float32)
        offs = r.normal(0.0, spread, (n, 2, 3)).astype(np.float32)
        pos = np.concatenate([base, base + offs[:, 0], base + offs[:, 1]], axis=1).reshape(-1, 3)
        nrm = np.cross(offs[:, 0], offs[:, 1])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        s.add_raw_mesh(pos, np.repeat(nrm, 3, axis=0).astype(np.float32),
                       np.arange(3 * n, dtype=np.uint32), material)
    return s


#: spacing of the gallery's dragons on their grid
GALLERY_PITCH = 3.0


def gallery_scene(detail: int = 256, n_dragons: int = 64, seed: int = 5):
    """A gallery whose nodes share meshes: ``n_dragons`` instances of the
    cfg2 dragon's mesh (262,144 triangles at ``detail`` 256) on a square grid
    with seeded rotations and scales, a floor, and two instances of one
    emissive panel above.  Flattened it would hold ``n_dragons`` copies of
    the mesh; instanced it stores the mesh once.  Above 65,536 triangles
    (``detail`` >= 130) the dragon is a BLAS group; the floor and the panels
    are dense groups."""
    from vulkan_raytracer_tpu_torch.scene.procedural import dragon_scene
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Material, Primitive, Scene

    source = dragon_scene(detail)
    dragon = source.mesh_pool[0][0]
    grey = Material()
    grey.metallic_factor = 0.0
    grey.roughness_factor = 0.85
    light = Material()
    light.metallic_factor = 0.0
    light.emissive_factor = np.array([12.0, 11.0, 10.0], np.float32)

    def quad(material: int, up: bool) -> Primitive:
        pos = np.array([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]],
                       np.float32)
        idx = np.array([0, 2, 1, 0, 3, 2], np.uint32)  # faces -y; reversed faces +y
        return Primitive(
            positions=pos, normals=np.tile(np.float32([0, 1 if up else -1, 0]), (4, 1)),
            tangents=np.zeros((4, 4), np.float32), uvs=np.zeros((4, 2), np.float32),
            indices=idx[::-1].copy() if up else idx, material=material)

    s = Scene()
    s.materials += [source.materials[dragon.material], grey, light]
    s.mesh_pool.append([Primitive(dragon.positions, dragon.normals, dragon.tangents,
                                  dragon.uvs, dragon.indices, material=0)])
    s.mesh_pool.append([quad(1, up=True)])
    s.mesh_pool.append([quad(2, up=False)])

    def trs(t, ry=0.0, scale=(1.0, 1.0, 1.0)):
        c, sn = np.cos(ry), np.sin(ry)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = (np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
                     @ np.diag(np.asarray(scale, np.float32)))
        m[:3, 3] = t
        return m

    r = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_dragons)))
    extent = (side - 1) * GALLERY_PITCH
    for i in range(n_dragons):
        sc = float(r.uniform(0.7, 1.1))
        x = (i % side - (side - 1) / 2) * GALLERY_PITCH
        s.add_node(s.root, trs((x, 1.45 * 0.85 * sc, -(i // side) * GALLERY_PITCH),
                               ry=float(r.uniform(0.0, 2.0 * np.pi)),
                               scale=(sc, 0.85 * sc, sc)), mesh=0)
    s.add_node(s.root, trs((0.0, 0.0, -extent / 2), scale=(extent + 12.0, 1.0, extent + 12.0)),
               mesh=1)
    for k, ry in enumerate((0.0, 0.5)):
        s.add_node(s.root, trs((0.0, 6.0 + 0.1 * extent, -extent * (0.25 + 0.5 * k)), ry=ry,
                               scale=(0.5 * extent + 3.0, 1.0, 0.2 * extent + 1.5)), mesh=2)
    return s


def alpha_gallery_scene(n_side: int = 4, textured: bool = True):
    """Instances with alpha (tests/test_instancing.py:187-228, grown): an
    ``n_side`` x ``n_side`` grid of one vertical quad whose MASK material
    reads a checkered alpha texture, a row of one BLEND quad (alpha 0.5)
    before it, a backdrop and an emissive panel, every mesh shared.  Upload
    it with ``instancing=True``; its camera is ``TEXTURED_CAM``.  Without
    ``textured`` the scene has no texture and the MASK material's alpha is
    its factor's, 0.3, below its cutoff."""
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Material, Primitive, Scene

    back, mask, blend, light = Material(), Material(), Material(), Material()
    back.metallic_factor = mask.metallic_factor = blend.metallic_factor = 0.0
    mask.alpha_mode, mask.alpha_cutoff = 1, 0.5
    blend.alpha_mode = 2
    blend.base_colour_factor = np.array([0.2, 0.5, 0.9, 0.5], np.float32)
    light.emissive_factor = np.array([8.0, 8.0, 8.0], np.float32)
    s = Scene()
    s.materials += [back, mask, blend, light]
    if textured:
        mask.base_colour_tex = 0
        tex = np.ones((8, 8, 4), np.float32)
        yy, xx = np.mgrid[:8, :8]
        tex[..., 3] = np.where((xx + yy) % 2 == 0, 1.0, 0.1)
        s.textures.append(tex)
    else:
        mask.base_colour_factor = np.array([1.0, 1.0, 1.0, 0.3], np.float32)

    def quad(material: int, vertical: bool) -> Primitive:
        pos = np.array([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5], [-0.5, 0, 0.5]],
                       np.float32)
        normal = np.float32([0, -1, 0])
        if vertical:  # facing +z
            pos[:, [1, 2]] = pos[:, [2, 1]]
            normal = np.float32([0, 0, 1])
        return Primitive(positions=pos, normals=np.tile(normal, (4, 1)),
                         tangents=np.zeros((4, 4), np.float32),
                         uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                         indices=np.array([0, 2, 1, 0, 3, 2], np.uint32), material=material)

    s.mesh_pool += [[quad(1, True)], [quad(2, True)], [quad(0, True)], [quad(3, False)]]

    def at(x, y, z, sx=1.0, sy=1.0):
        m = np.diag(np.float32([sx, sy, 1.0, 1.0]))
        m[:3, 3] = (x, y, z)
        return m

    step = 1.6 / n_side
    for i in range(n_side * n_side):
        x, y = (i % n_side - (n_side - 1) / 2) * step, (i // n_side - (n_side - 1) / 2) * step
        s.add_node(s.root, at(x, y, 0.1 * (i % 3), 0.9 * step, 0.9 * step), mesh=0)
    for k in range(n_side):
        s.add_node(s.root, at((k - (n_side - 1) / 2) * step, 0.0, 0.6, 0.8 * step, 1.8), mesh=1)
    s.add_node(s.root, at(0.0, 0.0, -0.5, 4.0, 4.0), mesh=2)
    s.add_node(s.root, at(0.0, 2.0, 0.5), mesh=3)
    return s


def gallery_camera(n_dragons: int = 64):
    """(position, direction) of a camera overlooking :func:`gallery_scene`."""
    extent = (int(np.ceil(np.sqrt(n_dragons))) - 1) * GALLERY_PITCH
    return [0.0, 0.4 * extent + 4.0, 0.35 * extent + 6.0], [0.0, -0.55, -1.0]


def gallery_rays(n: int, n_dragons: int, seed: int, device):
    """Seeded rays for a gallery: the first half from a shell around it,
    aimed at points inside it, the rest leaving points just above the floor
    into the upper half space; per-lane bounds and 20% dead lanes as in
    :func:`_bounds`, most closest-hit bounds unbounded."""
    import torch

    from vulkan_raytracer_tpu_torch.ops.math3 import V3

    r = np.random.default_rng(seed)
    extent = (int(np.ceil(np.sqrt(n_dragons))) - 1) * GALLERY_PITCH
    centre = np.array([0.0, 1.0, -extent / 2])
    half = extent / 2 + 2.0
    n_shell = n // 2
    ang = r.uniform(0, 2 * np.pi, n_shell)
    o_s = centre + np.stack([(half + 4.0) * np.cos(ang), r.uniform(0.2, 7.0, n_shell),
                             (half + 4.0) * np.sin(ang)], 1)
    d_s = centre + r.uniform(-1.0, 1.0, (n_shell, 3)) * [half, 1.2, half] - o_s
    n_up = n - n_shell
    o_u = centre + r.uniform(-1.0, 1.0, (n_up, 3)) * [half, 0.0, half] + [0.0, -0.95, 0.0]
    d_u = r.normal(size=(n_up, 3))
    d_u[:, 1] = np.abs(d_u[:, 1])
    o = np.concatenate([o_s, o_u]).astype(np.float32)
    d = np.concatenate([d_s, d_u])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    bounds = _bounds(r, n, device)
    unbounded = torch.as_tensor(r.random(n) < 0.6, device=device)
    bounds["t_max"] = torch.where(unbounded, INF, bounds["t_max"] * 10.0).contiguous()
    bounds["t_shadow"] = bounds["t_shadow"] * 5.0
    return dict(o=V3(*(col(o[:, k]) for k in range(3))),
                d=V3(*(col(d[:, k]) for k in range(3))), **bounds)


def _bounds(r, n, device):
    """Per-lane t bounds: t_min EPS or up to 0.5, t_max INF or finite, 20%
    inactive lanes; shadow bounds up to 6."""
    import torch

    kind = r.integers(0, 4, n)
    t_max = np.where(kind == 0, INF, np.where(kind == 1, r.uniform(0.0, 0.3, n),
                                              r.uniform(0.3, 4.0, n))).astype(np.float32)
    t_min = np.where(kind == 3, r.uniform(0.0, 0.5, n), EPS).astype(np.float32)
    t_shadow = r.uniform(0.05, 6.0, n).astype(np.float32)
    active = r.random(n) < 0.8

    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dict(t_min=col(t_min), t_max=col(t_max), t_shadow=col(t_shadow), active=col(active))


def make_rays(n: int, seed: int, device):
    """Random rays inside the Cornell box, with inactive lanes and a mix of
    per-lane t bounds."""
    import torch

    from vulkan_raytracer_tpu_torch.ops.math3 import V3

    r = np.random.default_rng(seed)
    o = r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dict(o=V3(col(o[:, 0]), col(o[:, 1]), col(o[:, 2])),
                d=V3(col(d[:, 0]), col(d[:, 1]), col(d[:, 2])), **_bounds(r, n, device))


def bench_wave(tables, n: int, seed: int, device, cam=CFG2_CAM):
    """A bench-shaped wave of n rays: the first half camera rays of ``cam``
    (cfg2's by default; 512x512, jittered samples), the rest bounce-like rays leaving
    random points on random triangles (1e-3 off the surface, either side)
    in a cosine lobe; per-lane bounds as in :func:`_bounds`, with 60% of
    the closest-hit bounds unbounded."""
    import torch

    from vulkan_raytracer_tpu_torch.ops.math3 import V3
    from vulkan_raytracer_tpu_torch.render.integrator import generate_primary_rays
    from vulkan_raytracer_tpu_torch.render.renderer import camera_uniforms
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    r = np.random.default_rng(seed)
    n_cam = n // 2
    view_inv, proj_inv = camera_uniforms(
        Camera(position=np.array(cam[0]), direction=np.array(cam[1])))
    lanes = torch.arange(n_cam, device=device)
    o_c, d_c, _ = generate_primary_rays(view_inv, proj_inv, 512, 512,
                                        1 + lanes // (512 * 512), lanes % (512 * 512),
                                        device=device)

    n_b = n - n_cam
    v0, v1, v2 = (np.stack([c.cpu().numpy() for c in v], 1)
                  for v in (tables.v0, tables.v1, tables.v2))
    tri = r.integers(0, v0.shape[0], n_b)
    a, b = r.random(n_b), r.random(n_b)
    fold = a + b > 1.0
    a, b = np.where(fold, 1.0 - a, a), np.where(fold, 1.0 - b, b)
    e1, e2 = v1[tri] - v0[tri], v2[tri] - v0[tri]
    p = v0[tri] + a[:, None] * e1 + b[:, None] * e2
    nrm = np.cross(e1, e2)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    nrm *= np.where(r.random(n_b) < 0.5, 1.0, -1.0)[:, None]
    tang = np.cross(nrm, [0.577, 0.577, 0.577])
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-20)
    bit = np.cross(nrm, tang)
    u1, phi = r.random(n_b), 2.0 * np.pi * r.random(n_b)
    d = (np.sqrt(u1) * np.cos(phi))[:, None] * tang + (np.sqrt(u1) * np.sin(phi))[:, None] * bit \
        + np.sqrt(1.0 - u1)[:, None] * nrm
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)
    o = (p + 1e-3 * nrm).astype(np.float32)
    d = d.astype(np.float32)

    def col(x, y):
        return torch.cat([x, torch.as_tensor(np.ascontiguousarray(y), device=device)])

    bounds = _bounds(r, n, device)
    # as in a render, most closest-hit lanes are unbounded
    unbounded = torch.as_tensor(r.random(n) < 0.6, device=device)
    bounds["t_max"] = torch.where(unbounded, INF, bounds["t_max"]).contiguous()
    return dict(o=V3(*(col(c, o[:, k]) for k, c in enumerate(o_c))),
                d=V3(*(col(c, d[:, k]) for k, c in enumerate(d_c))), **bounds)


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take for a launch: the larger of its
    operations at the float32 peak and its bytes (each input read once, each
    output written once) at the memory rate, and which of the two it is."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": float(ops), "bytes": float(nbytes)}


def time_ms(fn, reps: int, warm: bool = True) -> float:
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name: str, reps: int) -> tuple:
    """A kernel's own device time per launch, from torch.profiler: ``fn``,
    warmed once, runs ``reps`` times in the profiled window and launches one
    kernel whose name in the trace holds ``name`` per call.  Returns (the
    mean ms over the launches the trace holds, how many it holds).  The
    tracer may drop a few records of a run of short launches; a trace that
    holds fewer than half of them is taken again, up to
    :data:`PROFILE_TRIES` times."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        if len(spans) > reps:
            raise AssertionError(f"the profiler saw {len(spans)} launches of {name}, "
                                 f"more than the {reps} made")
        if 2 * len(spans) >= reps:
            return sum(spans) / len(spans) / 1e3, len(spans)
    raise AssertionError(f"the profiler saw {len(spans)} of {reps} launches of {name}")


def host_us(fn, reps: int) -> float:
    """Host microseconds per call of ``fn``, its launches enqueued with no
    synchronise between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


#: live shares of the sparse-launch checks ("one": a single live lane)
LIVE_SHARES = (0.0, "one", 0.001, 0.05, 0.5, 1.0)


def live_mask(n: int, share, seed: int) -> np.ndarray:
    """Live lanes of a sparse launch: none, all, a single lane (``"one"``) or
    a random share; a random share has block 3 (lanes 768-1023, one block of
    the dense kernels' 256 threads) all live and block 4 all dead among
    mixed blocks."""
    r = np.random.default_rng(seed)
    if share == "one":
        live = np.zeros(n, bool)
        live[r.integers(n)] = True
        return live
    live = r.random(n) < share
    if 0.0 < share < 1.0:
        live[768:1024] = True
        live[1024:1280] = False
    return live


def check_kernels(tables_by_name, ray_counts, device) -> dict:
    """Dense kernel vs plain version on the card, for every table and ray
    count, with the rays' own 80% of active lanes and then each of
    :data:`LIVE_SHARES`; returns the largest absolute error measured per
    kernel.  Tri ids, occlusion flags and t/u/v must be bit-equal; the pdf,
    at both t_min the render uses (EPS and 0.0), within rtol 1e-5 / atol
    1e-7 on lanes whose gate is 1 and exactly +0 where it is 0."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense, trace

    err = {k: 0.0 for k in ("dense_closest", "dense_shadow", "dense_emissive_pdf")}
    seed = 0
    for name, tables in tables_by_name.items():
        table, ptable = tables.tri_table, tables.em_table
        for n_rays in ray_counts:
            seed += 1
            rays = make_rays(n_rays, seed=seed, device=device)
            cols = dense.ray_columns(rays["o"], rays["d"])
            t_lo = rays["t_min"].contiguous()
            shares = {}
            for share in ("80%", *LIVE_SHARES):
                active = rays["active"] if share == "80%" else torch.as_tensor(
                    live_mask(n_rays, share, seed), device=device)
                where = f"{name}, {n_rays} rays, live {share}"
                t_init = torch.where(active, rays["t_max"], 0.0).contiguous()

                # closest hit: ids, t and the recomputed (u, v)
                t_k, tri_k = dense.closest_sweep(table, cols, t_lo, t_init)
                t_p, tri_p = dense.closest_sweep_reference(table, cols, t_lo, t_init)
                # lanes bounded at exactly their hit t must still hit (the replace rule)
                t_tie = torch.where(tri_p >= 0, t_p, t_init).contiguous()
                t_k2, tri_k2 = dense.closest_sweep(table, cols, t_lo, t_tie)
                t_p2, tri_p2 = dense.closest_sweep_reference(table, cols, t_lo, t_tie)
                uk, vk = trace.winner_uv(tables, rays["o"], rays["d"], tri_k)
                up, vp = trace.winner_uv(tables, rays["o"], rays["d"], tri_p)
                closest_err = max(_max_abs(t_k, t_p), _max_abs(t_k2, t_p2),
                                  _max_abs(uk, up), _max_abs(vk, vp))
                bad_ids = int((tri_k != tri_p).sum()) + int((tri_k2 != tri_p2).sum())
                err["dense_closest"] = max(err["dense_closest"], closest_err)
                if bad_ids or closest_err != 0.0:
                    raise AssertionError(f"{where}: closest differs on {bad_ids} ids, "
                                         f"max abs t/u/v error {closest_err}")
                if not torch.equal(tri_k2, tri_p):
                    raise AssertionError(f"{where}: a hit at exactly t_init was dropped")
                dead = ~(t_init > t_lo)
                if not (torch.equal(t_k[dead], t_init[dead]) and bool((tri_k[dead] < 0).all())):
                    raise AssertionError(f"{where}: a dead closest lane did not keep t_init, -1")

                # occlusion: flags bit-equal
                t_hi = torch.where(active, rays["t_max"], 0.0).contiguous()
                occ_k = dense.shadow_sweep(table, cols, t_hi)
                occ_p = dense.shadow_sweep_reference(table, cols, t_hi)
                shadow_err = _max_abs(occ_k, occ_p)
                err["dense_shadow"] = max(err["dense_shadow"], shadow_err)
                if shadow_err != 0.0:
                    bad = int((occ_k != occ_p).sum())
                    raise AssertionError(f"{where}: occlusion differs on {bad} lanes")
                if bool(occ_k[~active].any()):
                    raise AssertionError(f"{where}: an inactive lane is occluded")

                # emissive pdf: rtol 1e-5, atol 1e-7 on gated lanes (rsqrtf vs
                # torch.rsqrt, sum order); +0 where the gate is 0
                gate = torch.where(active, 1.0, 0.0).contiguous()
                pdf_err = {}
                for t_min in (EPS, 0.0):
                    pdf_k = dense.pdf_sweep(ptable, cols, gate, t_min)
                    pdf_p = dense.pdf_sweep_reference(ptable, cols, gate, t_min)
                    pdf_err[t_min] = _max_abs(pdf_k[active], pdf_p[active])
                    err["dense_emissive_pdf"] = max(err["dense_emissive_pdf"], pdf_err[t_min])
                    torch.testing.assert_close(pdf_k[active], pdf_p[active], rtol=1e-5, atol=1e-7)
                    off = pdf_k[~active]
                    if bool((off != 0.0).any() or torch.signbit(off).any()):
                        raise AssertionError(f"{where}: the pdf is not +0 where the gate is 0")
                shares[str(share)] = {
                    "live": int(active.sum()), "hits": int((tri_k >= 0).sum()),
                    "occluded": int(occ_k.sum()), "pdf_lanes": int((pdf_k > 0).sum()),
                    "closest_max_abs_err": closest_err, "shadow_max_abs_err": shadow_err,
                    "pdf_max_abs_err_t_min_eps": pdf_err[EPS],
                    "pdf_max_abs_err_t_min_0": pdf_err[0.0]}
            emit({"phase": "kernels", "table": name, "triangles": table.shape[1],
                  "emissive": ptable.shape[1], "rays": n_rays, "by_live_share": shares})
    return err


#: the sweep function of each dense kernel in ops/dense.py
DENSE_SWEEPS = {"dense_closest": "closest_sweep", "dense_shadow": "shadow_sweep",
                "dense_emissive_pdf": "pdf_sweep"}


def mt_ops(rows, rays):
    """The operations each test of the dense sweeps' Moller-Trumbore needs
    (csrc/dense_sweep.cu ``mt_inside``), for (9, C, 1) triangle rows x (N,)
    rays: :data:`MT_DET_OPS` where det is near 0, :data:`MT_U_OPS` where u
    then falls outside [0, 1] (or is NaN), else :data:`MT_OPS`.  det is
    formed in the kernel's operation order.  Returns (ops (C, N), inside,
    t)."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    inside, u, _, t = dense._mt_chunk(rows, rays)
    dx, dy, dz = (r[None, :] for r in rays[3:])
    e1x, e1y, e1z, e2x, e2y, e2z = rows[3:9]
    det = e1x * (dy * e2z - dz * e2y) + e1y * (dz * e2x - dx * e2z) + e1z * (dx * e2y - dy * e2x)
    ops = torch.where((u >= 0.0) & (u <= 1.0), MT_OPS, MT_U_OPS)
    return torch.where(det.abs() < 1e-12, MT_DET_OPS, ops), inside, t


def sweep_work(kernel: str, args) -> dict:
    """Live lanes of one dense sweep call (``args`` as the sweep takes them)
    and the bound of the work its inputs need: each live lane tests every
    triangle (closest, pdf) or the triangles up to its first hit
    (occlusion), each test with the operations it needs (:func:`mt_ops`),
    and a pdf hit adds its weighted term; bytes are the live lanes' ray
    columns, every lane's bound or gate and outputs, and the table."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    table, rays = args[0], args[1]
    n, n_t = rays[0].shape[0], table.shape[1]
    if kernel == "dense_closest":
        live = args[3] > args[2]
    elif kernel == "dense_shadow":
        live = args[2] > 0.0
    else:
        live = args[2] != 0.0
    idx = torch.nonzero(live).squeeze(1)
    sub = [c[idx] for c in rays]
    n_live = idx.numel()
    hi = args[2][idx][None, :]  # the occlusion sweep's t_hi
    ops, hits = 0, 0
    done = torch.zeros(n_live, dtype=torch.bool, device=idx.device)
    for _, rows in dense._chunks(table):
        test_ops, inside, t = mt_ops(rows, sub)
        if kernel == "dense_shadow":
            occ = (inside & (t > 0.0) & (t <= hi)).int()
            # a lane's tests up to and including its first hit
            ops += int(test_ops[~done[None, :] & (occ.cumsum(0) - occ == 0)].sum())
            done |= occ.bool().any(0)
        else:
            ops += int(test_ops.sum())
        if kernel == "dense_emissive_pdf":
            hits += int((inside & (t > args[3])).sum())
    ops += (PDF_OPS - MT_OPS) * hits
    out = {"rays": n, "triangles": n_t, "live": n_live}
    if kernel == "dense_closest":
        return {**out, **bound(ops, 16 * n + 24 * n_live + 36 * n_t)}
    if kernel == "dense_shadow":
        return {**out, **bound(ops, 8 * n + 24 * n_live + 36 * n_t)}
    return {**out, "pdf_hits": hits, **bound(ops, 8 * n + 24 * n_live + 80 * n_t)}


def time_launch(kernel: str, args, shape: str, reps: int = 50, plain_reps: int = 10) -> dict:
    """One dense sweep call on the card, in turns plain, kernel, kernel,
    plain: the kernel's own device time (two profiled runs of ``reps``
    launches), the plain version's (CUDA events); then the wrapper's host
    microseconds per call, and the launch's live lanes and bound."""
    from vulkan_raytracer_tpu_torch.ops import dense

    sweep = getattr(dense, DENSE_SWEEPS[kernel])
    plain = getattr(dense, DENSE_SWEEPS[kernel] + "_reference")
    trace = next(k for k, v in _ENTRIES.items() if v == kernel)

    def run():
        return sweep(*args)

    def ref():
        return plain(*args)

    p1 = time_ms(ref, plain_reps)
    (k1, n1), (k2, n2) = device_ms(run, trace, reps), device_ms(run, trace, reps)
    p2 = time_ms(ref, plain_reps)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "ms_runs": [k1, k2],
            "launches_traced": [n1, n2], "launches_per_run": reps,
            "plain_ms_runs": [p1, p2], "host_us_per_call": host_us(run, reps),
            "shape": shape, **sweep_work(kernel, args)}


def cfg1_launches(tables, n: int, device) -> list:
    """The three dense sweep calls of a synthetic wave at bench cfg1's launch
    shape, as (kernel, args): n random rays in the Cornell box, 80% of them
    active, over its tables."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    rays = make_rays(n, seed=99, device=device)
    cols = dense.ray_columns(rays["o"], rays["d"])
    active = rays["active"]
    t_lo = torch.full((n,), EPS, dtype=torch.float32, device=device)
    t_init = torch.where(active, INF, 0.0).to(torch.float32).contiguous()
    t_hi = torch.where(active, rays["t_max"], 0.0).contiguous()
    gate = torch.where(active, 1.0, 0.0).to(torch.float32).contiguous()
    return [("dense_closest", (tables.tri_table, cols, t_lo, t_init)),
            ("dense_shadow", (tables.tri_table, cols, t_hi)),
            ("dense_emissive_pdf", (tables.em_table, cols, gate, EPS))]


def time_kernels(tables, n: int, device) -> dict:
    """Each dense kernel at bench cfg1's launch shape (:func:`cfg1_launches`,
    :func:`time_launch`)."""
    shape = (f"cfg1 wave: {n} rays over {tables.tri_table.shape[1]} triangles, "
             f"{tables.em_table.shape[1]} emissive")
    out = {name: time_launch(name, args, shape) for name, args in cfg1_launches(tables, n, device)}
    emit({"phase": "kernel_times", "rays": n, "triangles": tables.tri_table.shape[1], **out})
    return out


@contextlib.contextmanager
def _loops_on_host():
    """Programs run as the host-read replay inside
    (``graphs._device_loops_preferred`` patched to False): each part's
    graph launched from the host, each loop's condition read on the host."""
    from vulkan_raytracer_tpu_torch.render import graphs

    preferred = graphs._device_loops_preferred
    graphs._device_loops_preferred = lambda tables: False
    try:
        yield
    finally:
        graphs._device_loops_preferred = preferred


@contextlib.contextmanager
def _plain_shading_forbidden():
    """Inside, any call of the shading's plain versions, or of the torch
    functions they are made of (``eval_hit``, ``sample_material``,
    ``material_bsdf``, ``material_pdf``), or of the wave kernels' plain
    versions (``camera_rays``, ``alpha_test``), or of the trace kernels'
    (``winner_uv``) raises: on the card a wave starts, finishes its hits,
    shades and commits its alpha passes through its kernels only."""
    from vulkan_raytracer_tpu_torch.ops import shade, trace, wave

    names = {shade: ("shade_hit_reference", "shade_scatter_reference",
                     "shade_resolve_reference", "eval_hit", "sample_material", "material_bsdf",
                     "material_pdf"),
             wave: ("primary_rays_reference", "camera_rays", "alpha_commit_reference",
                    "alpha_pass_reference", "alpha_test"),
             trace: ("hit_finish_reference", "winner_uv", "instance_step_reference",
                     "coherence_key_reference", "permute_reference")}
    saved = {(mod, name): getattr(mod, name) for mod, ns in names.items() for name in ns}

    def forbidden(name):
        def call(*args, **kwargs):
            raise AssertionError(f"the card's wave called a plain version: {name}")
        return call

    for mod, name in saved:
        setattr(mod, name, forbidden(name))
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


@contextlib.contextmanager
def _eager():
    """Bounces run eagerly inside (``graphs._graphs_preferred`` patched to
    False): a recorder that wraps a function the bounce calls would see a
    replayed graph's calls only while it is captured."""
    from vulkan_raytracer_tpu_torch.render import graphs

    preferred = graphs._graphs_preferred
    graphs._graphs_preferred = lambda tables: False
    try:
        yield
    finally:
        graphs._graphs_preferred = preferred


def record_dense_launches(run):
    """Call ``run()``, eagerly, with ops/dense.py's three sweeps wrapped so
    that every call's arguments and result are kept (tensors cloned).
    Returns the calls in order, as (kernel, args, result), and each kernel's
    launches counted meanwhile."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    def keep(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return tuple(keep(y) for y in x) if isinstance(x, tuple) else x

    saved = {k: getattr(dense, f) for k, f in DENSE_SWEEPS.items()}
    calls = []

    def recording(kernel, sweep):
        def call(*args):
            kept = keep(args)
            out = sweep(*args)
            calls.append((kernel, kept, keep(out)))
            return out
        return call

    before = {k: dense.LAUNCHES[KERNELS[k][1]] for k in DENSE_SWEEPS}
    try:
        for k, f in DENSE_SWEEPS.items():
            setattr(dense, f, recording(k, saved[k]))
        with _eager():
            run()
    finally:
        for k, f in DENSE_SWEEPS.items():
            setattr(dense, f, saved[k])
    return calls, {k: dense.LAUNCHES[KERNELS[k][1]] - before[k] for k in DENSE_SWEEPS}


def record_wave(tables, cam, width: int = 512, height: int = 512, spp: int = 2):
    """Every dense sweep call of the first wave of a ``width`` x ``height``,
    ``spp`` render of ``cam`` at depth 4 (tools/profile_torch_wave.py: samples
    1-2 of every pixel, or the first band of a banded frame).  Returns the
    calls as :func:`record_dense_launches` does; on the card each kernel's
    calls must equal its launches."""
    from profile_torch_wave import first_wave, wave

    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]),
                    aspect=width / height)
    calls, launched = record_dense_launches(
        wave(tables, camera, width, height, 4, *first_wave(tables, width, height, spp)[:2]))
    counts = {k: sum(c[0] == k for c in calls) for k in DENSE_SWEEPS}
    if tables.device.type == "cuda" and counts != launched:
        raise AssertionError(f"recorded {counts} sweep calls, but {launched} launches")
    return calls


def check_recorded(calls, label: str) -> float:
    """Each recorded call replayed through the kernel and its plain
    version: K1's t and triangle and K2's flags bit-equal, K3 within rtol
    1e-5 / atol 1e-7 on lanes whose gate is not 0 and +0 elsewhere.  Returns
    the largest absolute error."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    err = 0.0
    for i, (kernel, args, _) in enumerate(calls):
        got = getattr(dense, DENSE_SWEEPS[kernel])(*args)
        want = getattr(dense, DENSE_SWEEPS[kernel] + "_reference")(*args)
        where = f"{label}: recorded call {i} ({kernel})"
        if kernel == "dense_shadow":
            err = max(err, _max_abs(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"{where} differs from plain")
        elif kernel == "dense_closest":
            err = max(err, _max_abs(got[0], want[0]))
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{where} differs from plain")
        else:
            gated = args[2] != 0.0
            err = max(err, _max_abs(got[gated], want[gated]))
            torch.testing.assert_close(got[gated], want[gated], rtol=1e-5, atol=1e-7)
            off = got[~gated]
            if bool((off != 0.0).any() or torch.signbit(off).any()):
                raise AssertionError(f"{where}: the pdf is not +0 where the gate is 0")
    return err


def time_recorded(device, gallery, out_dir: Path) -> dict:
    """K3 at the glTF 147k wave's launch with the most live lanes and K1 at
    the textured glb wave's first alpha re-launch (a closest call right after
    another), each recorded from its render's first wave and timed with
    :func:`time_launch`; every recorded K1 and K3 call is first held against
    its plain version (:func:`check_recorded`)."""
    import torch_glb_assets

    textured = _load_glb(torch_glb_assets.write_textured_glb(out_dir), 12, 6)[0].upload(device)
    out = {}
    for label, tables, cam, spp, kernel in (
            ("gltf147k", gallery, BIGASSET_CAM, 4, "dense_emissive_pdf"),
            ("alpha_relaunch", textured, TEXTURED_CAM, 16, "dense_closest")):
        calls = record_wave(tables, cam, spp=spp)
        err = check_recorded(calls, label)
        if kernel == "dense_emissive_pdf":
            args = max((a for k, a, _ in calls if k == kernel),
                       key=lambda a: int((a[2] != 0).sum()))
            shape = "glTF 147k wave: its K3 launch with the most live lanes"
        else:
            args = next(a for (k0, _, _), (k, a, _) in zip(calls, calls[1:])
                        if k0 == k == kernel)
            shape = "textured glb wave: its first alpha re-launch of K1"
        out[label] = {**time_launch(kernel, args, shape, reps=20, plain_reps=2),
                      "max_abs_err": err,
                      "launches_per_wave": {k: sum(c[0] == k for c in calls)
                                            for k in DENSE_SWEEPS}}
        del calls
    emit({"phase": "dense_recorded", **out})
    return out


def time_cfg1_shadow(cornell) -> dict:
    """The occlusion kernel at the launches the cfg1 render makes: the first
    wave's five recorded K2 calls (samples 1-2 of 512x512, depth 4), each
    held against its plain version and timed on the card; the wave's device
    time, bound and live lanes are the sums over the five."""
    from vulkan_raytracer_tpu_torch.ops import dense

    calls = [c for c in record_wave(cornell, CFG1_CAM) if c[0] == "dense_shadow"]
    err = check_recorded(calls, "cfg1 wave")
    per_launch = []
    for _, args, _ in calls:
        ms, traced = device_ms(lambda a=args: dense.shadow_sweep(*a), "shadow_kernel", 20)
        per_launch.append({"ms": ms, "launches_traced": traced,
                           **sweep_work("dense_shadow", args)})
    out = {"shape": "cfg1 wave: its recorded K2 launches", "launches": len(calls),
           "max_abs_err": err, "rays": sum(e["rays"] for e in per_launch),
           "live": sum(e["live"] for e in per_launch),
           "ms": sum(e["ms"] for e in per_launch),
           "bound_ms": sum(e["bound_ms"] for e in per_launch),
           "per_launch": [{k: e[k] for k in ("ms", "bound_ms", "bound_by", "live",
                                            "launches_traced")} for e in per_launch]}
    emit({"phase": "dense_recorded_cfg1", "dense_shadow": out})
    return out


def _walk_inputs(rays):
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    cols = dense.ray_columns(rays["o"], rays["d"])
    active = rays["active"]
    return dict(
        cols=cols,
        t_lo=rays["t_min"].contiguous(),
        t_init=torch.where(active, rays["t_max"], -1.0).contiguous(),
        t_sh=torch.where(active, rays["t_shadow"], -1.0).contiguous(),
        zeros=torch.zeros_like(rays["t_min"]),
    )


def check_walks(tables, ray_counts, device, label: str, cam) -> dict:
    """K4' and K5' against their plain versions and against each other on the
    scene's streams, over bench waves of ``cam``; returns the largest
    absolute t error per kernel."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import trace
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    s = tables.pbvh
    walks = {"bvh_walk": (tr.bvh_walk, tr.bvh_walk_reference),
             "treelet_walk": (tr.treelet_walk, tr.treelet_walk_reference)}
    err = {f"{w}_{v}": 0.0 for w in walks for v in ("closest", "shadow")}
    for i, n in enumerate(ray_counts):
        x = _walk_inputs(bench_wave(tables, n, seed=50 + i, device=device, cam=cam))
        cols, t_lo, t_init, t_sh, zeros = (x[k] for k in ("cols", "t_lo", "t_init", "t_sh",
                                                          "zeros"))
        out = {}
        for name, (walk, plain) in walks.items():
            where = f"{name}, {n} rays"
            t_k, s_k = walk(s, cols, t_lo, t_init, False)
            t_p, s_p = plain(s, cols, t_lo, t_init, False)
            e = _max_abs(t_k, t_p)
            if e != 0.0 or not torch.equal(s_k, s_p):
                raise AssertionError(f"{where}: closest differs on {int((s_k != s_p).sum())} "
                                     f"slots, max abs t error {e}")
            # lanes bounded at exactly their hit t must still hit
            t_tie = torch.where(s_p >= 0, t_p, t_init).contiguous()
            t_k2, s_k2 = walk(s, cols, t_lo, t_tie, False)
            t_p2, s_p2 = plain(s, cols, t_lo, t_tie, False)
            e = max(e, _max_abs(t_k2, t_p2))
            if e != 0.0 or not torch.equal(s_k2, s_p2):
                raise AssertionError(f"{where}: closest at the hit bound differs from plain")
            if not torch.equal(s_k2 >= 0, s_p >= 0) or not torch.equal(t_k2, t_p):
                raise AssertionError(f"{where}: a hit at exactly t_init was dropped")
            err[f"{name}_closest"] = max(err[f"{name}_closest"], e)
            o_k, os_k = walk(s, cols, zeros, t_sh, True)
            o_p, os_p = plain(s, cols, zeros, t_sh, True)
            e_sh = _max_abs(o_k, o_p)
            if e_sh != 0.0 or not torch.equal(os_k, os_p):
                raise AssertionError(f"{where}: shadow differs on {int((os_k != os_p).sum())} "
                                     "slots")
            err[f"{name}_shadow"] = max(err[f"{name}_shadow"], e_sh)
            out[name] = (t_k, trace.slot_to_tri(s, s_k)[0], os_k >= 0)
        (t4, tri4, occ4), (t5, tri5, occ5) = out["bvh_walk"], out["treelet_walk"]
        hits = tri4 >= 0
        same_tri = float((tri4 == tri5)[hits].float().mean())
        if not (torch.equal(t4, t5) and torch.equal(hits, tri5 >= 0) and torch.equal(occ4, occ5)):
            raise AssertionError(f"{n} rays: K4' and K5' disagree on t, hits or occlusion")
        if same_tri < 0.999:
            raise AssertionError(f"{n} rays: K4' and K5' agree on only {same_tri} of the ids")
        emit({"phase": "walks", "scene": label, "rays": n,
              "triangles": tables.num_triangles, "nodes": s.num_nodes,
              "treelets": s.n_treelets, "stream_bytes": s.nbytes,
              "hits": int(hits.sum()), "occluded": int(occ4.sum()),
              "k4_vs_k5_t_equal": True, "k4_vs_k5_same_triangle": same_tri,
              **{f"{k}_max_abs_err": v for k, v in err.items()}})
    return err


def time_walks(tables, n: int, device, label: str, cam) -> dict:
    """K4' and K5' (closest, shadow) and their plain versions over a bench
    wave of n rays of ``cam``: the plain version once, then the kernel
    twice; each with its bound from the work
    ``walk_visits`` counts on the same inputs."""
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    s = tables.pbvh
    x = _walk_inputs(bench_wave(tables, n, seed=99, device=device, cam=cam))
    cols, t_lo, t_init, t_sh, zeros = (x[k] for k in ("cols", "t_lo", "t_init", "t_sh", "zeros"))
    treelet_bytes = sum(t.nbytes for t in (s.tl_box, s.tl_group, s.tl_lim))
    out = {}
    for name, walk, plain, treelets in (
            ("bvh_walk", tr.bvh_walk, tr.bvh_walk_reference, False),
            ("treelet_walk", tr.treelet_walk, tr.treelet_walk_reference, True)):
        for kind, lo, hi, shadow in (("closest", t_lo, t_init, False),
                                     ("shadow", zeros, t_sh, True)):
            def kernel(w=walk, lo=lo, hi=hi, shadow=shadow):
                return w(s, cols, lo, hi, shadow)

            def ref(p=plain, lo=lo, hi=hi, shadow=shadow):
                return p(s, cols, lo, hi, shadow)

            p1 = time_ms(ref, 1, warm=False)
            k1, k2 = time_ms(kernel, 10), time_ms(kernel, 10)
            v = tr.walk_visits(s, cols, lo, hi, shadow, treelets)
            ops = SLAB_OPS * int((v["nodes"] + v["boxes"]).sum()) + MT_OPS * int(v["tris"].sum())
            # ray columns, t_lo and t_init in, t and slot out; the stream rows read
            nbytes = 40 * n + 32 * v["node_rows"] + 48 * v["tri_rows"]
            nbytes += treelet_bytes if treelets else 0
            live = max(int((hi >= 0).sum()), 1)
            out[f"{name}_{kind}"] = {
                "ms": (k1 + k2) / 2, "plain_ms": p1, "ms_runs": [k1, k2],
                "shape": f"{label} wave: {n} rays over {tables.num_triangles} triangles",
                **bound(ops, nbytes),
                "per_live_ray": {k: int(v[k].sum()) / live
                                 for k in ("nodes", "leaves", "tris", "boxes")},
                "node_rows": v["node_rows"], "tri_rows": v["tri_rows"]}
    emit({"phase": "walk_times", "scene": label, "rays": n,
          "triangles": tables.num_triangles, "stream_bytes": s.nbytes,
          "k5_over_k4_closest": out["treelet_walk_closest"]["ms"] / out["bvh_walk_closest"]["ms"],
          "k5_over_k4_shadow": out["treelet_walk_shadow"]["ms"] / out["bvh_walk_shadow"]["ms"],
          **out})
    return out


def check_emissive_walk(tables, ray_counts, device) -> float:
    """The emissive-pdf walk against its plain version on the tables'
    emissive stream, for random rays in the Cornell volume with 20% of the
    lanes inactive, at both t_min the render uses: bit-equal on active lanes
    (the kernel enters the binary walk's leaves in its order and adds their
    terms in its order, with IEEE divides and square roots), +0 on the
    others; any lane that differs fails.  Returns the largest absolute
    error (0)."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    s = tables.em_stream
    err = 0.0
    for i, n in enumerate(ray_counts):
        rays = make_rays(n, seed=70 + i, device=device)
        cols = dense.ray_columns(rays["o"], rays["d"])
        active = rays["active"]
        out = {}
        for t_min in (EPS, 0.0):
            got = tr.emissive_pdf_walk(s, cols, active, t_min)
            want = tr.emissive_pdf_walk_reference(s, cols, active, t_min)
            e = _max_abs(got[active], want[active])
            err = max(err, e)
            differ = int((got[active] != want[active]).sum())
            off = got[~active]
            if differ or bool((off != 0.0).any() or torch.signbit(off).any()):
                raise AssertionError(f"emissive walk, {n} rays, t_min {t_min}: {differ} active "
                                     f"lanes differ from the plain version (max abs error {e}),"
                                     f" or an inactive lane is not +0")
            out[f"max_abs_err_t_min_{t_min}"] = e
            out[f"pdf_lanes_t_min_{t_min}"] = int((got > 0).sum())
        emit({"phase": "emissive_walk", "rays": n, "active": int(active.sum()),
              "emissive_triangles": s.rows.shape[0], "nodes": s.num_nodes,
              "wide_nodes": s.wide.shape[0], "stack": s.stack, "stream_bytes": s.nbytes,
              "differing_lanes": 0, **out})
    return err


def emissive_walk_bound(s, cols, active, t_min: float) -> tuple:
    """The bound of one emissive walk launch, from the work of the contract
    that ``emissive_walk_visits`` counts on the binary plain walk: a box test
    per node visited, a triangle test per real slot of each leaf entered and
    the term per hit; bytes: the active lanes' rays, every lane's flag and
    output, the node records and triangle rows read.  Returns
    (:func:`bound`'s dict, the visits)."""
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    v = tr.emissive_walk_visits(s, cols, active, t_min)
    ops = (SLAB_OPS * int(v["nodes"].sum()) + MT_OPS * int(v["tris"].sum())
           + WALK_TERM_OPS * int(v["hits"].sum()))
    nbytes = (5 * active.shape[0] + 24 * int(active.sum()) + 32 * v["node_rows"]
              + 80 * v["tri_rows"])
    return bound(ops, nbytes), v


def time_emissive_walk(tables, n: int, device) -> dict:
    """The emissive-pdf walk and its plain version over n random rays in the
    Cornell volume (80% active, t_min EPS), the plain version once, then the
    kernel twice, with the bound of :func:`emissive_walk_bound`."""
    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    s = tables.em_stream
    rays = make_rays(n, seed=99, device=device)
    cols = dense.ray_columns(rays["o"], rays["d"])
    active = rays["active"]

    def kernel():
        return tr.emissive_pdf_walk(s, cols, active, EPS)

    def ref():
        return tr.emissive_pdf_walk_reference(s, cols, active, EPS)

    p1 = time_ms(ref, 1, warm=False)
    k1, k2 = time_ms(kernel, 10), time_ms(kernel, 10)
    b, v = emissive_walk_bound(s, cols, active, EPS)
    live = max(int(active.sum()), 1)
    out = {"ms": (k1 + k2) / 2, "plain_ms": p1, "ms_runs": [k1, k2],
           "shape": f"emissive soup wave: {n} rays over {s.rows.shape[0]} emissive triangles",
           **b, "live": live,
           "per_live_ray": {k: int(v[k].sum()) / live for k in ("nodes", "tris", "hits")},
           "node_rows": v["node_rows"], "tri_rows": v["tri_rows"]}
    emit({"phase": "emissive_walk_times", "rays": n, "emissive_walk": out})
    return out


def record_emissive_probes(run):
    """Call ``run()``, eagerly, with ops/traverse.py's emissive walk wrapped
    so that each call's t_min, count of active lanes and inputs (cloned) are
    kept; returns (what ``run`` returned, the calls as (t_min, active lanes,
    ray columns, active))."""
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    saved = tr.emissive_pdf_walk
    calls = []

    def recording(stream, rays, active, t_min):
        calls.append((t_min, int(active.sum()), tuple(c.clone() for c in rays),
                      active.clone()))
        return saved(stream, rays, active, t_min)

    try:
        tr.emissive_pdf_walk = recording
        with _eager():
            result = run()
    finally:
        tr.emissive_pdf_walk = saved
    return result, calls


def check_emissive_probes(stream, probes, reps: int = 5) -> dict:
    """Each recorded probe launch of a render (:func:`record_emissive_probes`)
    once more through the kernel against the plain version: bit-equal on
    active lanes and +0 on the others, or it fails; its live lanes and its
    device time (``reps`` launches on its inputs captured in one graph,
    ``check_torch_trace._cold_ms`` with the one copy).  Returns the
    launches' lines and their sums."""
    from check_torch_trace import _cold_ms

    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    lines, total_ms, err = [], 0.0, 0.0
    for i, (t_min, live, cols, active) in enumerate(probes):
        got = tr.emissive_pdf_walk(stream, cols, active, t_min)
        want = tr.emissive_pdf_walk_reference(stream, cols, active, t_min)
        differ = int((got[active] != want[active]).sum())
        if differ or bool((got[~active] != 0.0).any()):
            raise AssertionError(f"emissive probe {i} (t_min {t_min}, {live} live lanes): "
                                 f"{differ} active lanes differ from the plain version, or an "
                                 f"inactive lane is not 0")
        err = max(err, _max_abs(got[active], want[active]))
        ms = _cold_ms(lambda: tr.emissive_pdf_walk(stream, cols, active, t_min), [()], reps)
        total_ms += ms
        lines.append({"t_min": t_min, "live": live, "us": 1e3 * ms})
    return {"launches": lines, "us_sum": 1e3 * total_ms,
            "live_sum": sum(live for _, live, _, _ in probes),
            "max_abs_err": err, "differing_lanes": 0}


def render_emissive_bvh(device, paths) -> dict:
    """A scene whose pdf probes walk the emissive BVH: 100,000 grey and 5,000
    emissive triangles, 512x512, depth 4, 4 spp on the card, every probe
    launch of the frame kept and held against the plain version bit for bit
    (:func:`check_emissive_probes`, whose result it returns); then 32x32 on
    the card against the CPU."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    scene = emitter_soup_scene(100000, 5000, seed=31)
    t0 = time.perf_counter()
    tables = scene.upload(device)
    tables.em_stream  # built on first use: part of the set-up
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if not (tables.num_emissive_tris == 5000 > dense.EMISSIVE_MAX_TRIS
            and tables.num_triangles == 105000 > dense.DENSE_MAX_TRIS
            and tables.pbvh.n_treelets > 1):
        raise AssertionError("the emitter soup is not on the BVH and emissive-BVH paths")

    def run():
        cam = Camera(position=np.array(CFG1_CAM[0]), direction=np.array(CFG1_CAM[1]))
        t0 = time.perf_counter()
        img, rays = render_image(tables, cam, 512, 512, spp=4, max_depth=4, tonemap=False)
        return img, rays, time.perf_counter() - t0

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    (img, rays, secs), probes = record_emissive_probes(run)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    mis = [live for t_min, live, _, _ in probes if t_min == EPS]
    nee = [live for t_min, live, _, _ in probes if t_min == 0.0]
    walks = launches["traverse"]
    if not (walks["emissive_pdf"] == len(probes) == len(mis) + len(nee)
            and sum(a > 0 for a in mis) > 0 and sum(a > 0 for a in nee) > 0):
        raise AssertionError(f"the pdf probes missed the emissive walk: {walks}, MIS {mis}, "
                             f"NEE {nee}")
    if launches["dense"]["pdf"] != 0:
        raise AssertionError(f"a pdf probe took the dense sweep: {launches}")
    if not (walks["treelet_closest"] > 0 and walks["treelet_shadow"] > 0):
        raise AssertionError(f"the emitter soup render missed K5': {launches}")
    if not np.isfinite(img).all() or img.shape != (512, 512, 3) or not img.mean() > 1e-3:
        raise AssertionError(f"emitter soup image not finite, misshapen or black: "
                             f"{img.shape} mean {img.mean()}")
    paths.add("render_emissive_bvh", launches)
    emit({"phase": "render_emissive_bvh", "bounces": _mode(),
          "config": "emitter soup (100,000 grey + 5,000 emissive tris) 512x512 depth 4 4 spp",
          "upload_seconds": upload_s, "treelets": tables.pbvh.n_treelets,
          "emissive_stream_bytes": tables.em_stream.nbytes, "seconds": secs, "rays": rays,
          "mrays_per_s": rays / secs / 1e6, "peak_memory_bytes": peak,
          "mis_probes": {"launches": len(mis), "with_live_lanes": sum(a > 0 for a in mis),
                         "live_lanes": sum(mis)},
          "nee_probes": {"launches": len(nee), "with_live_lanes": sum(a > 0 for a in nee),
                         "live_lanes": sum(nee)},
          "launches": launches, "image_mean": float(img.mean())})
    checked = check_emissive_probes(tables.em_stream, probes)
    del probes
    emit({"phase": "render_emissive_bvh_probes", "emissive_triangles": tables.num_emissive_tris,
          "wide_nodes": tables.em_stream.wide.shape[0], **checked})
    _reset_launches()
    res = _cuda_vs_cpu(tables, CFG1_CAM, "emitter soup")
    launches = _launch_counts()
    if not launches["traverse"]["emissive_pdf"] > 0:
        raise AssertionError(f"the 32x32 emitter soup render missed the emissive walk: {launches}")
    emit({"phase": "render_emissive_bvh_parity", "bounces": _mode(),
          "config": "emitter soup 32x32 2 spp depth 3",
          "launches": launches, **res})
    return checked


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _render(tables, cam_args, width, height, spp, depth):
    """``render_image`` (linear mean) with a camera of (position,
    direction); returns (image, rays, seconds)."""
    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    cam = Camera(position=np.array(cam_args[0]), direction=np.array(cam_args[1]))
    t0 = time.perf_counter()
    img, rays = render_image(tables, cam, width, height, spp=spp, max_depth=depth,
                             tonemap=False)
    return img, rays, time.perf_counter() - t0


def _walk_name(group) -> str:
    return "treelet" if group.pblas.n_treelets > 1 else "bvh"


def instanced_parity(device, ray_counts, detail: int = 256) -> None:
    """The two-level traversal on the card (the kernels) against the same
    calls on the CPU (their plain versions), over a gallery of 5 dragon
    instances (one BLAS group), a floor and two panels (dense groups)."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import instanced
    from vulkan_raytracer_tpu_torch.ops.math3 import V3

    n_dragons = 5
    tables = gallery_scene(detail, n_dragons).upload(device, instancing=True)
    groups = tables.inst.groups
    if not (tables.inst.num_instances == 8 and groups[0].tri_cnt == 4 * detail * detail
            and groups[0].pblas is not None and groups[0].pblas.n_treelets > 1
            and all(g.pblas is None and g.table is not None for g in groups[1:])):
        raise AssertionError("the parity gallery is not one BLAS group and two dense groups")
    cpu = tables.to("cpu")
    for i, n in enumerate(ray_counts):
        rays = gallery_rays(n, n_dragons, seed=80 + i, device=device)
        on_cpu = {k: V3(*(c.cpu() for c in v)) if isinstance(v, V3) else v.cpu()
                  for k, v in rays.items()}

        def trace(tb, r):
            c = instanced.instanced_closest(tb, r["o"], r["d"], t_min=r["t_min"],
                                            t_max=r["t_max"], active=r["active"])
            sh = instanced.instanced_shadow(tb, r["o"], r["d"], t_max=r["t_shadow"],
                                            active=r["active"])
            return c, sh

        t0 = time.perf_counter()
        (t_w, enc_w, u_w, v_w), occ_w = trace(cpu, on_cpu)
        cpu_s = time.perf_counter() - t0
        _reset_launches()
        ((t_k, enc_k, u_k, v_k), occ_k), secs = _timed_sync(lambda: trace(tables, rays))
        launches, steps = _launch_counts(), dict(instanced.STATS)
        where = f"instanced parity, {n} rays"
        t_k, enc_k, u_k, v_k, occ_k = (x.cpu() for x in (t_k, enc_k, u_k, v_k, occ_k))
        if not (torch.equal(enc_k, enc_w) and torch.equal(occ_k, occ_w)):
            raise AssertionError(
                f"{where}: {int((enc_k != enc_w).sum())} ids and "
                f"{int((occ_k != occ_w).sum())} occlusion flags differ from the CPU's")
        hit = enc_w >= 0
        torch.testing.assert_close(t_k[hit], t_w[hit], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(u_k, u_w, rtol=0.0, atol=1e-5)
        torch.testing.assert_close(v_k, v_w, rtol=0.0, atol=1e-5)
        if not bool(torch.isinf(t_k[~hit]).all()):
            raise AssertionError(f"{where}: a miss lane's t is not inf")
        walk = _walk_name(groups[0])
        used = {"K1": launches["dense"]["closest"], "K2": launches["dense"]["shadow"],
                "walk_closest": launches["traverse"][f"{walk}_closest"],
                "walk_shadow": launches["traverse"][f"{walk}_shadow"]}
        if not all(used.values()):
            raise AssertionError(f"{where}: a kernel was not launched: {launches}")
        emit({"phase": "instanced_parity", "rays": n, "instances": 8,
              "prototype_triangles": tables.num_triangles,
              "treelets": groups[0].pblas.n_treelets, "active": int(rays["active"].sum()),
              "hits": int(hit.sum()), "occluded": int(occ_w.sum()),
              "instances_hit": int(torch.unique(tables.inst.decode(enc_w[hit])[1]).numel()),
              "ids_and_flags_bit_equal": True, "cpu_seconds": cpu_s, "seconds": secs,
              "steps": steps["steps"], "launches": used,
              "t_max_abs_err": _max_abs(t_k[hit], t_w[hit]),
              "t_bit_equal": bool(torch.equal(t_k[hit], t_w[hit]))})


def render_instanced(device, paths, detail: int = 256, n_dragons: int = 64, size: int = 512):
    """The full-width instanced path: the 64-dragon gallery through
    ``Scene.upload(instancing="auto")`` and ``render_image`` at 512x512,
    depth 4, 4 spp, once to warm up and once timed; then 32x32 on the card
    against the CPU.  Returns (scene, tables) for the refit phase."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import instanced

    scene = gallery_scene(detail, n_dragons)
    cam = gallery_camera(n_dragons)
    dragon_tris = 4 * detail * detail
    if not scene._should_instance("auto"):
        raise AssertionError("'auto' would flatten the gallery")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tables = scene.upload(device)  # instancing="auto"
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    table_bytes = torch.cuda.memory_allocated() - before
    inst = tables.inst
    flattened = sum(g.tri_cnt * g.inv.shape[0] for g in inst.groups) if inst else 0
    if not (inst is not None and tables.bvh is None and tables.pbvh is None
            and tables.num_triangles == dragon_tris + 2 + 2
            and inst.num_instances == n_dragons + 3
            and flattened == n_dragons * dragon_tris + 2 + 4
            and inst.groups[0].pblas.n_treelets > 1
            and 0 < tables.num_emissive_tris <= 1024):
        raise AssertionError("the gallery was not uploaded instanced as expected")
    walk = _walk_name(inst.groups[0])
    images = []
    for _ in range(2):  # the first warms up
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        img, rays, secs = _render(tables, cam, size, size, spp=4, depth=4)
        images.append(img)
    launches, steps = _launch_counts(), dict(instanced.STATS)
    peak = torch.cuda.max_memory_allocated()
    if not (all(launches["dense"][c] > 0 for c in ("closest", "shadow", "pdf"))
            and launches["traverse"][f"{walk}_closest"] > 0
            and launches["traverse"][f"{walk}_shadow"] > 0):
        raise AssertionError(f"the gallery render missed a kernel: launches {launches}")
    if not np.isfinite(img).all() or img.shape != (size, size, 3) or not img.mean() > 1e-3:
        raise AssertionError(f"gallery image not finite, misshapen or black: "
                             f"{img.shape} mean {img.mean()}")
    if not np.array_equal(*images):
        raise AssertionError("two renders of the gallery differ")
    calls = steps["closest_calls"] + steps["shadow_calls"]
    if steps["steps"] != calls * inst.num_instances:
        raise AssertionError(f"{steps['steps']} instance steps in {calls} calls over "
                             f"{inst.num_instances} instances: one was skipped")
    paths.add("render_instanced", launches)
    waves = 2  # 4 spp of 262,144 pixels in waves of 524,288 lanes
    emit({"phase": "render_instanced", "bounces": _mode(),
          "config": f"gallery: {n_dragons} dragon instances + floor + 2 emissive panels, "
                    f"{size}x{size} depth 4 4 spp",
          "instancing": "auto", "instances": inst.num_instances,
          "prototype_triangles": tables.num_triangles, "flattened_triangles": flattened,
          "emissive_triangles": tables.num_emissive_tris,
          "treelets": inst.groups[0].pblas.n_treelets,
          "upload_seconds": upload_s, "upload": scene.upload_stats,
          "table_and_stream_bytes": table_bytes, "peak_memory_bytes": peak,
          "seconds": secs, "rays": rays, "mrays_per_s": rays / secs / 1e6, "waves": waves,
          "closest_calls": steps["closest_calls"], "shadow_calls": steps["shadow_calls"],
          "steps": steps["steps"], "launches": launches,
          "image_mean": float(img.mean())})
    _reset_launches()
    t0 = time.perf_counter()
    res = _cuda_vs_cpu(tables, cam, "gallery")
    emit({"phase": "render_instanced_parity", "bounces": _mode(),
          "config": "gallery 32x32 2 spp depth 3",
          "seconds": time.perf_counter() - t0, "launches": _launch_counts(), **res})
    return scene, tables


def instanced_vs_flattened(device, detail: int = 256) -> None:
    """The dragon x 4 instances uploaded both ways on the card: their
    first hits lane by lane and their 32 spp image
    (``torch_lane_diff.check_uploads``)."""
    import torch_lane_diff

    _reset_launches()
    t0 = time.perf_counter()
    res = torch_lane_diff.check_uploads(gallery_scene(detail, n_dragons=4), gallery_camera(4),
                                        device)
    emit({"phase": "instanced_vs_flattened", "bounces": _mode(),
          "config": "gallery of 4 dragons 128x128 32 spp depth 3",
          "seconds": time.perf_counter() - t0, "launches": _launch_counts(), **res})
    if not res["ok"]:
        raise AssertionError(f"instanced vs flattened: first hits {res['first_hits']}, "
                             f"RMSE {res['rmse']} (bar {res['bar']})")


def _timed_sync(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def refit_phase(device, paths, dragon, dragon_tables, gallery, gallery_tables) -> None:
    """``Scene.refit`` against a fresh ``upload`` after a node moved: the
    cfg2 dragon scene (flattened, on the BVH walks) and the gallery
    (instanced), each given as the scene and its tables on the card."""

    def move(scene, node, transform):
        node.local_transform = (transform @ node.local_transform).astype(np.float32)
        for n in scene.iter_depth_first():
            if n.parent is not None:
                n.world_transform = (n.parent.world_transform @ n.local_transform).astype(
                    np.float32)

    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [0.6, 0.35, -0.4]
    out = {}
    _reset_launches()
    for name, scene, tables, node, cam, kw in (
            ("cfg2_dragon", dragon, dragon_tables, 0, CFG2_CAM, {}),
            ("gallery", gallery, gallery_tables, gallery_tables.inst.num_instances // 3,
             gallery_camera(gallery_tables.inst.num_instances - 3), {"instancing": True})):
        before, _, _ = _render(tables, cam, 128, 128, spp=2, depth=3)
        move(scene, scene.root.children[node], shift)
        refit, refit_s = _timed_sync(lambda: scene.refit(tables))
        fresh, upload_s = _timed_sync(lambda: scene.upload(device, **kw))
        img_r, rays_r, _ = _render(refit, cam, 128, 128, spp=2, depth=3)
        img_f, rays_f, _ = _render(fresh, cam, 128, 128, spp=2, depth=3)
        err = float(np.abs(img_r - img_f).max())
        rmse = _rmse(img_r, img_f)
        moved = float(np.abs(img_r - before).max())
        out[name] = {"triangles": tables.num_triangles, "refit_seconds": refit_s,
                     "upload_seconds": upload_s, "max_abs_err": err, "rmse": rmse,
                     "rays_refit": rays_r, "rays_fresh": rays_f, "moved_max_abs": moved}
        ok = err <= 1e-5 if tables.inst is None else rmse < RMSE_BAR
        if not (ok and np.isfinite(img_r).all() and moved > 1e-3):
            raise AssertionError(f"refit of {name}: against a fresh upload max abs {err}, RMSE "
                                 f"{rmse}; against the image before the move {moved}")
        if refit_s > 2.0 * upload_s:
            raise AssertionError(f"refit of {name} took {refit_s:.3f}s, the rebuild "
                                 f"{upload_s:.3f}s")
    launches, bounces = _launch_counts(), _mode()
    paths.add("refit", launches)
    emit({"phase": "refit", "bounces": bounces,
          "config": "one node moved; 128x128 2 spp depth 3", **out,
          "launches": launches})
    # the emitter soup of phase 15 with its emissive mesh's node moved: its
    # probes walk the refitted emissive stream
    soup = emitter_soup_scene(100000, 5000, seed=31)
    soup_tables = soup.upload(device)
    move(soup, soup.root.children[1], shift)
    # a gallery instance lifted past the union box, so that the refits' box
    # is a new one the programs must read
    box = gallery_tables.inst.box.cpu().numpy()
    lift = np.eye(4, dtype=np.float32)
    lift[1, 3] = 2.0 * float(box[1, 1] - box[0, 1]) + 1.0
    move(gallery, gallery.root.children[gallery_tables.inst.num_instances // 3], lift)
    frame_after_refit(device, ((
        "cfg2_dragon", dragon, dragon_tables, CFG2_CAM), (
        "gallery", gallery, gallery_tables, gallery_camera(gallery_tables.inst.num_instances - 3)),
        ("emitter soup", soup, soup_tables, CFG1_CAM)))


def refit_key_box(device, tables, refit, keys: int) -> dict:
    """The re-sort key on the frames after an instanced refit: ``keys`` key
    launches ran in them, the refit's tables carry their union box
    (``InstanceTables.box``, bit-equal to ``trace.root_bounds`` of the refit's
    instance boxes), the cache's mirror, which the programs read, holds it,
    and the key kernel over the mirror is bit-equal to the plain key over the
    refit's tables on 65,536 lanes from a seed across the box, and the box
    is not the tables' (the caller moved an instance past it), so that a
    mirror left with the tables' box would differ; any other outcome
    fails."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import trace
    from vulkan_raytracer_tpu_torch.ops.math3 import V3
    from vulkan_raytracer_tpu_torch.render import graphs

    mirror = graphs.cache(refit).mirror
    lo, hi = trace.root_bounds(refit)
    if not (keys > 0 and torch.equal(refit.inst.box, torch.stack([lo, hi]))
            and not torch.equal(refit.inst.box, tables.inst.box)
            and torch.equal(mirror.inst.box, refit.inst.box)):
        raise AssertionError(f"refit key: {keys} key launches; the refit's box "
                             f"{refit.inst.box.tolist()}, root bounds {lo.tolist()} "
                             f"{hi.tolist()}, the tables' {tables.inst.box.tolist()}, the "
                             f"mirror's {mirror.inst.box.tolist()}")
    g = torch.Generator(device=device).manual_seed(53)
    n = 1 << 16
    o = V3(*(lo[k] + (hi[k] - lo[k]) * (torch.rand(n, generator=g, device=device) * 1.2 - 0.1)
             for k in range(3)))
    d = V3(*torch.randn((3, n), generator=g, device=device))
    active = torch.rand(n, generator=g, device=device) < 0.7
    before = trace.LAUNCHES["coherence_key"]
    got = trace.coherence_key(mirror, o, d, active)
    want = trace.coherence_key_reference(refit, o, d, active)
    torch.cuda.synchronize(device)
    if trace.LAUNCHES["coherence_key"] - before != 1 or not torch.equal(got, want):
        raise AssertionError(f"refit key: the kernel over the mirror differs from the plain "
                             f"key on {int((got != want).sum())} of {n} lanes")
    return {"key_launches": keys, "box": refit.inst.box.tolist(),
            "tables_box": tables.inst.box.tolist(), "box_moved": True,
            "mirror_box_equal": True, "key_lanes_equal": n}


def frame_after_refit(device, cases, size: int = 512, spp: int = 4, depth: int = 4) -> None:
    """The frame a dynamic scene renders right after ``Scene.refit`` (the
    Renderer's refit-and-restart loop), with graphs and eager, in turns
    (graphs, eager, eager, graphs), each turn on the tables of a refit of
    its own, after one frame on the tables before the refits (which
    captures what the frame replays): the first frame on new tables and a
    second frame on the same tables.  A refit keeps the tables' signature,
    so the graphs side's first frame captures nothing and copies the new
    tables into the cache's mirror once; it must be no slower than the
    eager first frame.  Both sides' images bit-equal, and the old tables
    render their own frame again bit for bit.  On a scene whose probes walk
    the emissive BVH each refit's wide table has the shape of the tables'
    and new boxes, and every side's frames launch the walk.  On an
    instanced scene the graphs side's frames re-sort with the refit's box
    (:func:`refit_key_box`)."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.render import graphs

    for name, scene, tables, cam in cases:
        walks = tables.num_emissive_tris > dense.EMISSIVE_MAX_TRIS
        graphs.reset_stats()
        before, _, warm_s = _render(tables, cam, size, size, spp=spp, depth=depth)
        warm = {"seconds": warm_s, "captured": graphs.STATS["captured"],
                "capture_s": graphs.STATS["capture_s"]}
        out = {side: {"first_s": [], "second_s": [], "captured": [], "copies": [],
                      "copy_bytes": [], "emissive_walks": []}
               for side in ("graphs", "eager")}
        want, key_box = None, None
        # three turns a side, so one turn's host noise does not decide the
        # comparison of the medians (the gallery's sides are within ~1%)
        for side in ("graphs", "eager", "eager", "graphs", "graphs", "eager"):
            with _eager() if side == "eager" else contextlib.nullcontext():
                refit = scene.refit(tables)
                if graphs.signature(refit) != graphs.signature(tables):
                    raise AssertionError(f"{name}: the refit changed the tables' signature")
                if walks:
                    got, had = refit.em_stream.wide, tables.em_stream.wide
                    if got.shape != had.shape or torch.equal(got, had):
                        raise AssertionError(f"{name}: the refit's wide emissive table is "
                                             f"{tuple(got.shape)}, the tables' "
                                             f"{tuple(had.shape)}, or the same boxes")
                torch.cuda.synchronize(device)
                graphs.reset_stats()
                _reset_launches()
                for key in ("first_s", "second_s"):
                    img, rays, secs = _render(refit, cam, size, size, spp=spp, depth=depth)
                    out[side][key].append(secs)
                out[side]["emissive_walks"].append(
                    _launch_counts()["traverse"].get("emissive_pdf", 0))
                if side == "graphs" and refit.inst is not None:
                    key_box = refit_key_box(device, tables, refit,
                                            _launch_counts()["trace"]["coherence_key"])
                out[side]["captured"].append(graphs.STATS["captured"])
                out[side]["copies"].append(graphs.STATS["copies"])
                out[side]["copy_bytes"].append(graphs.STATS["copy_bytes"])
            del refit
            if want is None:
                want = (img, rays)
            if not (np.array_equal(img, want[0]) and rays == want[1]):
                raise AssertionError(f"{name}: the {side} frame after a refit differs")
        graphs.reset_stats()
        again, _, _ = _render(tables, cam, size, size, spp=spp, depth=depth)
        if not np.array_equal(again, before):
            raise AssertionError(f"{name}: the tables before the refits no longer render "
                                 "their own frame")
        for o in out.values():
            o.update(first_s_median=statistics.median(o["first_s"]),
                     second_s_median=statistics.median(o["second_s"]))
        g, e = out["graphs"], out["eager"]
        if any(g["captured"]) or g["copies"] != [1, 1, 1]:
            raise AssertionError(f"{name}: the graphs side's frames after a refit captured "
                                 f"{g['captured']} programs, filled the mirror {g['copies']}")
        if walks and not all(g["emissive_walks"] + e["emissive_walks"]):
            raise AssertionError(f"{name}: frames after a refit launched the emissive walk "
                                 f"{g['emissive_walks']} times with graphs, "
                                 f"{e['emissive_walks']} eagerly")
        if not g["first_s_median"] <= e["first_s_median"]:
            raise AssertionError(f"{name}: the first frame after a refit took "
                                 f"{g['first_s_median']:.3f}s with graphs, "
                                 f"{e['first_s_median']:.3f}s eagerly")
        cache = graphs.cache(tables)
        emit({"phase": "refit_frame", "config": f"{name}: {size}x{size} {spp} spp depth {depth} "
                                                f"on the tables of a new refit", "rays": want[1],
              "bit_equal": True, "old_tables_bit_equal": True, "warm_frame": warm, **out,
              **({"key_box": key_box} if key_box else {}),
              "mirror_copy_bytes": g["copy_bytes"],
              "mirror_bytes": cache.mirror_bytes(), "pool_bytes": cache.pool_bytes(),
              "first_frame_graphs_over_eager": g["first_s_median"] / e["first_s_median"],
              "nvidia_smi": nvidia_smi_line()})


#: frame_post_kernel's template instances (csrc/wave.cu ``enum FramePost``)
FRAME_POST_INSTANCES = ("uint8", "float", "pixels", "cells")


def ptxas_instances(report: str, kernel: str, names) -> dict:
    """Registers, stack frame and spill bytes of each instance of the
    template ``kernel`` (``kernel<0>`` ... named by ``names``) from
    ptxas's -v report."""
    out, name, row = {}, None, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(kernel + r"ILi(\d+)E", line)
            name = names[int(m.group(1))] if m else None
        elif name and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            row = dict(zip(("stack_frame", "spill_stores", "spill_loads"), nums))
        elif name and row is not None and "Used" in line and "registers" in line:
            row["registers"] = int(line.split("Used")[1].split()[0])
            out[name], name, row = row, None, None
    return out


def check_frame_post(device, size: int = 512) -> dict:
    """``frame_post_kernel``'s instances against their plain versions: the
    headless image (``wave.frame_image``: uint8 and float32, with and
    without tonemap, a sum over 16 samples in block order) at a ragged
    30x17 frame (edge blocks whose rows are not multiples of 4 pixels), at
    512x512 and at cfg4's and cfg5's 960x540 and 1920x1080; the progressive
    frame (``wave.frame_progressive``: the preview sample 0 and sample 5)
    at the frame's size (30x17 and 512x512) and in cells (4x7 of 30x17,
    120x160 of 512x512: rows and columns no cell shows), inputs made from
    a seed: images and the accumulation bit-equal (any differing element
    fails).  Then each timed cold, launch after launch on copies of its
    inputs spanning four times the L2, against its plain version, with its
    bytes bound: the tonemapped uint8 image at the three frame sizes, the
    progressive frame at 512x512; beside them ``empty_kernel`` launched the
    same way on the 512x512 image's grid and on one block (the floor one
    launch sets).  Returns the kernel's times, its largest error, the
    shapes and each instance's ptxas figures."""
    import torch
    from check_torch_trace import _cold_ms, _copies, _plain_ms

    from vulkan_raytracer_tpu_torch.ops import _ext, wave
    from vulkan_raytracer_tpu_torch.render import integrator

    g = torch.Generator(device=device).manual_seed(21)

    def hdr(n):
        return (torch.rand((n, 3), generator=g, device=device) * 2.0) ** 4

    err, cases = 0.0, 0
    sizes = ((30, 17), (size, size), (960, 540), (1920, 1080))
    for w, h in sizes:
        lanes = integrator.block_lanes(w, h, device)
        acc = hdr(w * h) * 16.0
        for tonemap in (True, False):
            for as_uint8 in (True, False):
                got = wave.frame_image(acc, lanes, 16, tonemap, as_uint8)
                want = wave.frame_image_reference(acc, lanes, 16, tonemap, as_uint8)
                err = max(err, float((got.double() - want.double()).abs().max()))
                cases += 1
                if not torch.equal(got, want):
                    raise AssertionError(f"frame_image ({w}x{h}, tonemap {tonemap}, uint8 "
                                         f"{as_uint8}) differs from its plain version by {err}")
    for (w, h), disp in (((30, 17), (17, 30)), ((30, 17), (4, 7)), ((size, size), (size, size)),
                         ((size, size), (120, 160))):
        accum = hdr(w * h)
        want_accum = accum.clone()
        for sample in (0, 5):
            rad = hdr(w * h)
            got = wave.frame_progressive(rad, accum, torch.tensor([sample], device=device),
                                         w, h, *disp)
            want = wave.frame_progressive_reference(rad, want_accum, sample, w, h, *disp)
            cases += 1
            if not (torch.equal(got, want) and torch.equal(accum, want_accum)):
                raise AssertionError(f"frame_progressive ({w}x{h} shown {disp}, sample "
                                     f"{sample}) differs from its plain version")

    def timed(fn, ref, args, plain_args, nbytes, shape):
        copies = _copies(args, nbytes)
        t = {"ms": _cold_ms(fn, copies), "plain_ms": _plain_ms(ref, plain_args(copies)),
             "bytes": nbytes, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
             "shape": shape}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        return t

    images = {}
    for w, h in sizes[1:]:
        n = w * h
        images[f"{w}x{h}"] = timed(
            wave.frame_image, wave.frame_image_reference,
            (hdr(n) * 16.0, integrator.block_lanes(w, h, device), 16, True, True),
            lambda c: c, wave.frame_post_bytes(n, 3 * n, progressive=False),
            f"render_image's tail, {w}x{h}, tonemapped uint8")
    n = size * size
    prog = timed(wave.frame_progressive, wave.frame_progressive_reference,
                 (hdr(n), hdr(n), torch.tensor([5], device=device), size, size, size, size),
                 lambda c: [(r, a, 5, *rest) for r, a, _, *rest in c],
                 wave.frame_post_bytes(n, 3 * n, progressive=True),
                 f"a progressive frame's tail, {size}x{size}, sample 5")
    blocks = -(-n // wave.SUM_THREADS)  # the image's grid: a thread a lane
    empty = {f"{b}_blocks": _cold_ms(lambda k: wave.empty_launch(k, device), [(b,)] * 2)
             for b in (blocks, 1)}
    ptxas = ptxas_instances(_ext.ptxas_report(), "frame_post_kernel", FRAME_POST_INSTANCES)
    out = {"cases": cases, "max_abs_err": err, "image": images[f"{size}x{size}"],
           "progressive": prog, "image_by_size": images, "empty_kernel_ms": empty,
           "ptxas_by_instance": ptxas, "nvidia_smi": nvidia_smi_line()}
    emit({"phase": "frame_post", **out})
    if set(ptxas) != set(FRAME_POST_INSTANCES):
        raise AssertionError(f"ptxas reported frame_post_kernel's instances {sorted(ptxas)}")
    return out


def progressive_phase(device, paths, size: int = 512, spp: int = 16) -> dict:
    """The progressive Renderer on Cornell 512x512, depth 4, and the CLI's
    --progressive, --checkpoint and --resume on the card; then
    ``frame_post_kernel`` against its plain versions
    (:func:`check_frame_post`), whose result it returns."""
    from vulkan_raytracer_tpu_torch import cli
    from vulkan_raytracer_tpu_torch.render import graphs
    from vulkan_raytracer_tpu_torch.render.renderer import Renderer
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    def cam():
        return Camera(position=np.array(CFG1_CAM[0]), direction=np.array(CFG1_CAM[1]))

    w = h = size
    depth = 4
    tables = cornell_box_scene().upload(device)
    r = Renderer(tables, cam(), w, h, depth)
    _reset_launches()
    frames, ms = [], []
    for _ in range(spp + 1):  # the preview frame, then the samples
        (img, secs) = _timed_sync(r.draw_frame)
        frames.append(img)
        ms.append(1e3 * secs)
    traced = r.rays_traced  # the frames' one read of their rays, and of their counts
    launches = _launch_counts()
    programs = graphs.STATS["launches"]  # one a frame
    if not all(launches["dense"][c] > 0 for c in ("closest", "shadow", "pdf")):
        raise AssertionError(f"the progressive frames missed a kernel: launches {launches}")
    paths.add("progressive", launches)
    mean = (r.accum / float(spp)).cpu().numpy().reshape(h, w, 3)
    want, rays, _ = _render(tables, CFG1_CAM, w, h, spp=spp, depth=depth)
    err = float(np.abs(mean - want).max())
    if not (err <= 1e-5 and frames[-1].dtype == np.uint8 and frames[-1].shape == (h, w, 3)
            and frames[0].max() > 0 and traced > rays):
        raise AssertionError(f"{spp} progressive frames differ from render_image by {err}")

    piped = Renderer(tables, cam(), w, h, depth)
    got = [piped.draw_frame(pipeline=True) for _ in range(spp + 2)]
    if got[0] is not None or not all(np.array_equal(a, b) for a, b in zip(got[1:], frames)):
        raise AssertionError("pipeline=True did not return each frame one call late")

    base = ["-m", "cornell", "-r", f"{w},{h}", "-b", str(depth), *_cam_flags(CFG1_CAM),
            "--device", str(device)]
    with tempfile.TemporaryDirectory() as tmp:
        png = ["--output", f"{tmp}/p.png"]
        prog = cli.run([*base, "--spp", str(spp), "--progressive", *png])
        cli.run([*base, "--spp", str(spp // 2), "--checkpoint", f"{tmp}/a.npz", *png])
        part = cli.run([*base, "--spp", str(spp // 2), "--resume", f"{tmp}/a.npz", *png])
    prog_err = float(np.abs(prog["image"] - mean).max())
    # render_image's mean of spp samples, which the uninterrupted CLI render returns
    resume_err = float(np.abs(part["image"] - want).max())
    emit({"phase": "progressive", "bounces": _mode(),
          "config": f"cornell {w}x{h} depth {depth}: preview + {spp} frames",
          "frame_ms_median": statistics.median(ms[1:]), "frame_ms_min": min(ms[1:]),
          "frame_ms_max": max(ms[1:]), "preview_ms": ms[0], "rays": traced,
          "max_abs_err_vs_render_image": err, "pipeline_equal": True,
          "cli_progressive": {"frames": prog["frames"], "seconds": prog["seconds"],
                              "frame_ms_median": statistics.median(prog["frame_ms"][1:]),
                              "max_abs_err_vs_renderer": prog_err},
          "checkpoint_resume": {"spp": [spp // 2, spp // 2], "max_abs_err_vs_one_render": resume_err,
                                "resume_seconds": part["seconds"]},
          "program_launches": programs, "launches": launches})
    if not (prog["frames"] == spp + 1 and prog_err <= 1e-6 and resume_err <= 1e-6):
        raise AssertionError(f"--progressive differs from the Renderer by {prog_err}, "
                             f"8 + 8 spp resumed from 16 spp by {resume_err}")
    if launches["wave"]["frame_post"] != spp + 1 or programs != spp + 1:
        raise AssertionError(f"{spp + 1} progressive frames made "
                             f"{launches['wave']['frame_post']} frame_post launches in "
                             f"{programs} program launches")
    return check_frame_post(device, size)


def shard_one(want, want_rays: int, paths, reps: int = 2) -> None:
    """Bench cfg1 through ``cli.run`` with ``--shard`` (the mesh of the one
    card) against phase 4's image and rays, bit for bit; ``reps`` renders of
    each path in turns (shard, plain, plain, shard)."""
    from vulkan_raytracer_tpu_torch import cli
    from vulkan_raytracer_tpu_torch.parallel.multihost import make_fleet_mesh

    mesh = make_fleet_mesh()
    runs = {"shard": [], "plain": []}
    shard_launches = None
    with tempfile.TemporaryDirectory() as out_dir:
        for label in ("shard", "plain", "plain", "shard")[:2 * reps]:
            _reset_launches()
            stats = cli.run(CFG1 + (["--shard"] if label == "shard" else [])
                            + ["--device", "cuda", "--output", f"{out_dir}/{label}.png"])
            launches = _launch_counts()
            img = stats["image"]
            runs[label].append({"seconds": stats["seconds"], "rays": stats["rays"],
                                "mrays_per_s": stats["mrays_per_s"],
                                "bit_equal": bool(np.array_equal(img, want)),
                                "max_abs_diff": float(np.abs(img - want).max())})
            if label == "shard" and shard_launches is None:
                shard_launches = launches
    emit({"phase": "shard_one", "bounces": _mode(),
          "config": "cfg1 cornell 512x512 depth 4 64 spp, cli --shard",
          "mesh": [str(d) for d in mesh], "runs": runs,
          "seconds_shard": [r["seconds"] for r in runs["shard"]],
          "seconds_plain": [r["seconds"] for r in runs["plain"]],
          "mrays_per_s_shard": [r["mrays_per_s"] for r in runs["shard"]],
          "mrays_per_s_plain": [r["mrays_per_s"] for r in runs["plain"]],
          "launches": shard_launches})
    for r in runs["shard"]:
        if not (r["bit_equal"] and r["rays"] == want_rays):
            raise AssertionError(f"--shard cfg1 differs from the plain render by {r['max_abs_diff']} "
                                 f"with {r['rays']} rays against {want_rays}; runs {runs}")
    if not all(shard_launches["dense"][c] > 0 for c in ("closest", "shadow", "pdf")):
        raise AssertionError(f"--shard cfg1 missed a kernel: launches {shard_launches}")
    paths.add("shard_one", shard_launches)


def shard_two(device, dragon, paths) -> None:
    """Bench cfg2 through ``render_image_sharded`` on two shards of the one
    card against ``render_image``, in turns (plain, shard, shard, plain)."""
    from vulkan_raytracer_tpu_torch.parallel.sharding import render_image_sharded
    from vulkan_raytracer_tpu_torch.render import renderer
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    w = h = 512
    spp, depth = 4, 4
    mesh = [device, device]

    def cam():
        return Camera(position=np.array(CFG2_CAM[0]), direction=np.array(CFG2_CAM[1]))

    def plain():
        return renderer.render_image(dragon, cam(), w, h, spp=spp, max_depth=depth, tonemap=False)

    def shard():
        return render_image_sharded(dragon, cam(), w, h, spp, depth, mesh, tonemap=False)

    out = {"plain": [], "shard": []}
    images, shard_launches = {}, None
    for label in ("plain", "shard", "shard", "plain"):
        _reset_launches()
        (img, rays), secs = _timed_sync(plain if label == "plain" else shard)
        launches = _launch_counts()
        if label == "shard" and shard_launches is None:
            shard_launches = launches
        images[label] = img
        out[label].append({"seconds": secs, "rays": rays, "mrays_per_s": rays / secs / 1e6})
    err = float(np.abs(images["shard"] - images["plain"]).max())
    per = w * h // len(mesh)
    chunk, band, bands = renderer.band_plan(w, h, spp)
    s_batch = renderer.samples_per_wave(per, spp)
    emit({"phase": "shard_two", "bounces": _mode(),
          "config": "cfg2 dragon 512x512 depth 4 4 spp on [cuda:0, cuda:0]",
          "lanes_per_shard": per, "plain": {"bands": renderer.LAST_RENDER["bands"],
                                            "waves": renderer.LAST_RENDER["waves"],
                                            "lanes_per_wave": chunk * band},
          "per_shard": {"waves": spp // s_batch, "lanes_per_wave": s_batch * per},
          "runs": out, "max_abs_err": err, "bit_equal": bool(np.array_equal(*images.values())),
          "launches": shard_launches, "image_mean": float(images["shard"].mean())})
    rays = {r["rays"] for r in out["plain"] + out["shard"]}
    if not (renderer.LAST_RENDER == {"bands": bands, "waves": bands} == {"bands": 2, "waves": 2}
            and band == per and chunk == s_batch):
        raise AssertionError(f"cfg2 ran {renderer.LAST_RENDER}, planned {(chunk, band, bands)}: "
                             f"not the shards' waves")
    if not (np.array_equal(images["shard"], images["plain"]) and len(rays) == 1):
        raise AssertionError(f"cfg2 on two shards differs from one by {err}, rays {rays}")
    walks = shard_launches["traverse"]
    if not (walks["treelet_closest"] > 0 and walks["treelet_shadow"] > 0
            and shard_launches["dense"]["pdf"] > 0):
        raise AssertionError(f"cfg2 on two shards missed K5' or K3: launches {shard_launches}")
    paths.add("shard_two", shard_launches)


FLEET_TIMEOUT_S = 120  # the fleet's process-group timeout


def fleet_rank(rank: int, world: int, out_dir: str) -> None:
    """One rank of a fleet of ``world`` processes on the card (a spawn
    target): form the gloo group at a file in ``out_dir`` (no TCP port to
    pick), diverge rank 1's tables, broadcast them, warm up, and render cfg1
    through ``render_image_multihost`` between two barriers; then time the
    all-gather of one rank's block alone."""
    import dataclasses
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from vulkan_raytracer_tpu_torch.parallel.multihost import (
        broadcast_scene_tables,
        make_fleet_mesh,
        render_image_multihost,
    )
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    def cam():
        return Camera(position=np.array(CFG1_CAM[0]), direction=np.array(CFG1_CAM[1]))

    dist.init_process_group("gloo", init_method=f"file://{Path(out_dir) / 'rendezvous'}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=FLEET_TIMEOUT_S))
    try:
        device = torch.device("cuda", 0)
        tables = cornell_box_scene().upload(device)
        if rank == 1:  # diverge this rank's scene (tests/_multihost_worker.py:91-98)
            tables = dataclasses.replace(tables, v0=tables.v0._replace(x=tables.v0.x * 2.0))
        tables = broadcast_scene_tables(tables)
        mesh = make_fleet_mesh()
        render_image_multihost(tables, cam(), 64, 64, 2, 4, mesh, tonemap=False)  # warm-up
        _reset_launches()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.time()
        img, rays = render_image_multihost(tables, cam(), 512, 512, 64, 4, mesh, tonemap=False)
        t_own = time.time()
        dist.barrier()
        t1 = time.time()
        launches = _launch_counts()
        # one rank's shard-major block: its shards of ceil(n / len(mesh)) lanes
        block = torch.zeros((len(mesh) // world * -(-512 * 512 // len(mesh)), 3), device=device)
        gather_s = []
        for _ in range(3):
            dist.barrier()
            g0 = time.perf_counter()
            host = block.cpu()
            parts = [torch.empty_like(host) for _ in range(world)]
            dist.all_gather(parts, host)
            torch.cat(parts).numpy()
            gather_s.append(time.perf_counter() - g0)
        np.savez(Path(out_dir) / f"rank{rank}.npz", img=img, rays=rays, t0=t0, t_own=t_own, t1=t1,
                 gather_s=np.array(gather_s), launches=json.dumps(launches),
                 mesh=json.dumps([str(d) for d in mesh]))
    finally:
        dist.destroy_process_group()


def run_fleet(world: int) -> dict:
    """Spawn ``world`` ranks of :func:`fleet_rank` and wait for them; returns
    their results in rank order with the fleet's window (the latest start,
    the earliest end), wall seconds and launches summed over the ranks."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")  # CUDA cannot be set up again in a forked child
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=fleet_rank, args=(r, world, out_dir))
                 for r in range(world)]
        t_spawn = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=FLEET_TIMEOUT_S + 180)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        spawn_to_end = time.perf_counter() - t_spawn
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"the ranks of a fleet of {world} exited with {codes}")
        ranks = [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(world)]
    launches = {"dense": {}, "traverse": {}, "graphs": {}}
    for r in ranks:
        r["launches"] = json.loads(str(r["launches"]))
        for mod in launches:
            for k, n in r["launches"][mod].items():
                launches[mod][k] = launches[mod].get(k, 0) + n
    return {"ranks": ranks, "t0": max(float(r["t0"]) for r in ranks),
            "t1": min(float(r["t1"]) for r in ranks),
            "seconds": max(float(r["t1"]) - float(r["t0"]) for r in ranks),
            "rays": [int(r["rays"]) for r in ranks], "launches": launches,
            "spawn_to_end_seconds": spawn_to_end}


def smi_samples(text: str) -> list:
    """(wall-clock seconds, utilization %) of each ``timestamp,
    utilization.gpu`` line nvidia-smi printed; a line cut short is skipped."""
    from datetime import datetime

    samples = []
    for line in text.splitlines():
        try:
            stamp, util = (p.strip() for p in line.split(","))
            samples.append((datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp(),
                            float(util)))
        except ValueError:
            continue
    return samples


class SmiSampler:
    """The card's utilization (``nvidia-smi utilization.gpu``: the share of
    each sample period with a kernel running) every 100 ms while open."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        self.samples = smi_samples(self.proc.communicate(timeout=30)[0])
        return False

    def busy(self, t0: float, t1: float):
        """Mean utilization (%) of the samples taken within [t0, t1] (wall
        clock), or None without any."""
        got = [u for t, u in self.samples if t0 <= t <= t1]
        return statistics.mean(got) if got else None


def fleet_phase(want, want_rays: int, paths) -> None:
    """Two ranks on the one card, each rendering cfg1 through
    ``render_image_multihost``, against phase 4's image; timed beside one
    process spawned and warmed up the same way (a fleet of one)."""
    with SmiSampler() as smi:
        one = run_fleet(1)
        fleet = run_fleet(2)
    ranks = fleet["ranks"]
    err = float(np.abs(ranks[0]["img"] - want).max())
    emit({"phase": "fleet", "config": "cfg1 cornell 512x512 depth 4 64 spp, 2 gloo ranks on cuda:0",
          "mesh": json.loads(str(ranks[0]["mesh"])), "fleet_seconds": fleet["seconds"],
          "fleet_mrays_per_s": fleet["rays"][0] / fleet["seconds"] / 1e6,
          "rank_render_seconds": [float(r["t_own"]) - float(r["t0"]) for r in ranks],
          "one_process_seconds": one["seconds"],
          "one_process_mrays_per_s": one["rays"][0] / one["seconds"] / 1e6,
          "fleet_over_one": fleet["seconds"] / one["seconds"],
          "card_busy_pct": {"fleet": smi.busy(fleet["t0"], fleet["t1"]),
                            "one_process": smi.busy(one["t0"], one["t1"])},
          "gather_seconds": [float(x) for r in ranks for x in r["gather_s"]],
          "spawn_to_end_seconds": {"fleet": fleet["spawn_to_end_seconds"],
                                   "one_process": one["spawn_to_end_seconds"]},
          "rays": fleet["rays"], "max_abs_err": err, "launches": fleet["launches"],
          "launches_by_rank": [r["launches"] for r in ranks]})
    if not np.array_equal(ranks[0]["img"], ranks[1]["img"]) or len(set(fleet["rays"])) != 1:
        raise AssertionError("the fleet's ranks returned different images or ray counts")
    if not (np.allclose(ranks[0]["img"], want, rtol=1e-5, atol=1e-6)
            and fleet["rays"][0] == want_rays):
        raise AssertionError(f"the fleet's cfg1 differs from one process's by {err}, "
                             f"rays {fleet['rays'][0]} against {want_rays}")
    if not (np.array_equal(one["ranks"][0]["img"], want) and one["rays"][0] == want_rays):
        raise AssertionError("a fleet of one differs from phase 4's cfg1")
    if not all(r["launches"]["dense"][c] > 0 for r in ranks for c in ("closest", "shadow", "pdf")):
        raise AssertionError(f"a fleet rank missed a kernel: {[r['launches'] for r in ranks]}")
    paths.add("fleet", fleet["launches"])


def repack_phase(paths, waves) -> None:
    """The first wave of each ``(label, tables, camera)`` render (512x512,
    depth 4, 4 spp) with the package's rule and with the repack patched off,
    in turns: bit-equal radiance and equal rays; per side the bounces'
    widths and live lanes, K5''s launches with their live lanes and blocks,
    the wall, and the device time from ``torch.profiler``."""
    import torch
    from profile_torch_wave import first_wave, record_bounces, trace_summary, wave

    from vulkan_raytracer_tpu_torch.render import integrator
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    rule = integrator._repack_preferred
    sides = {"repacked": rule, "unsorted": lambda tables: False}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, tables, cam in waves:
        camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]), aspect=1.0)
        lanes, samples, bands = first_wave(tables, 512, 512, 4)
        if not (rule(tables) and bands == 2 and len(lanes) * len(samples) == 2 * 512 * 512):
            raise AssertionError(f"{label}: not a repacked band of 524,288 lanes")
        run = wave(tables, camera, 512, 512, 4, lanes, samples)
        out = {name: {"seconds": []} for name in sides}
        want = None
        try:
            for name in ("repacked", "unsorted", "unsorted", "repacked"):
                integrator._repack_preferred = sides[name]
                _reset_launches()
                t0 = time.perf_counter()
                radiance, rays = run()
                out[name]["seconds"].append(time.perf_counter() - t0)
                launches = _launch_counts()
                if want is None:
                    want = (radiance, rays)
                    paths.add("repack", launches)
                if not (torch.equal(radiance, want[0]) and rays == want[1]):
                    raise AssertionError(f"{label}: the {name} wave differs from the repacked "
                                         f"one by {float((radiance - want[0]).abs().max())}, "
                                         f"rays {rays} against {want[1]}")
                out[name].update(rays=rays, bounce_widths=dict(integrator.BOUNCE_WIDTHS),
                                 k5_launches={k: launches["traverse"][k] for k in
                                              ("treelet_closest", "treelet_shadow")})
            for name, fn in sides.items():
                integrator._repack_preferred = fn
                record = record_bounces(run)
                with torch.profiler.profile(activities=activities) as prof:
                    run()
                trace = trace_summary(prof)
                out[name].update(
                    bounces=[(b["width"], b["live"]) for b in record["bounces"]],
                    k5=[(w["walk"], w["live"], w["live_blocks"], w["blocks"])
                        for w in record["walk_launches"]],
                    device_ms=trace.get("kernel_ms_busy"),
                    k5_device_ms=trace.get("port_kernel_ms", {}).get("treelet_walk_kernel"),
                    k5_in_trace=trace.get("port_kernel_launches", {}).get("treelet_walk_kernel"),
                    aten_ops_top_level=trace["aten_ops_top_level"])
        finally:
            integrator._repack_preferred = rule
        emit({"phase": "repack", "config": f"{label} first wave: {len(lanes)} pixels x samples "
                                           f"{samples}, 512x512 depth 4",
              "bit_equal": True, "rays": want[1], **out,
              "note": "bounces: (width, live lanes); k5: (walk, live lanes, live 128-lane "
                      "blocks, blocks) per launch"})


def graphs_phase(cornell, dragon, bigasset, out_dir: Path):
    """Phase 26: ten configs rendered through the device loops (the
    package's rule), the host-read replay of the same programs
    (:func:`_loops_on_host`) and eagerly (:func:`_eager`): each side once to
    warm up (the programs capture there), then in turns (device, replay,
    eager, eager, replay, device): images bit-equal, rays, each kernel's
    launches, the bounce widths and the alpha loop's counts equal, every
    bounce of the program sides from a program and none of the eager
    side's; per side the wall per frame and per wave and the host
    synchronisations (one more run each, counted from
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings): on the device
    side none while a program launches (``host_syncs_inside_waves``; the
    copies of sample numbers to the card and the frame's reads are
    outside the waves); once the programs captured, their count, seconds,
    the pool's bytes and the mirror's.
    Returns the gallery's and the emitter soup's tables, for phase 27, and
    the largest difference between the device and replay sides' images."""
    import torch
    from profile_torch_wave import LaunchSyncs, count_syncs

    from vulkan_raytracer_tpu_torch import bench
    from vulkan_raytracer_tpu_torch.render import graphs, integrator, renderer
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    def camera(cam, w, h):
        return Camera(position=np.array(cam[0]), direction=np.array(cam[1]), aspect=w / h)

    # each run returns (its images, rays, waves, frames, reads the harness
    # makes beyond the frames' own, and the program launches and the frame
    # tails launched on the stream it must make on a program side)
    def frame(tables, cam, w, h, spp, depth):
        def run():
            img, rays = renderer.render_image(tables, camera(cam, w, h), w, h, spp,
                                              max_depth=depth, tonemap=False)
            waves = renderer.LAST_RENDER["waves"]
            # a frame rendered whole is one program; a banded one a program a
            # wave, then its image
            want = (1, 0) if renderer.LAST_RENDER["bands"] == 0 else (waves, 1)
            return [img], rays, waves, 1, 0, want
        return run

    def first_band(tables, cfg):
        w, h = cfg["w"], cfg["h"]
        vi, pi = renderer.camera_uniforms(camera(cfg["cam"], w, h))
        chunk, per, _ = renderer.band_plan(w, h, cfg["spp"])
        lanes = integrator.block_lanes(w, h, tables.device)[:per]

        def run():  # one read at its end, as render_image's
            with torch.inference_mode():
                acc, rays, _, waves = renderer.render_lanes(tables, vi, pi, w, h, cfg["depth"],
                                                            chunk, 1, lanes, banded=True)
                host = renderer._fetch(acc)
                total, = graphs.settle(rays)
                return [host.numpy().copy()], total, waves, 1, 0, (waves, 0)
        return run

    def progressive(tables, w, h, depth, spp):
        def run():
            r = renderer.Renderer(tables, camera(CFG1_CAM, w, h), w, h, depth)
            frames = [r.draw_frame() for _ in range(spp + 1)]  # the preview, then spp
            accum = renderer._fetch(r.accum)  # read with the ray count: one read
            rays = r.rays_traced
            return frames + [accum.numpy().copy()], rays, spp + 1, spp + 1, 1, (spp + 1, 0)
        return run

    import torch_glb_assets

    cfg5 = next(c for c in bench.CONFIGS if c["key"].startswith("cfg5"))
    multi = cfg5["build"]().upload("cuda")
    soup = emitter_soup_scene(100000, 5000, seed=31).upload("cuda")
    gallery = gallery_scene().upload("cuda")
    textured_scene = _load_glb(torch_glb_assets.write_textured_glb(out_dir), 12, 6)[0]
    textured = textured_scene.upload("cuda")
    textured_bvh = textured_scene.upload("cuda", traversal="bvh")
    alpha_gallery = alpha_gallery_scene().upload("cuda", instancing=True)
    if not (alpha_gallery.has_alpha and alpha_gallery.inst is not None
            and textured_bvh.pbvh.n_treelets == 1):
        raise AssertionError("the alpha gallery or the forced-BVH glb is not what phase 26 needs")
    cases = (
        ("cfg1 cornell 512x512 depth 4 64 spp", cornell, 4,
         frame(cornell, CFG1_CAM, 512, 512, 64, 4)),
        ("cfg2 dragon 512x512 depth 4 4 spp", dragon, 4, frame(dragon, CFG2_CAM, 512, 512, 4, 4)),
        ("cfg5 multi 1920x1080 depth 8: its first band, 64,800 pixels x 8 samples", multi,
         cfg5["depth"], first_band(multi, cfg5)),
        ("emitter soup 512x512 depth 4 4 spp", soup, 4, frame(soup, CFG1_CAM, 512, 512, 4, 4)),
        ("gallery 512x512 depth 4 4 spp", gallery, 4,
         frame(gallery, gallery_camera(), 512, 512, 4, 4)),
        ("progressive cornell 512x512 depth 4: preview + 16 frames", cornell, 4,
         progressive(cornell, 512, 512, 4, 16)),
        ("gltf147k bigasset.glb 512x512 depth 4 4 spp (alpha)", bigasset, 4,
         frame(bigasset, BIGASSET_CAM, 512, 512, 4, 4)),
        ("textured glb 512x512 depth 4 16 spp (alpha)", textured, 4,
         frame(textured, TEXTURED_CAM, 512, 512, 16, 4)),
        ("forced-BVH textured glb 128x128 depth 4 16 spp (alpha, K4')", textured_bvh, 4,
         frame(textured_bvh, TEXTURED_CAM, 128, 128, 16, 4)),
        ("alpha gallery (instanced) 128x128 depth 4 16 spp (alpha)", alpha_gallery, 4,
         frame(alpha_gallery, TEXTURED_CAM, 128, 128, 16, 4)),
    )
    total = {"captured": 0, "capture_s": 0.0}
    sides = {"device": contextlib.nullcontext, "replay": _loops_on_host, "eager": _eager}
    replay_err = 0.0
    for config, tables, depth, run in cases:
        if not graphs._graphs_preferred(tables):
            raise AssertionError(f"{config}: not a scene the graphs run")
        out = {side: {"seconds": []} for side in sides}
        want, images_by_side, captured_first = None, {}, None
        turns = ("device", "replay", "eager", "device", "replay", "eager", "eager", "replay",
                 "device")
        for turn, side in enumerate(turns):
            with sides[side](), _stream_tails() as tails:
                _reset_launches()
                (images, rays, waves, frames, harness_reads, want_programs), secs = _timed_sync(
                    run)
                programs = (graphs.STATS["launches"], len(tails))
                got = (rays, integrator.launch_counts(loops=False, skipped=True),
                       dict(integrator.BOUNCE_WIDTHS), _alpha_loop())
                if captured_first is None:
                    captured_first = graphs.STATS["captured"]
                replays, bounces = graphs.STATS["replays"], _mode()
                program = {k: graphs.STATS[k] for k in ("replays", "passes", "sorts")}
                loop_cond = graphs.LAUNCHES["loop_cond"]
                total["captured"] += graphs.STATS["captured"]
                total["capture_s"] += graphs.STATS["capture_s"]
            if want is None:
                want = (images, got)
                want_program = program
            images_by_side[side] = images
            if side != "eager" and program != want_program:
                raise AssertionError(f"{config}: the {side} program ran {program}, the first "
                                     f"device one {want_program}")
            if not (all(np.array_equal(a, b) for a, b in zip(images, want[0]))
                    and got == want[1]):
                raise AssertionError(f"{config}: the {side} render (turn {turn}) differs from "
                                     f"the first device one: rays, launches, widths and alpha "
                                     f"loop {got} against {want[1]}")
            if bounces != ("eager" if side == "eager" else "graphs"):
                raise AssertionError(f"{config}: the {side} render's bounces ran {bounces}")
            if (loop_cond > 0) != (side == "device"):
                raise AssertionError(f"{config}: the {side} render launched loop_cond_kernel "
                                     f"{loop_cond} times")
            if side != "eager" and programs != want_programs:
                raise AssertionError(f"{config}: the {side} side made {programs[0]} program "
                                     f"launches and {programs[1]} stream launches of the "
                                     f"frame's tail, not {want_programs}")
            if turn >= 3:  # after each side's warm-up
                out[side]["seconds"].append(secs)
            out[side].update(waves=waves, replays=replays, loop_cond_launches=loop_cond,
                             program_launches=programs[0], stream_tails=programs[1])
        replay_err = max(replay_err, max(float(np.abs(a - b).max()) for a, b in zip(
            images_by_side["device"], images_by_side["replay"])))
        for side in sides:
            with sides[side](), LaunchSyncs() as inside:
                _reset_launches()
                syncs, lines = count_syncs(run)
                passes = _alpha_loop()["iterations"]
            o = out[side]
            o.update(seconds_median=statistics.median(o["seconds"]),
                     ms_per_wave=1e3 * statistics.median(o["seconds"]) / o["waves"],
                     host_syncs=syncs, host_syncs_per_wave=syncs / o["waves"],
                     host_syncs_per_frame=(syncs - harness_reads) / frames,
                     host_syncs_inside_waves=inside.count,
                     alpha_passes_per_wave=passes / o["waves"], host_sync_lines=lines)
        if out["device"]["host_syncs_inside_waves"]:
            raise AssertionError(f"{config}: {out['device']['host_syncs_inside_waves']} host "
                                 f"syncs inside the device loops' waves: "
                                 f"{out['device']['host_sync_lines']}")
        if out["device"]["host_syncs_per_frame"] != 1:
            raise AssertionError(f"{config}: {out['device']['host_syncs']} host syncs for "
                                 f"{frames} frames and {harness_reads} reads of the harness, "
                                 f"not one a frame: {out['device']['host_sync_lines']}")
        cache = graphs.cache(tables)
        nodes = bounce_nodes(cache)
        emit({"phase": "graphs", "config": config, "bit_equal": True, "rays": want[1][0],
              "nodes_per_bounce": nodes, "captured_first_frame": captured_first,
              "host_syncs_per_frame": out["device"]["host_syncs_per_frame"],
              "launches": want[1][1], "bounce_widths": want[1][2], "alpha_loop": want[1][3],
              "programs_kept": len(cache.graphs), "pool_bytes": cache.pool_bytes(),
              "mirror_bytes": cache.mirror_bytes(), "max_depth": depth,
              "program": want_program,
              "speedup_median": out["eager"]["seconds_median"] / out["device"]["seconds_median"],
              "replay_over_device": (out["replay"]["seconds_median"]
                                     / out["device"]["seconds_median"]), **out})
    emit({"phase": "graphs_summary", "configs": len(cases), **total,
          "programs_kept": {config.split()[0]: len(graphs.cache(tables).graphs)
                            for config, tables, _, _ in cases},
          "nodes_per_bounce": {config.split()[0]: bounce_nodes(graphs.cache(tables))
                               for config, tables, _, _ in cases},
          "pool_bytes": {config.split()[0]: graphs.cache(tables).pool_bytes()
                         for config, tables, _, _ in cases},
          "mirror_bytes": {config.split()[0]: graphs.cache(tables).mirror_bytes()
                           for config, tables, _, _ in cases},
          "nvidia_smi": nvidia_smi_line()})
    return gallery, soup, replay_err


@contextlib.contextmanager
def _stream_tails():
    """Count the frame's tails launched on the stream: ``wave.frame_image``
    and ``wave.frame_progressive`` called while no program is being
    captured.  Yields the list of their names, one a call."""
    from vulkan_raytracer_tpu_torch.ops import wave
    from vulkan_raytracer_tpu_torch.render import graphs

    calls, kept = [], (wave.frame_image, wave.frame_progressive)

    def counted(fn):
        def call(*args, **kw):
            if graphs.current_capture() is None:
                calls.append(fn.__name__)
            return fn(*args, **kw)
        return call

    wave.frame_image, wave.frame_progressive = map(counted, kept)
    try:
        yield calls
    finally:
        wave.frame_image, wave.frame_progressive = kept


def bounce_nodes(cache) -> dict:
    """Nodes of the parts of one bounce of each program in ``cache``
    (``cudaGraphGetNodes`` on the parts; the tests the stitcher adds aside):
    the bounce loop's body outside its resample loops and re-sort (its
    instance launches' IF bodies in), one pass of its resample loops, its
    re-sort (the IF its closing test sets)."""
    from vulkan_raytracer_tpu_torch.render import graphs

    def parts(nodes, roles):
        n = 0
        for node in nodes:
            if isinstance(node, graphs._Part):
                n += node.graph.nodes() if "bounce" in roles else 0
            elif node.role in roles or "bounce" in roles and node.role in ("phase", "walk"):
                n += parts(node.body, roles if node.role == "phase" else ("bounce",))
        return n

    out = []
    for program in cache.graphs.values():
        phase = next(n for n in program.conds if n.role == "phase")  # in a frame's loop too
        out.append({"bounce": parts(phase.body, ("bounce",)),
                    "alpha_pass": parts([n for n in phase.body if isinstance(n, graphs._Node)
                                         and n.role == "alpha"], ("alpha",)),
                    "sort": parts([n for n in (*phase.body, phase.then)
                                   if isinstance(n, graphs._Node) and n.role == "sort"],
                                  ("sort",))})
    return out


def shade_phase(device, prebuilt: dict, out_dir: Path) -> tuple:
    """Phase 28: the three shading kernels against their plain versions on
    every bounce state of the first wave of each of :data:`SHADE_CONFIGS`
    (``tools/check_torch_shade.py``, eager, so each call runs its Python;
    beside the bench's and the smoke's scenes, the glass sphere under point
    and directional lights and the wall of 1,024 materials whose anisotropy
    rotations span every float32 magnitude):
    bit-equal, or each differing lane named by kernel, field, bounce and
    ulps, class i (<= 4 ulps); a class ii lane fails the phase.  On the
    first waves of :data:`SHADE_TIMED` each kernel's first call (bounce 0,
    every lane live) is timed in a captured graph against its plain version
    eagerly, with its bytes bound.  ``prebuilt`` maps configs to tables the
    smoke already uploaded.  Returns ({kernel: {config: times}}, {kernel:
    largest abs error})."""
    import check_torch_shade as cts

    specs = cts.configs(out_dir)
    times = {f"shade_{k}": {} for k in cts.KERNELS}
    errs = {f"shade_{k}": 0.0 for k in cts.KERNELS}
    for name in SHADE_CONFIGS:
        line = cts.check_config(name, specs[name], device, tables=prebuilt.get(name),
                                timing=name in SHADE_TIMED)
        emit({"phase": "shade", **line})
        if line["by_class"]["ii"] or not line["finite"]:
            raise AssertionError(f"shade {name}: {line['by_class']['ii']} class ii lanes, "
                                 f"finite {line['finite']}: {line['first']}")
        for k in cts.KERNELS:
            errs[f"shade_{k}"] = max(errs[f"shade_{k}"], line["max_abs_err"][k])
            if "timing" in line:
                times[f"shade_{k}"][name] = {**line["timing"][k],
                                             "launches_per_wave": line["launches"][k]}
    return times, errs


def wave_phase(device, prebuilt: dict, out_dir: Path) -> tuple:
    """Phase 29: the wave's three kernels against their plain versions on
    the first wave of each of :data:`WAVE_CONFIGS`
    (``tools/check_torch_wave.py``, eager, so each call runs its Python):
    the primary-ray kernel on every wave, the alpha commit on every
    resample pass of the alpha scenes (the glTF 147k, the textured glb, the
    instanced alpha gallery), the wave's tail (``wave_sum_kernel``: the
    deferred sky, a repacked wave's scatter, the sum) on every wave, cfg1's,
    the repacked cfg2's and cfg5's, cfg4's gate crop under its HDR sky and
    one sample of cfg1's and cfg2's whole frames (``render_sample``) among
    them, each with the radiance asked for and not (the line's
    ``other_flag``); every lane of every field bit-equal, or named by
    kernel, field and ulps as class i (<= 4 ulps); a class ii lane fails,
    and so does any lane of the tail that differs.  On the first waves of
    :data:`WAVE_TIMED` each kernel's first call is timed in a captured
    graph against its plain version eagerly, with its bytes bound, and
    every alpha pass so.  Then the synthetic passes
    (``check_torch_wave.synthetic``): a case that differs fails.
    ``prebuilt`` maps configs to tables the smoke already uploaded.
    Returns ({kernel: {config: times}}, {kernel: largest abs error})."""
    import check_torch_wave as ctw

    specs = ctw.configs(out_dir)
    times = {k: {} for k in ctw.KERNELS}
    errs = {k: 0.0 for k in ctw.KERNELS}
    for name in WAVE_CONFIGS:
        line = ctw.check_config(name, specs[name], device,
                                tables=prebuilt.get(ctw.SAMPLE_WAVES.get(name, name)),
                                timing=name in WAVE_TIMED, sample=name in ctw.SAMPLE_WAVES)
        emit({"phase": "wave", **line})
        if line["by_class"]["ii"] or not line["finite"]:
            raise AssertionError(f"wave {name}: {line['by_class']['ii']} class ii lanes, "
                                 f"finite {line['finite']}: {line['first']}")
        if line["calls"]["primary_rays"] != 1 or bool(
                line["calls"]["alpha_commit"]) != line["alpha"] or line["calls"][
                    "wave_sum"] not in (1, 2) or line["other_flag"]["checks"] != 1:
            raise AssertionError(f"wave {name}: calls {line['calls']}, the tail's other "
                                 f"flag {line['other_flag']}")
        if line["by_kernel"].get("wave_sum_kernel"):
            raise AssertionError(f"wave {name}: the tail differs: {line['first']}")
        for k in ctw.KERNELS:
            errs[k] = max(errs[k], line["max_abs_err"][k])
            if k in line.get("timing", {}):
                times[k][name] = {**line["timing"][k],
                                  "launches_per_wave": line["launches"][k]}
    line = ctw.synthetic(device, timing=True)
    emit({"phase": "wave_synthetic", **line})
    if line["differing"] or line["launches"] != line["checked"]:
        raise AssertionError(f"wave synthetic: {line['differing']}, {line['launches']} "
                             f"launches for {line['checked']} passes")
    return times, errs


def trace_phase(device, prebuilt: dict, out_dir: Path) -> tuple:
    """Phase 30: the four kernels around the traversal launches against
    their plain versions on the first wave of each of :data:`TRACE_CONFIGS`
    (``tools/check_torch_trace.py``, eager, so each call runs its Python):
    every closest hit's finish, every instance step of the gallery and the
    instanced alpha gallery, every re-sort's key and every gather, scatter
    and copy of the repacked scenes; every lane of every field bit-equal:
    a lane that differs at all fails (it is named by kernel, field and
    ulps).  On the first waves of :data:`TRACE_TIMED` one call of each
    kernel is timed in a captured graph, its inputs not in L2, against its
    plain version eagerly, with its bytes bound, and the permutation against
    ``index_select`` over the same columns; every permutation launch so.
    Then the synthetic permutations (``check_torch_trace.synthetic``): a
    case that differs fails.  ``prebuilt`` maps configs to tables the smoke
    already uploaded.  Returns ({kernel: {config: times}}, {kernel: largest
    abs error})."""
    import check_torch_trace as ctt
    import check_torch_wave as ctw

    specs = ctw.configs(out_dir)
    times = {k: {} for k in ctt.KERNELS}
    errs = {k: 0.0 for k in ctt.KERNELS}
    for name in TRACE_CONFIGS:
        line = ctt.check_config(name, specs[name], device, tables=prebuilt.get(name),
                                timing=name in TRACE_TIMED)
        emit({"phase": "trace", **line})
        if line["differing_lanes"] or not line["finite"]:
            raise AssertionError(f"trace {name}: {line['by_class']} differing lanes, "
                                 f"finite {line['finite']}: {line['first']}")
        # an alpha scene's closest hits are finished by its passes' commits
        if bool(line["calls"]["hit_finish"]) == line["alpha"]:
            raise AssertionError(f"trace {name}: calls {line['calls']} (alpha {line['alpha']})")
        for k in ctt.KERNELS:
            errs[k] = max(errs[k], line["max_abs_err"][k])
            if k in line.get("timing", {}):
                times[k][name] = {**line["timing"][k], "launches_per_wave": line["launches"][k]}
    line = ctt.synthetic(device, timing=True)
    emit({"phase": "trace_synthetic", **line})
    if line["differing"] or line["launches"] != 2 * line["checked"] // 3:
        raise AssertionError(f"trace synthetic: {line['differing']}, {line['launches']} "
                             f"gathers and scatters for {line['checked']} cases")
    return times, errs


def walk_ifs_phase(gallery) -> dict:
    """Phase 30's walks: each instance's launch is an IF node its step sets
    (``instance_step_kernel`` counts the lanes that touch the instance's
    box).  The gallery (512x512, 4 spp, depth 4) and the instanced alpha
    gallery (128x128, 16 spp, depth 4) through their programs on the card
    and through the eager mask path (every instance launched, dead lanes
    masked), in turns (device, eager, eager, device): images bit-equal,
    rays equal, each kernel's launches plus those the IFs skipped equal to
    the eager ones; the IFs taken and skipped (one an instance step on the
    device side, some skipped).  Returns each frame's counts."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import instanced
    from vulkan_raytracer_tpu_torch.render import graphs, integrator, renderer
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    alpha = alpha_gallery_scene().upload("cuda", instancing=True)
    out = {}
    for label, tables, cam, size, spp in (
            ("gallery", gallery, gallery_camera(), 512, 4),
            ("alpha_gallery", alpha, TEXTURED_CAM, 128, 16)):
        runs = []
        for side in ("device", "eager", "eager", "device"):
            with contextlib.nullcontext() if side == "device" else _eager():
                _reset_launches()
                camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]))
                (img, rays), secs = _timed_sync(lambda: renderer.render_image(
                    tables, camera, size, size, spp, max_depth=4, tonemap=False))
                runs.append({"side": side, "img": img, "rays": rays, "seconds": secs,
                             "launches": integrator.launch_counts(loops=False, skipped=True),
                             "launched": integrator.launch_counts(loops=False),
                             "steps": instanced.STATS["steps"],
                             "walks": graphs.STATS["walks"],
                             "skipped": graphs.STATS["walks_skipped"]})
        want = runs[1]
        for r in runs:
            if not (np.array_equal(r["img"], want["img"]) and r["rays"] == want["rays"]
                    and r["launches"] == want["launches"]):
                raise AssertionError(f"{label}: the {r['side']} frame differs from the mask "
                                     f"path's: rays {r['rays']} / {want['rays']}, launches "
                                     f"{r['launches']} / {want['launches']}")
        dev = runs[0]
        if not (dev["walks"] == dev["steps"] and 0 < dev["skipped"] < dev["walks"]
                and runs[1]["walks"] == 0):
            raise AssertionError(f"{label}: {dev['walks']} IFs for {dev['steps']} instance "
                                 f"steps, {dev['skipped']} skipped")
        line = {"frame": f"{label} {size}x{size} {spp} spp depth 4", "bit_equal": True,
                "rays": want["rays"], "instance_steps": dev["steps"], "walks": dev["walks"],
                "walks_launched": dev["walks"] - dev["skipped"],
                "walks_skipped": dev["skipped"],
                "seconds": {"device": [dev["seconds"], runs[3]["seconds"]],
                            "eager": [runs[1]["seconds"], runs[2]["seconds"]]},
                "launches_device": dev["launched"], "launches_eager": want["launched"]}
        emit({"phase": "walk_ifs", **line})
        out[label] = line
    del alpha
    torch.cuda.synchronize()
    return out


def busy_waves(cornell, gallery, soup, small, bigasset) -> list:
    """Phase 27's waves, ``profile_torch_wave``'s first wave of the frame of
    cfg1, the gallery, the emitter soup, the forced-BVH dragon of phase 9
    and the glTF 147k: (label, its frame (w, h, spp, depth), its pixels, its
    samples, a function that runs it), each run once here through the
    device loops, which captures its program.  Called before the first ``torch.profiler``
    session: CUPTI traces every rerun of a conditional body's nodes in a
    program instantiated after one, and misses most in a program
    instantiated before any (H6), which phase 27's device-side check
    expects (the frames of phase 26 are frame programs, so these waves'
    programs are first captured here)."""
    from profile_torch_wave import first_wave, wave

    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    out = []
    for label, tables, cam, (w, h, spp, depth) in (
            ("cfg1", cornell, CFG1_CAM, (512, 512, 64, 4)),
            ("gallery", gallery, gallery_camera(), (512, 512, 4, 4)),
            ("emitter soup", soup, CFG1_CAM, (512, 512, 4, 4)),
            ("forced-BVH dragon", small, CFG2_CAM, (32, 32, 2, 3)),
            ("gltf147k", bigasset, BIGASSET_CAM, (512, 512, 4, 4))):
        camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]), aspect=w / h)
        lanes, samples, _ = first_wave(tables, w, h, spp)
        run = wave(tables, camera, w, h, depth, lanes, samples)
        run()
        out.append((label, (w, h, spp, depth), len(lanes), samples, run))
    return out


def graphs_busy(waves: list) -> None:
    """Phase 27, after the profiled timings: one wave each of cfg1, the
    gallery, the emitter soup, the forced-BVH dragon of phase 9 and the
    glTF 147k (``profile_torch_wave``'s first wave of each frame) through
    the device loops, the host-read replay and eager (``waves``:
    :func:`busy_waves`, their programs captured before any profiler
    session), each side warmed up and then once under ``torch.profiler``
    with its counters reset, the card idle for :data:`PROFILE_GAP_S` after
    the trace starts and before it stops.  On the replay and eager sides each hand-written kernel's
    launches in the trace equal the counters' (on the replay side what the
    parts' captures counted, per pass on the glTF wave: the five waves
    launch every kernel variant); on the device side, whose trace misses
    most reruns of a conditional body's nodes, each kernel counted appears and
    none more often than counted (``check_device_trace``;
    ``loop_cond_kernel`` against its counter too), and its bounces, passes
    and re-sorts equal the replay's.  The alpha loop's counts equal on all
    sides.  The busy share: the union of the kernels' intervals over the
    profiled wall (for the device side the replay's kernels over the device
    side's wall), and the program's device time from CUDA events around its
    launch."""
    import torch
    from profile_torch_wave import (ProgramEvents, check_device_trace, check_traced_launches,
                                    trace_summary)

    from vulkan_raytracer_tpu_torch.render import graphs

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    replayed: dict = {}  # counter -> launches over the replay sides
    sides = {"device": contextlib.nullcontext, "replay": _loops_on_host, "eager": _eager}
    for label, (w, h, spp, depth), pixels, samples, run in waves:
        out = {}
        for side, ctx in sides.items():
            with ctx():
                run()
                _reset_launches()
                with torch.profiler.profile(activities=activities) as prof:
                    time.sleep(PROFILE_GAP_S)
                    with ProgramEvents() as events:
                        secs = _timed_sync(run)[1]
                    time.sleep(PROFILE_GAP_S)
                counted, bounces, loop = _launch_counts(), _mode(), _alpha_loop()
                program = {k: graphs.STATS[k] for k in ("replays", "passes", "sorts")}
            if bounces != ("eager" if side == "eager" else "graphs"):
                raise AssertionError(f"{label}: the {side} wave's bounces ran {bounces}")
            if side != "device" and loop != out["device"]["alpha_loop"]:
                raise AssertionError(f"{label}: alpha loop {loop} on the {side} side, "
                                     f"{out['device']['alpha_loop']} through the device loops")
            if side == "replay" and program != out["device"]["program"]:
                raise AssertionError(f"{label}: the replay ran {program}, the device loops "
                                     f"{out['device']['program']}")
            trace = trace_summary(prof)
            counted = {k: n for by_module in counted.values() for k, n in by_module.items()}
            if side == "device":
                traced = check_device_trace(trace, counted, f"{label} {side}")
            else:
                traced = check_traced_launches(trace, counted, f"{label} {side}")
            if side == "replay":
                for k, n in counted.items():
                    replayed[k] = replayed.get(k, 0) + n
            busy = trace.get("kernel_ms_busy", 0.0)
            out[side] = {"profiled_wall_ms": 1e3 * secs, "device_busy_ms": busy,
                         "busy_share": busy / (1e3 * secs), "idle_share": 1 - busy / (1e3 * secs),
                         "device_events": trace["device_events"],
                         "aten_ops_top_level": trace["aten_ops_top_level"],
                         "traced_launches": traced, "alpha_loop": loop, "program": program,
                         "program_ms": events.ms(),
                         "port_kernel_ms": trace.get("port_kernel_ms", {})}
        d = out["device"]
        d["busy_share_from_replay"] = out["replay"]["device_busy_ms"] / d["profiled_wall_ms"]
        emit({"phase": "graphs_busy", "config": f"{label} first wave: {pixels} pixels x "
                                                f"samples {len(samples)}, {w}x{h} depth {depth}",
              "traced_launches_equal_counters": ["replay", "eager"],
              "device_traced_within_counters": True, "profile_gap_s": PROFILE_GAP_S, **out})
    # the frame's tail runs after a frame's waves, not in them
    missing = [name for name, (mod, key, _, _) in KERNELS.items()
               if mod != "graphs" and name != "frame_post" and not _launched(replayed, key)]
    if missing:
        raise AssertionError(f"the replayed waves launched no {missing}: {replayed}")


def time_loop_cond(device, runs: int = 1000, lanes: int = 2 * 512 * 512) -> dict:
    """A test's time, split from the conditional node's relaunch: three
    programs of one WHILE of ``runs`` runs, each launched once through the
    device loops and CUDA-event timed.  ``self``: the body is its closing
    test alone, on one flag (one block), which steps ``b`` and sets the
    condition itself (a run: the relaunch and one node); ``add``: a
    one-thread add (``x += 1``) before that test (the relaunch and two
    nodes); ``flags``: the closing test counts a wave's ``lanes`` flags
    (``loop_cond_kernel``'s grid at the main path's width; the relaunch and
    the counting test).  So a one-thread node costs ``add - self`` a run,
    the relaunch ``2 * self - add`` and the counting test ``flags -
    relaunch`` (``ms``).  The plain version, the host-read replay of the
    ``flags`` program, costs a host read and the host's relaunch a run
    (``plain_ms``); the library's time (``library_ms``) is
    ``live.copy_(active.sum())`` over the same flags, the aten ops the test
    replaced, 100 of them in one captured CUDA graph.  The bound: the flags
    read, ``b``, the row and the accumulator read and written, at the
    card's memory rate."""
    import torch

    from vulkan_raytracer_tpu_torch.render import graphs

    stream = torch.cuda.Stream(device)
    pool = torch.cuda.graph_pool_handle()
    flags = torch.ones(lanes, dtype=torch.bool, device=device)

    def program(kind: str):
        b = torch.zeros((), dtype=torch.int32, device=device)
        x = torch.zeros((), dtype=torch.int32, device=device)
        live = torch.ones(1, dtype=torch.bool, device=device)
        count = flags if kind == "flags" else live
        cap = graphs._Capture(pool, [])
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            cap.begin()
            b.zero_()
            cap.while_(graphs.Cond(count, 0, b, runs - 1, step=True),
                       (lambda: x.add_(1)) if kind == "add" else (lambda: None), "test")
            cap.end()
        torch.cuda.current_stream(device).wait_stream(stream)
        return graphs._Program(cap.nodes, cap.conds, {"active": live}, (), []), b

    def timed(prog, device_loops: bool) -> float:
        prog.launch(device_loops)  # warm: instantiates
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        prog.launch(device_loops)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    progs = {kind: program(kind) for kind in ("self", "add", "flags")}
    t = {kind: timed(prog, True) for kind, (prog, _) in progs.items()}
    plain = timed(progs["flags"][0], False)
    for kind, (_, b) in progs.items():
        if int(b) != runs:
            raise AssertionError(f"the timed {kind} loop ran {int(b)} times, not {runs}")
    graphs.settle()
    live = torch.zeros((), dtype=torch.int64, device=device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(100):
            live.copy_(flags.sum())
    library = time_ms(graph.replay, 3) / 100
    node = (t["add"] - t["self"]) / runs
    relaunch = (2 * t["self"] - t["add"]) / runs
    nbytes = lanes + 2 * 4 + 2 * 32 + 2 * 8
    return {"ms": t["flags"] / runs - relaunch, "plain_ms": plain / runs, "library_ms": library,
            "relaunch_ms": relaunch, "one_thread_node_ms": node,
            "relaunch_and_test_ms": t["flags"] / runs,
            "program_ms": t, "replay_ms": plain,
            "shape": f"a WHILE of {runs} runs; the test counts {lanes:,} flags",
            **bound(0, nbytes)}


def bvh_vs_dense(device) -> None:
    """The BVH walks against the dense kernels over one 60,000-triangle soup."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    tables = soup_scene(60000, seed=11).upload(device, traversal="bvh")
    n = 32768
    rays = make_rays(n, seed=12, device=device)
    o, d, active = rays["o"], rays["d"], rays["active"]
    t_b, tri_b, _, _ = tr.bvh_closest(tables, o, d, t_min=rays["t_min"], t_max=rays["t_max"],
                                      active=active)
    t_d, tri_d, _, _ = dense.dense_closest(tables, o, d, t_min=rays["t_min"],
                                           t_max=rays["t_max"], active=active)
    flags = float(((tri_b >= 0) == (tri_d >= 0)).float().mean())
    same = (tri_b == tri_d) & (tri_b >= 0)
    t_equal = torch.equal(t_b[same], t_d[same])
    occ_b = tr.bvh_shadow(tables, o, d, t_max=rays["t_shadow"], active=active)
    occ_d = dense.dense_shadow(tables, o, d, t_max=rays["t_shadow"], active=active)
    occ_flags = float((occ_b == occ_d).float().mean())
    emit({"phase": "bvh_vs_dense", "triangles": tables.num_triangles,
          "treelets": tables.pbvh.n_treelets, "rays": n, "hits": int((tri_d >= 0).sum()),
          "hit_flags_equal": flags, "same_triangle": float(same.sum() / (tri_d >= 0).sum()),
          "t_bit_equal_where_same": t_equal, "occlusion_flags_equal": occ_flags})
    if flags < 0.9999 or occ_flags < 0.9999 or not t_equal:
        raise AssertionError("the BVH walks disagree with the dense kernels")


# mangled-name fragment of each kernel entry -> kernel variant
_ENTRIES = {"closest_kernel": "dense_closest", "shadow_kernel": "dense_shadow",
            "pdf_kernel": "dense_emissive_pdf",
            "bvh_walk_kernelILb0": "bvh_walk_closest", "bvh_walk_kernelILb1": "bvh_walk_shadow",
            "treelet_walk_kernelILb0": "treelet_walk_closest",
            "treelet_walk_kernelILb1": "treelet_walk_shadow",
            "emissive_walk_kernel": "emissive_walk", "loop_cond_kernel": "loop_cond_kernel",
            "shade_hit_kernel": "shade_hit", "shade_scatter_kernel": "shade_scatter",
            "shade_resolve_kernel": "shade_resolve", "primary_rays_kernel": "primary_rays",
            "alpha_commit_kernel": "alpha_commit", "wave_sum_kernel": "wave_sum",
            "frame_post_kernel": "frame_post", "hit_finish_kernel": "hit_finish",
            "instance_step_kernel": "instance_step", "coherence_key_kernel": "coherence_key",
            "permute_kernel": "permute"}


def ptxas_table(report: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel variant from
    ptxas's -v report; a kernel built in several instances (a template's)
    takes the most of each figure over them."""
    table, name, row = {}, None, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in _ENTRIES.items() if k in line), None)
        elif name and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            row = dict(zip(("stack_frame", "spill_stores", "spill_loads"), nums))
        elif name and row is not None and "Used" in line and "registers" in line:
            row["registers"] = int(line.split("Used")[1].split()[0])
            table[name] = {k: max(v, table.get(name, {}).get(k, 0)) for k, v in row.items()}
            name, row = None, None
    return table


def _launch_counts(loops: bool = True):
    """Each kernel's launches since the last reset, by module; with
    ``loops``, ``loop_cond_kernel``'s (``graphs``), which only the device
    loops launch."""
    from vulkan_raytracer_tpu_torch.render import integrator

    return integrator.launch_counts(loops)


def _reset_launches() -> None:
    """Zero the launch counters, the instance steps, the alpha loop, the
    bounce widths and the programs' stats, once the device loops' counts so
    far are in."""
    from vulkan_raytracer_tpu_torch.render import graphs, integrator

    integrator.reset_counters()
    graphs.reset_stats()


def _mode() -> str:
    """How the bounces since the last :func:`_reset_launches` ran:
    "graphs" (replayed from captured CUDA graphs), "eager", or both (a
    card-vs-CPU phase: the CPU runs eagerly)."""
    from vulkan_raytracer_tpu_torch.render import graphs, integrator

    replays = graphs.STATS["replays"]
    eager = sum(integrator.BOUNCE_WIDTHS.values()) - replays
    return "+".join(m for m, n in (("graphs", replays), ("eager", eager)) if n) or "none"


def _alpha_loop() -> dict:
    """Iterations of the alpha resample loop per ``_closest`` call since the
    last reset."""
    from vulkan_raytracer_tpu_torch.render.integrator import ALPHA_LOOP

    calls = ALPHA_LOOP["calls"]
    return {"closest_calls": calls, "iterations": ALPHA_LOOP["iterations"],
            "mean": ALPHA_LOOP["iterations"] / calls if calls else 0.0,
            "max": ALPHA_LOOP["max"]}


def _launched(counts: dict, key) -> int:
    """The launches a kernel's counter key (or keys, summed) holds in ``counts``."""
    return sum(counts.get(k, 0) for k in (key if isinstance(key, tuple) else (key,)))


class PathLaunches:
    """Each kernel's launches in the runs of the paths the smoke drives with
    reset counters, in all and by the phase that drove the path."""

    def __init__(self):
        self.total = {name: 0 for name in KERNELS}
        self.by_path = {name: {} for name in KERNELS}

    def add(self, phase: str, launches: dict) -> None:
        for name, (mod, key, _, _) in KERNELS.items():
            n = _launched(launches.get(mod, {}), key)
            if n:
                self.total[name] += n
                self.by_path[name][phase] = self.by_path[name].get(phase, 0) + n


def render_cfg2(reps: int) -> dict:
    """Bench cfg2 through the CLI, ``reps`` times; returns the launches of
    the last run."""
    from vulkan_raytracer_tpu_torch import cli

    runs = []
    with tempfile.TemporaryDirectory() as out_dir:
        for _ in range(reps):
            _reset_launches()
            stats = cli.run(CFG2 + ["--device", "cuda", "--output", f"{out_dir}/cfg2.png"])
            launches = _launch_counts()
            img = stats["image"]
            walks = launches["traverse"]
            if not (walks["treelet_closest"] > 0 and walks["treelet_shadow"] > 0
                    and launches["dense"]["pdf"] > 0):
                raise AssertionError(f"cfg2 render missed K5' or K3: launches {launches}")
            if not np.isfinite(img).all() or img.shape != (512, 512, 3):
                raise AssertionError(f"cfg2 image not finite or misshapen: {img.shape}")
            if not img.mean() > 1e-3:
                raise AssertionError(f"cfg2 image is black (mean {img.mean()})")
            runs.append(stats)
            emit({"phase": "render_cfg2", "bounces": _mode(),
                  "config": "cfg2 dragon 512x512 depth 4 4 spp",
                  "seconds": stats["seconds"], "rays": stats["rays"],
                  "mrays_per_s": stats["mrays_per_s"], "upload": stats["upload"],
                  "launches": launches, "image_mean": float(img.mean())})
    secs = [r["seconds"] for r in runs]
    rates = [r["mrays_per_s"] for r in runs]
    emit({"phase": "render_cfg2_summary", "renders": reps, "rays": runs[0]["rays"],
          "seconds_median": statistics.median(secs), "seconds_min": min(secs),
          "seconds_max": max(secs), "mrays_per_s_median": statistics.median(rates),
          "mrays_per_s_min": min(rates), "mrays_per_s_max": max(rates),
          "upload_seconds": [r["upload"]["seconds"] for r in runs]})
    return launches


def bench_phase(paths) -> list:
    """The port's bench with one rep of each config: every config's gate
    against its committed golden, its warm-up frame and one timed frame,
    which must launch its kernels, capture no graph, trace a plausible count
    of rays and have the band plan of ``render_image``; cfg1 is the built-in
    box.  Every frame's linear accumulation must be finite (the bench's uint8
    frames cannot show a value that is not), and cfg5's two whole frames
    lit.  Returns the configs' lines, cfg1 first."""
    import torch

    from vulkan_raytracer_tpu_torch import bench
    from vulkan_raytracer_tpu_torch.render import renderer

    frames = []
    render_image = renderer.render_image

    def checked(tables, camera, width, height, spp, *args, **kw):
        out = render_image(tables, camera, width, height, spp, *args, **kw)
        acc = renderer.LAST_SUM["sum"]  # the frame's linear sum, after its read
        frames.append((acc.shape[0], bool(torch.isfinite(acc).all()), float(acc.mean()) / spp))
        return out

    renderer.render_image = checked
    try:
        others, c1, summary = bench.run(torch.device("cuda", 0), reps=1)
    finally:
        renderer.render_image = render_image
    if c1.key != "cfg1_cornell_builtin_512x512_d4_64spp":
        raise AssertionError(f"the bench rendered {c1.key}, expected the built-in box")
    # each config: gate crop, warm-up frame, rep
    if len(frames) != 15 or not all(finite for _, finite, _ in frames):
        raise AssertionError(f"the bench's frames (pixels, finite, mean): {frames}")
    lines = []
    for c in (c1, *others):
        line, cfg = c.line(), c.cfg
        lines.append(line)
        name = c.key[:4]
        w, h, spp, depth = cfg["w"], cfg["h"], cfg["spp"], cfg["depth"]
        plan = chunk, _, bands = renderer.band_plan(w, h, spp)
        if name == "cfg1":
            bands, chunk = 0, renderer.samples_per_wave(w * h, spp)
        if name == "cfg5" and plan != (8, 64800, 32):
            raise AssertionError(f"cfg5 planned {plan}: expected 32 bands of 64,800 x 8")
        want = {"bands": bands, "waves": max(bands, 1) * -(-spp // chunk)}
        if line["graphs_captured"] != [0]:  # the bench raises first
            raise AssertionError(f"{c.key}: the timed rep captured {line['graphs_captured']}")
        if {k: line[k] for k in want} != want or len(c.times) != 1:
            raise AssertionError(f"{c.key}: {len(c.times)} reps of {line['bands']} bands and "
                                 f"{line['waves']} waves, expected one rep of {want}")
        # every lane traces its camera ray; a path adds at most 3 rays a bounce
        if not w * h * spp <= line["rays"] <= w * h * spp * 3 * (depth + 1):
            raise AssertionError(f"{c.key} traced {line['rays']} rays for {w * h * spp} lanes")
        paths.add(f"bench_{name}", line["launches"])
        emit({"phase": "bench", **line})
    lit = [mean for n, _, mean in frames if n == 1920 * 1080]
    if not (len(lit) == 2 and min(lit) > 1e-3):
        raise AssertionError(f"cfg5's frame is black (linear means {lit})")
    emit({"phase": "bench_summary", **summary})
    return lines


def _cuda_vs_cpu(tables, cam_args, label, size: int = 32, spp: int = 2, depth: int = 3,
                 golden=None):
    """The same frame (32x32, 2 spp, depth 3 unless told) on the card and on
    the CPU, through ``tools/torch_lane_diff.py``: the RMSE under the bar and
    the ray counts within 0.1%; then the pixels that differ by more than 1e-6
    and their lanes, each lane's first bounce, field and (named by the tool)
    aten op; with a ``golden`` image, each side's RMSE against it.  A lane of
    class ii (a fault: an integer or a flag first, a NaN, an op not named or
    more than 4 ulps at its output, a result that depends on the wave it ran
    in) fails the phase."""
    import torch_lane_diff

    res = torch_lane_diff.diagnose(tables, cam_args, size, size, spp, depth)
    (img_gpu, img_cpu), (rays_gpu, rays_cpu) = res["images"], res["rays"]
    rmse = float(np.sqrt(np.mean((img_gpu - img_cpu) ** 2)))
    if not (np.isfinite(img_gpu).all() and img_gpu.shape == (size, size, 3)):
        raise AssertionError(f"{label}: the {size}x{size} render on the card is not finite "
                             "or misshapen")
    if not rmse < RMSE_BAR:
        raise AssertionError(f"{label}: port on cuda vs port on cpu RMSE {rmse} >= {RMSE_BAR}")
    if abs(rays_gpu - rays_cpu) > 1e-3 * rays_cpu:
        raise AssertionError(f"{label}: ray counts differ: {rays_gpu} on cuda, {rays_cpu} on cpu")
    out = {"rmse": rmse, "bar": RMSE_BAR, "rays_cuda": rays_gpu, "rays_cpu": rays_cpu,
           "differing_pixels": res["differing_pixels"],
           "differing_lanes": res["differing_lanes"],
           "lanes_by_class": res["by_class"], "first_bounce": res["by_first_bounce"],
           "lanes_by_field": res["by_field"], "lanes_by_op": res["by_op"],
           "attribution_s": res["attribution_s"], "lanes": res["lanes"][:8]}
    if golden is not None:
        out["rmse_vs_golden"] = {"cuda": _rmse(img_gpu, golden), "cpu": _rmse(img_cpu, golden)}
    if res["void"] or res["by_class"]["ii"]:
        faults = [x for x in res["lanes"] if x["class"] == "ii"]
        raise AssertionError(f"{label}: {len(faults)} lanes of class ii, wave-dependent lanes "
                             f"{res['wave_dependent_lanes']}: {faults[:4]}")
    return out


def cfg4_parity(device) -> None:
    """The bench's cfg4 (the hall under its HDR sky) at its gate crop, 16x16,
    2 spp, depth 3, on the card against the CPU; each side's RMSE against the
    crop's committed oracle golden beside."""
    from vulkan_raytracer_tpu_torch import bench

    cfg = next(c for c in bench.CONFIGS if c["key"].startswith("cfg4"))
    cw, cspp, cdepth = cfg["crop"]
    tables = cfg["build"]().upload(device)
    _reset_launches()
    res = _cuda_vs_cpu(tables, cfg["cam"], "cfg4 gate crop", cw, cspp, cdepth,
                       golden=bench.load_goldens()[f"golden_{cfg['key']}"])
    launches = _launch_counts()
    if not (launches["traverse"]["treelet_closest"] > 0 and launches["dense"]["pdf"] > 0):
        raise AssertionError(f"the cfg4 crop missed K5' or K3: launches {launches}")
    emit({"phase": "cfg4_parity", "bounces": _mode(),
          "config": f"cfg4 hall + sky {cw}x{cw} {cspp} spp depth {cdepth}",
          "launches": launches, **res})


def _load_glb(path, triangles: int, textures: int):
    """Scene.load_model on a generated container; checks its counts, that
    no texture fell back to the loader's 1x1 white texel, and the flags.
    Returns (scene, load seconds)."""
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Scene

    t0 = time.perf_counter()
    scene = Scene()
    scene.load_model(path)
    secs = time.perf_counter() - t0
    shapes = [t.shape for t in scene.textures]
    if len(shapes) != textures or any(s[:2] == (1, 1) for s in shapes):
        raise AssertionError(f"{path.name}: textures {shapes}, expected {textures} decoded")
    n_tris = sum(p.indices.shape[0] // 3 for node in scene.iter_depth_first() if node.mesh >= 0
                 for p in scene.mesh_pool[node.mesh])
    if n_tris != triangles:
        raise AssertionError(f"{path.name}: {n_tris} triangles, expected {triangles}")
    return scene, secs


def gltf_dense(out_dir: Path, paths: PathLaunches) -> None:
    """The small textured glb: loader checks, then the CLI render on cuda."""
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch import cli

    glb = torch_glb_assets.write_textured_glb(out_dir)
    scene, load_s = _load_glb(glb, triangles=12, textures=6)
    if scene.textures[1].shape != (8, 8, 4):
        raise AssertionError(f"the JPEG texture decoded to {scene.textures[1].shape}")
    tables = scene.upload("cpu")
    if not (tables.has_alpha and tables.has_blend and tables.has_textures):
        raise AssertionError("textured glb: alpha, blend or textures not flagged")
    _reset_launches()
    stats = cli.run(["-m", str(glb), *GLTF_DENSE, "--device", "cuda",
                     "--output", str(out_dir / "textured.png")])
    launches, loop, bounces = _launch_counts(), _alpha_loop(), _mode()
    img = stats["image"]
    if not (launches["dense"]["closest"] > 0 and launches["dense"]["pdf"] > 0):
        raise AssertionError(f"textured glb render missed K1 or K3: launches {launches}")
    if bounces != "graphs" or not loop["closest_calls"]:
        raise AssertionError(f"textured glb render: bounces {bounces}, alpha loop {loop}")
    if not np.isfinite(img).all() or img.shape != (512, 512, 3) or not img.mean() > 1e-3:
        raise AssertionError(f"textured glb image not finite, misshapen or black: "
                             f"{img.shape} mean {img.mean()}")
    paths.add("gltf_dense", launches)
    emit({"phase": "gltf_dense", "bounces": bounces,
          "config": "textured.glb 512x512 depth 4 16 spp",
          "triangles": tables.num_triangles, "textures": [list(t.shape) for t in scene.textures],
          "emissive": tables.num_emissive_tris, "load_seconds": load_s,
          "seconds": stats["seconds"], "rays": stats["rays"],
          "mrays_per_s": stats["mrays_per_s"], "alpha_loop": loop, "launches": launches,
          "image_mean": float(img.mean())})


def gltf_bvh(out_dir: Path, paths: PathLaunches, reps: int) -> None:
    """The 147,136-triangle glb through the CLI on cuda, ``reps`` times."""
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch import cli

    glb = torch_glb_assets.write_bigasset_glb(out_dir, big=True)
    _load_glb(glb, triangles=147136, textures=5)
    runs = []
    for _ in range(reps):
        _reset_launches()
        stats = cli.run(["-m", str(glb), *GLTF_BVH, "--device", "cuda",
                         "--output", str(out_dir / "bigasset.png")])
        launches, loop, bounces = _launch_counts(), _alpha_loop(), _mode()
        img = stats["image"]
        if not (launches["traverse"]["treelet_closest"] > 0 and launches["dense"]["pdf"] > 0):
            raise AssertionError(f"bigasset render missed K5' closest or K3: launches {launches}")
        if bounces != "graphs" or not loop["closest_calls"]:
            raise AssertionError(f"bigasset render: bounces {bounces}, alpha loop {loop}")
        if not np.isfinite(img).all() or img.shape != (512, 512, 3) or not img.mean() > 1e-3:
            raise AssertionError(f"bigasset image not finite, misshapen or black: "
                                 f"{img.shape} mean {img.mean()}")
        runs.append(stats)
        emit({"phase": "gltf_bvh", "bounces": bounces,
              "config": "bigasset.glb (147,136 tris) 512x512 depth 4 4 spp",
              "load_seconds": stats["load_seconds"], "upload": stats["upload"],
              "seconds": stats["seconds"], "rays": stats["rays"],
              "mrays_per_s": stats["mrays_per_s"], "alpha_loop": loop, "launches": launches,
              "image_mean": float(img.mean())})
    paths.add("gltf_bvh", launches)
    secs = [r["seconds"] for r in runs]
    rates = [r["mrays_per_s"] for r in runs]
    emit({"phase": "gltf_bvh_summary", "renders": reps, "rays": [r["rays"] for r in runs],
          "seconds_median": statistics.median(secs), "seconds": secs,
          "mrays_per_s_median": statistics.median(rates), "mrays_per_s": rates,
          "load_seconds": [r["load_seconds"] for r in runs],
          "upload_seconds": [r["upload"]["seconds"] for r in runs]})


def gltf_parity(out_dir: Path, device, paths: PathLaunches) -> None:
    """Both containers on the card against the same render on the CPU; the
    small one also on the BVH path (one treelet, so K4')."""
    import torch_glb_assets

    small = torch_glb_assets.write_textured_glb(out_dir)
    big = torch_glb_assets.write_bigasset_glb(out_dir, big=True)
    cases = (("textured.glb dense", small, "auto", TEXTURED_CAM),
             ("textured.glb forced BVH", small, "bvh", TEXTURED_CAM),
             ("bigasset.glb", big, "auto", BIGASSET_CAM))
    for label, glb, traversal, cam in cases:
        scene, _ = _load_glb(glb, triangles=12 if glb is small else 147136,
                             textures=6 if glb is small else 5)
        tables = scene.upload(device, traversal=traversal)
        _reset_launches()
        res = _cuda_vs_cpu(tables, cam, label)
        launches = _launch_counts()
        if traversal == "bvh":
            if tables.pbvh.n_treelets != 1 or not launches["traverse"]["bvh_closest"] > 0:
                raise AssertionError(f"{label}: missed K4' closest: launches {launches}")
            paths.add("gltf_parity", launches)
        emit({"phase": "gltf_parity", "bounces": _mode(), "config": f"{label} 32x32 2 spp depth 3",
              "triangles": tables.num_triangles, "launches": launches, **res})


def main() -> int:
    if not (ROOT / "vulkan_raytracer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the vulkan_raytracer_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    # the JSON lines carry what the log lines and the loader's progress bars
    # would print; keep the output to them and to warnings
    os.environ.setdefault("VKRT_LOG_LEVEL", "WARN")
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke test needs an NVIDIA card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    from vulkan_raytracer_tpu_torch.accel import native
    from vulkan_raytracer_tpu_torch.ops import _ext

    t0 = time.perf_counter()
    lib_path = _ext.build()
    lib = _ext.library()
    t1 = time.perf_counter()
    builder = "native (g++)" if native.get_lib() is not None else "numpy"
    ptxas = ptxas_table(_ext.ptxas_report())
    driver, runtime = ctypes.c_int(), ctypes.c_int()
    _ext.check(lib, lib.graph_loops_versions(ctypes.byref(driver), ctypes.byref(runtime)),
               "graph_loops_versions")
    emit({"phase": "build", "seconds": t1 - t0, "library": lib_path.name,
          "bvh_builder": builder, "bvh_builder_seconds": time.perf_counter() - t1,
          "cuda_driver": driver.value, "cuda_runtime": runtime.value,
          "torch_keep_graph": hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"),
          "ptxas": ptxas})
    if set(ptxas) != set(KERNELS):
        raise AssertionError(f"ptxas reported {sorted(ptxas)}, expected every kernel variant")
    for name in KERNELS:
        if any(ptxas[name][k] for k in ("stack_frame", "spill_stores", "spill_loads")):
            raise AssertionError(f"{name} uses the stack: {ptxas[name]}")

    # 8. the port's bench, one rep of each config behind its gate, first: a
    # process that has run other work renders as a fresh one only if none of
    # it was a torch.profiler session (the profiled timings come last)
    paths = PathLaunches()
    bench_phase(paths)

    # 3. dense kernels
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    cornell = cornell_box_scene().upload(device)
    soup = soup_scene(1000, seed=7).upload(device)
    n_wave = 2 * 512 * 512  # lanes of one cfg1 or cfg2 wave
    # the cfg1 wave, and a ragged count whose last block is partly past the rays
    errs = check_kernels({"cornell": cornell, "soup1000": soup}, (n_wave, n_wave - 37), device)

    # 4. render: the CLI's headless path for bench cfg1
    from vulkan_raytracer_tpu_torch import cli

    from vulkan_raytracer_tpu_torch.render import integrator, renderer

    with tempfile.TemporaryDirectory() as out_dir, _plain_shading_forbidden():
        _reset_launches()
        stats = cli.run(CFG1 + ["--device", "cuda", "--output", f"{out_dir}/cfg1.png"])
        launches = _launch_counts()
    img = cfg1_img = stats["image"]
    cfg1_rays = stats["rays"]
    cfg1_widths = dict(integrator.BOUNCE_WIDTHS)
    if not all(launches["dense"][c] > 0 for c in ("closest", "shadow", "pdf")):
        raise AssertionError(f"cfg1 render missed a kernel: launches {launches}")
    if integrator._repack_preferred(cornell) or set(cfg1_widths) != {n_wave}:
        raise AssertionError(f"cfg1 ran a repacked wavefront: bounce widths {cfg1_widths}")
    if set(launches["shade"].values()) != {sum(cfg1_widths.values())}:
        raise AssertionError(f"cfg1's {sum(cfg1_widths.values())} bounces launched the shading "
                             f"kernels {launches['shade']} times")
    if launches["trace"]["hit_finish"] != sum(cfg1_widths.values()):
        raise AssertionError(f"cfg1's {sum(cfg1_widths.values())} bounces launched the hit "
                             f"finish {launches['trace']['hit_finish']} times")
    if launches["wave"]["primary_rays"] != renderer.LAST_RENDER["waves"]:
        raise AssertionError(f"cfg1's {renderer.LAST_RENDER['waves']} waves launched the "
                             f"primary-ray kernel {launches['wave']['primary_rays']} times")
    if not np.isfinite(img).all() or img.shape != (512, 512, 3):
        raise AssertionError(f"cfg1 image not finite or misshapen: {img.shape}")
    if not img.mean() > 1e-3:
        raise AssertionError(f"cfg1 image is black (mean {img.mean()})")
    emit({"phase": "render", "bounces": _mode(), "config": "cfg1 cornell 512x512 depth 4 64 spp",
          "seconds": stats["seconds"], "rays": stats["rays"], "bounce_widths": cfg1_widths,
          "mrays_per_s": stats["mrays_per_s"], "launches": launches,
          "image_mean": float(img.mean())})
    paths.add("render", launches)

    # 5. walks: K4' and K5' against their plain versions on the cfg2 dragon
    # and on the 147,136-triangle glTF, with their times and bounds
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch.scene import procedural

    dragon_scene = procedural.dragon_scene()
    dragon = dragon_scene.upload(device)
    with tempfile.TemporaryDirectory() as tmp:
        glb = torch_glb_assets.write_bigasset_glb(Path(tmp), big=True)
        bigasset = _load_glb(glb, triangles=147136, textures=5)[0].upload(device)
        walk_times = {}
        for label, tables, cam in (("cfg2", dragon, CFG2_CAM),
                                   ("gltf147k", bigasset, BIGASSET_CAM)):
            if not tables.pbvh.nbytes <= STREAM_BYTES_MAX:
                raise AssertionError(f"{label}: the BVH streams take {tables.pbvh.nbytes} bytes")
            for name, e in check_walks(tables, (n_wave, n_wave - 37), device, label,
                                       cam).items():
                errs[name] = max(errs.get(name, 0.0), e)
            walk_times[label] = time_walks(tables, n_wave, device, label, cam)
        times = dict(walk_times["cfg2"])

    # 6. the BVH walks against the dense kernels
    bvh_vs_dense(device)

    # 7. render: the CLI's headless path for bench cfg2 (K5' and K3)
    paths.add("render_cfg2", render_cfg2(reps=2))

    # 9. a small scene forced onto the BVH path: one treelet, so K4'
    small = procedural.dragon_scene(detail=12).upload(device, traversal="bvh")
    if small.pbvh.n_treelets != 1:
        raise AssertionError(f"the forced-BVH dragon has {small.pbvh.n_treelets} treelets")
    _reset_launches()
    forced = _cuda_vs_cpu(small, CFG2_CAM, "forced-BVH dragon")
    launches = _launch_counts()
    if not (launches["traverse"]["bvh_closest"] > 0 and launches["traverse"]["bvh_shadow"] > 0):
        raise AssertionError(f"the forced-BVH render missed K4': launches {launches}")
    paths.add("bvh_forced", launches)
    emit({"phase": "bvh_forced", "bounces": _mode(),
          "config": "dragon detail 12 (712 tris) 32x32 2 spp depth 3",
          "triangles": small.num_triangles, "launches": launches, **forced})

    # 10. cpu: the Cornell render through the plain versions on the CPU, which
    # the CPU tests hold against the JAX renderer and its NumPy oracle
    cpu = _cuda_vs_cpu(cornell, ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0]), "cornell")
    emit({"phase": "cpu", "config": "cornell 32x32 2 spp depth 3", **cpu})

    # 10b. cfg4's gate crop on the card against the CPU
    cfg4_parity(device)

    # 11-13. glTF: the generated containers through the loader, the alpha
    # loop and the texture slots, on the card
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp)
        gltf_dense(out_dir, paths)
        gltf_bvh(out_dir, paths, reps=2)
        gltf_parity(out_dir, device, paths)

    # 14. the emissive-pdf walk against its plain version, and its time
    emitters = soup_scene(20000, seed=17).upload(device)
    errs["emissive_walk"] = check_emissive_walk(emitters, (n_wave, n_wave - 37), device)
    times["emissive_walk"] = time_emissive_walk(emitters, n_wave, device)
    del emitters

    # 15. a render whose pdf probes walk the emissive BVH, each probe held
    # against the plain version
    soup_probes = render_emissive_bvh(device, paths)
    errs["emissive_walk"] = max(errs["emissive_walk"], soup_probes["max_abs_err"])

    # 17-21. instanced and dynamic scenes, and the progressive renderer
    instanced_parity(device, (n_wave, n_wave - 37))
    gallery, gallery_tables = render_instanced(device, paths)
    instanced_vs_flattened(device)
    refit_phase(device, paths, dragon_scene, dragon, gallery, gallery_tables)
    del dragon_scene, gallery, gallery_tables
    frame_post = progressive_phase(device, paths)
    errs["frame_post"] = frame_post["max_abs_err"]
    times["frame_post"] = {**frame_post["progressive"], "library_ms": None,
                           "by_mode": {k: frame_post[k] for k in ("image", "progressive")}}

    # 22-24. pixel sharding: --shard on the one card, two shards on it, and a
    # fleet of two processes
    shard_one(cfg1_img, cfg1_rays, paths)
    shard_two(device, dragon, paths)
    fleet_phase(cfg1_img, cfg1_rays, paths)

    # 26. the device loops against the host-read replay and eager, before any
    # profiler session
    with tempfile.TemporaryDirectory() as tmp:
        gallery_tables, soup_tables, errs["loop_cond_kernel"] = graphs_phase(
            cornell, dragon, bigasset, Path(tmp))

    # 28. the shading kernels against their plain versions on real waves,
    # timed, before any profiler session
    with tempfile.TemporaryDirectory() as tmp:
        shade_times, shade_errs = shade_phase(
            device, {"cfg1": cornell, "cfg2": dragon, "gltf147k": bigasset,
                     "gallery": gallery_tables, "soup": soup_tables}, Path(tmp))
    errs.update(shade_errs)
    for name, by_config in shade_times.items():
        times[name] = {**by_config["cfg1"], "shape": "cfg1 wave, bounce 0 (524,288 lanes)",
                       "by_config": by_config}

    # 29. the wave's kernels against their plain versions on real waves,
    # timed, before any profiler session
    with tempfile.TemporaryDirectory() as tmp:
        wave_times, wave_errs = wave_phase(
            device, {"cfg1": cornell, "cfg2": dragon, "gltf147k": bigasset,
                     "gallery": gallery_tables, "soup": soup_tables}, Path(tmp))
    errs.update(wave_errs)
    times["primary_rays"] = {**wave_times["primary_rays"]["cfg1"],
                             "shape": "cfg1 wave (262,144 pixels x 2 samples)",
                             "by_config": wave_times["primary_rays"]}
    times["alpha_commit"] = {**wave_times["alpha_commit"]["gltf147k"],
                             "shape": "glTF 147k wave, its first pass (524,288 lanes pending)",
                             "by_config": wave_times["alpha_commit"]}
    times["wave_sum"] = {**wave_times["wave_sum"]["cfg1"],
                         "shape": "cfg1 wave's tail (262,144 pixels x 2 samples)",
                         "by_config": wave_times["wave_sum"]}

    # 30. the kernels around the traversal launches against their plain
    # versions on real waves, timed, before any profiler session
    with tempfile.TemporaryDirectory() as tmp:
        trace_times, trace_errs = trace_phase(
            device, {"cfg1": cornell, "cfg2": dragon, "gltf147k": bigasset,
                     "gallery": gallery_tables, "soup": soup_tables}, Path(tmp))
    errs.update(trace_errs)
    walk_ifs_phase(gallery_tables)
    for name, config, shape in (
            ("hit_finish", "cfg1", "cfg1 wave, bounce 0 (524,288 lanes)"),
            ("instance_step", "gallery", "gallery wave, bounce 0, the second instance's step "
                                         "(524,288 lanes)"),
            ("coherence_key", "cfg2", "cfg2 wave, bounce 0's NEE rays (524,288 lanes)"),
            ("permute", "cfg2", "cfg2 wave, a re-sort's gather of the 21-column state "
                                "(524,288 lanes)")):
        times[name] = {**trace_times[name][config], "shape": shape,
                       "by_config": trace_times[name]}

    # phase 27's waves, their programs captured before the first profiler
    # session; then the dense kernels' device times from torch.profiler,
    # after every render phase: a profiler session slows the renders that
    # follow it in the same process (PERF.md §7)
    busy = busy_waves(cornell, gallery_tables, soup_tables, small, bigasset)
    times.update(time_kernels(cornell, n_wave, device))
    shadow_cfg1 = time_cfg1_shadow(cornell)
    with tempfile.TemporaryDirectory() as tmp:  # K3 and K1 at launches glTF renders make
        recorded = time_recorded(device, bigasset, Path(tmp))

    # 25. the repacked wavefront against the unsorted one at two BVH waves
    repack_phase(paths, (("cfg2", dragon, CFG2_CAM), ("gltf147k", bigasset, BIGASSET_CAM)))
    del dragon

    # 27. replayed launches in the trace, and the device's busy share, graphs
    # and eager
    graphs_busy(busy)
    del busy, gallery_tables, soup_tables, bigasset
    times["loop_cond_kernel"] = time_loop_cond(device)

    import vulkan_raytracer_tpu_torch.viewer  # noqa: F401  (held to the same check)

    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "vulkan_raytracer_tpu"))
    if imported:
        raise AssertionError(f"the port imported {imported}")

    unlaunched = [name for name in KERNELS if not paths.total[name]]
    if unlaunched:
        raise AssertionError(f"the main paths launched no {unlaunched}: {paths.by_path}")
    rows = []
    for name, (_, _, source, replaces) in KERNELS.items():
        t = times[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": paths.total[name], "launches_by_path": paths.by_path[name],
               "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t.get("library_ms"),
               "shape": t["shape"], "ptxas": ptxas[name]}
        if name in walk_times["gltf147k"]:
            g = walk_times["gltf147k"][name]
            row["gltf147k"] = {k: g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        if name.startswith("dense"):
            row.update({k: t[k] for k in ("live", "host_us_per_call")})
        if "by_config" in t:
            row["by_config"] = t["by_config"]
        if name == "loop_cond_kernel":  # the test apart from the conditional node's relaunch
            row["split"] = {k: t[k] for k in ("relaunch_ms", "one_thread_node_ms",
                                              "relaunch_and_test_ms", "program_ms")}
        if name == "emissive_walk":
            row["soup_frame_probes"] = {k: soup_probes[k] for k in (
                "us_sum", "live_sum", "differing_lanes")}
            row["soup_frame_probes"]["launches"] = len(soup_probes["launches"])
        if name == "dense_shadow":
            row["cfg1_wave"] = shadow_cfg1
            row["max_abs_err"] = max(row["max_abs_err"], shadow_cfg1["max_abs_err"])
        label = {"dense_closest": "alpha_relaunch", "dense_emissive_pdf": "gltf147k"}.get(name)
        if label:
            row[label] = {k: recorded[label][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "live", "rays", "triangles", "shape",
                "max_abs_err", "launches_per_wave")}
            row["max_abs_err"] = max(row["max_abs_err"], recorded[label]["max_abs_err"])
        rows.append(row)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
