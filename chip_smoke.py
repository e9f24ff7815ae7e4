#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and ends the run with a
nonzero exit code:

1. device   — CUDA must be available (no CPU fallback); the card's name and
   power limit from nvidia-smi.
2. build    — compile the CUDA kernels from ``vulkan_raytracer_tpu_torch/csrc``
   (one nvcc per source, started together) and the native BVH builder; each
   kernel variant's registers, stack frame and spills from ptxas.  Every
   kernel variant must use no stack and spill nothing.
3. kernels  — each dense kernel against its plain PyTorch version on the
   card, over the Cornell box and over a 1,000-triangle soup (several
   shared-memory chunks), at bench cfg1's wave of 524,288 rays and at a
   ragged 524,251 (a block partly past the last ray), with t bounds before,
   across, at and beyond the hits, and the pdf at both t_min the render
   uses; the live lanes 80% of the rays, then none, one, 0.1%, 5%, 50% and
   all of them (the sparse shares with one all-live and one all-dead block
   among mixed ones); the pdf exactly +0 on lanes whose gate is 0.  Then
   the times at the cfg1 wave: each kernel's own device time from
   torch.profiler and the wrapper's host microseconds per call, with the
   bounds.
4. render   — the CLI's headless path for bench cfg1 (Cornell, 512x512,
   depth 4, 64 spp, camera 0,1,2.4 -> 0,0,-1) on ``cuda``; every dense kernel
   must have been launched by it, and the image must be finite and lit.
5. walks    — both BVH walks (K4' whole-stream, K5' treelet; closest and
   shadow) against their plain versions on the streams of the full cfg2
   dragon (262,280 triangles, 128 treelets) and of the 147,136-triangle glTF
   of phase 12, each at a wave of 524,288 rays of its camera (camera rays
   and bounce-like rays off surface points) and at a ragged 524,251, with
   per-lane bounds, bounds at exactly the hit t and inactive lanes: t and
   slot bit-equal; K4' against K5'; the streams within 25 MB.  Then the
   times at both waves, each with its bound from the visits the plain
   walk counts (``walk_visits``).  Then one wave each of the glTF 147k
   render and of the textured glb render (samples 1-2, 524,288 lanes) with
   every dense sweep call recorded: each recorded K1 and K3 call against
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
8. gates    — the bench gate frames of cfg2-cfg5 on the card against the
   committed NumPy-oracle goldens in ``bench_goldens.npz``: RMSE < 2e-3.
9. bvh_forced — a 712-triangle dragon uploaded with ``traversal="bvh"`` (one
   treelet: the whole-stream walk K4'), 32x32, 2 spp, depth 3, on the card
   against the same render on the CPU (the plain versions): RMSE < 2e-3, ray
   counts within 0.1%; it must launch K4' (both variants).
10. cpu     — Cornell 32x32, 2 spp, depth 3 through the port on ``cuda``
   against the same render on the CPU, where the port runs the plain
   versions that tests/test_torch_render.py holds against the JAX renderer
   and its NumPy oracle; per-pixel RMSE < 2e-3, ray counts within 0.1%.
11. gltf_dense — the small textured .glb of tests/test_textured_glb.py
   (written jax-free by tools/torch_glb_assets.py: PNG and JPEG textures, a
   normal map, MASK and BLEND alpha, an emissive texture, a sparse
   accessor) through ``Scene.load_model``: 12 triangles, 6 textures (none
   1x1, the JPEG one 8x8), alpha and textures flagged; then the CLI's
   headless path on ``cuda`` at 512x512, depth 4, 16 spp, camera 0,0,2.8 ->
   0,0,-1.  It must launch K1 and K3 and give a finite, lit image; seconds,
   Mrays/s and the alpha loop's iterations per ``_closest`` call.
12. gltf_bvh — the gallery-class .glb of tests/test_bigasset_glb.py (147,136
   triangles, 9 materials, 5 textures) through ``cli.run`` on ``cuda``, twice
   at 512x512, depth 4, 4 spp, camera 0,1.7,4.6 -> 0,-0.28,-1; each
   must launch K5' closest and K3.  Load (parse, image decode) and upload
   (BVH build, streams, copy) seconds apart from the render's.
13. gltf_parity — both containers at 32x32, 2 spp, depth 3 on ``cuda``
   against the same render on the CPU, and the small one once more uploaded
   with ``traversal="bvh"`` (K4' closest runs the alpha loop): RMSE < 2e-3,
   ray counts within 0.1%.  tests/test_torch_gltf.py and
   tests/test_torch_alpha.py tie the CPU renders to the JAX renders and the
   NumPy oracle.
14. emissive_walk — the emissive-pdf walk against its plain version on an
   all-emissive 20,000-triangle soup at 524,288 and 524,251 rays with 20% of
   the lanes inactive, at both t_min the render uses: rtol 1e-5 / atol 1e-7
   on active lanes, +0 elsewhere; then its time, the plain version's and its
   bound from the visits the plain walk counts.
15. render_emissive_bvh — a soup of 100,000 grey and 5,000 emissive
   triangles (above both the dense cap and ``EMISSIVE_MAX_TRIS``) through
   ``Scene.upload`` and ``render_image`` at 512x512, depth 4, 4 spp: K5'
   carries the rays and the emissive walk every pdf probe, the MIS probe
   (t_min EPS) and the NEE probe (t_min 0) each with live lanes; a finite,
   lit image; then 32x32 on the card against the CPU.
16. render_cfg5 — bench cfg5 at its own frame (``multi_scene``, 1920x1080,
   depth 8, 8 spp, camera -9,2,1.5 -> 1,-0.1,-0.15) through the banded
   renderer, once: 32 bands of 64,800 pixels x 8 samples; seconds, Mrays/s
   and the peak device memory.

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
   once to warm up and once timed: seconds, Mrays/s, instance steps, steps
   skipped, launches per kernel, peak device memory; it must launch K1, K2,
   K3 and K5' (both variants).  Then the same scene at 32x32 on the card
   against the CPU.
19. instanced_vs_flattened — the dragon x 4 instances uploaded both ways on
   the card, 128x128, 2 spp, depth 3: RMSE < 2e-3.
20. refit — one node of the cfg2 dragon scene and one instance of the
   gallery move; ``Scene.refit`` against a fresh ``upload`` on the card: the
   same image (atol 1e-5 flattened, RMSE < 2e-3 instanced) and the seconds
   of each (a refit more than twice as slow as the rebuild fails).
21. progressive — the progressive ``Renderer`` on Cornell 512x512, depth 4:
   the preview frame and 16 samples, whose mean must equal
   ``render_image(spp=16)`` within atol 1e-5; ms per frame; ``pipeline=True``
   gives the same images one call late; then ``cli.run`` with
   ``--progressive`` and a ``--checkpoint`` / ``--resume`` pair (8 + 8 spp
   equal 16 spp).
22. shard_one — bench cfg1 through ``cli.run`` with ``--shard`` on the mesh
   of the one card: image and rays equal to phase 4's bit for bit; two
   renders of each path in turns (shard, plain, plain, shard), seconds and
   Mrays/s.
23. shard_two — bench cfg2 through ``render_image_sharded`` on two shards of
   the one card (``[cuda:0, cuda:0]``; one wave of 4 samples x 131,072
   pixels each) against ``render_image`` (two waves of 2 samples x 262,144),
   in turns: rtol 1e-5 / atol 1e-6 (the samples are summed in another
   grouping), equal rays; it must launch K5' (both variants) and K3.
24. fleet — two processes started with ``torch.multiprocessing`` in spawn
   mode form a gloo group over 127.0.0.1; rank 1 doubles a column of its
   tables before ``broadcast_scene_tables``; both render cfg1 through
   ``render_image_multihost`` (one shard each on cuda:0) between barriers.
   Both images equal, and equal phase 4's within rtol 1e-5 / atol 1e-6, with
   its rays; the fleet's wall seconds and Mrays/s beside those of one process
   spawned and warmed up the same way before it (a fleet of one, whose image
   must be phase 4's bit for bit), the card's utilization in each window from
   ``nvidia-smi`` every 100 ms, and the all-gather of one rank's block timed
   alone.  The kernels were built in phase 2, so the ranks only load them.

Then it prints the kernel summary (one JSON object: each kernel's launches
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

import json
import os
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
# name -> (counter module, counter key, source, TPU kernel it replaces)
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
}
CFG1 = ["-m", "cornell", "-r", "512,512", "-b", "4", "--spp", "64",
        "-c", "0,1,2.4", "-d", "0,0,-1"]
CFG2 = ["-m", "dragon", "-r", "512,512", "-b", "4", "--spp", "4",
        "-c", "0,2.2,4.5", "-d", "0,-0.25,-1"]
CFG2_CAM = ([0.0, 2.2, 4.5], [0.0, -0.25, -1.0])
CFG1_CAM = ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0])
CFG5_CAM = ([-9.0, 2.0, 1.5], [1.0, -0.1, -0.15])  # bench.py:145-148
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

    from vulkan_raytracer_tpu_torch.ops import dense

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
                uk, vk = dense.winner_uv(tables, rays["o"], rays["d"], tri_k)
                up, vp = dense.winner_uv(tables, rays["o"], rays["d"], tri_p)
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


def record_dense_launches(run):
    """Call ``run()`` with ops/dense.py's three sweeps wrapped so that every
    call's arguments and result are kept (tensors cloned).  Returns the calls
    in order, as (kernel, args, result), and each kernel's launches counted
    meanwhile."""
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
        run()
    finally:
        for k, f in DENSE_SWEEPS.items():
            setattr(dense, f, saved[k])
    return calls, {k: dense.LAUNCHES[KERNELS[k][1]] - before[k] for k in DENSE_SWEEPS}


def record_wave(tables, cam, width: int = 512, height: int = 512):
    """Every dense sweep call of the first wave of a ``width`` x ``height``
    render of ``cam`` (samples 1-2, depth 4; tools/profile_torch_wave.py).
    Returns the calls as :func:`record_dense_launches` does; on the card
    each kernel's calls must equal its launches."""
    import profile_torch_wave
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]),
                    aspect=width / height)
    calls, launched = record_dense_launches(
        profile_torch_wave._wave(tables, camera, width, height))
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
    for label, tables, cam, kernel in (
            ("gltf147k", gallery, BIGASSET_CAM, "dense_emissive_pdf"),
            ("alpha_relaunch", textured, TEXTURED_CAM, "dense_closest")):
        calls = record_wave(tables, cam)
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
            out[name] = (t_k, tr.slot_to_tri(s, s_k)[0], os_k >= 0)
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
    lanes inactive, at both t_min the render uses: rtol 1e-5 / atol 1e-7 on
    active lanes (the sum's order is the plain version's; the divides and
    the square root are the compiler's), +0 on the others.  Returns the
    largest absolute error."""
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
            torch.testing.assert_close(got[active], want[active], rtol=1e-5, atol=1e-7)
            off = got[~active]
            if bool((off != 0.0).any() or torch.signbit(off).any()):
                raise AssertionError(f"emissive walk, {n} rays: not +0 on an inactive lane")
            out[f"max_abs_err_t_min_{t_min}"] = e
            out[f"bit_equal_t_min_{t_min}"] = bool(torch.equal(got, want))
            out[f"pdf_lanes_t_min_{t_min}"] = int((got > 0).sum())
        emit({"phase": "emissive_walk", "rays": n, "active": int(active.sum()),
              "emissive_triangles": s.rows.shape[0], "nodes": s.num_nodes,
              "stream_bytes": s.nbytes, **out})
    return err


def time_emissive_walk(tables, n: int, device) -> dict:
    """The emissive-pdf walk and its plain version over n random rays in the
    Cornell volume (80% active, t_min EPS), the plain version once, then the
    kernel twice, with the bound of the work ``emissive_walk_visits`` counts: a box
    test per node visited, a triangle test per real slot of each leaf
    entered and the term per hit; bytes: the active lanes' rays, every
    lane's flag and output, the node records and triangle rows read."""
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
    v = tr.emissive_walk_visits(s, cols, active, EPS)
    live = max(int(active.sum()), 1)
    ops = (SLAB_OPS * int(v["nodes"].sum()) + MT_OPS * int(v["tris"].sum())
           + WALK_TERM_OPS * int(v["hits"].sum()))
    nbytes = 5 * n + 24 * live + 32 * v["node_rows"] + 80 * v["tri_rows"]
    out = {"ms": (k1 + k2) / 2, "plain_ms": p1, "ms_runs": [k1, k2],
           "shape": f"emissive soup wave: {n} rays over {s.rows.shape[0]} emissive triangles",
           **bound(ops, nbytes), "live": live,
           "per_live_ray": {k: int(v[k].sum()) / live for k in ("nodes", "tris", "hits")},
           "node_rows": v["node_rows"], "tri_rows": v["tri_rows"]}
    emit({"phase": "emissive_walk_times", "rays": n, "emissive_walk": out})
    return out


def record_emissive_probes(run):
    """Call ``run()`` with ops/traverse.py's emissive walk wrapped so that
    each call's t_min and count of active lanes are kept; returns (what
    ``run`` returned, the calls as (t_min, active lanes))."""
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    saved = tr.emissive_pdf_walk
    calls = []

    def recording(stream, rays, active, t_min):
        calls.append((t_min, int(active.sum())))
        return saved(stream, rays, active, t_min)

    try:
        tr.emissive_pdf_walk = recording
        result = run()
    finally:
        tr.emissive_pdf_walk = saved
    return result, calls


def render_emissive_bvh(device, paths) -> None:
    """A scene whose pdf probes walk the emissive BVH: 100,000 grey and 5,000
    emissive triangles, 512x512, depth 4, 4 spp on the card; then 32x32 on
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
    mis = [a for t, a in probes if t == EPS]
    nee = [a for t, a in probes if t == 0.0]
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
    emit({"phase": "render_emissive_bvh",
          "config": "emitter soup (100,000 grey + 5,000 emissive tris) 512x512 depth 4 4 spp",
          "upload_seconds": upload_s, "treelets": tables.pbvh.n_treelets,
          "emissive_stream_bytes": tables.em_stream.nbytes, "seconds": secs, "rays": rays,
          "mrays_per_s": rays / secs / 1e6, "peak_memory_bytes": peak,
          "mis_probes": {"launches": len(mis), "with_live_lanes": sum(a > 0 for a in mis),
                         "live_lanes": sum(mis)},
          "nee_probes": {"launches": len(nee), "with_live_lanes": sum(a > 0 for a in nee),
                         "live_lanes": sum(nee)},
          "launches": launches, "image_mean": float(img.mean())})
    _reset_launches()
    res = _cuda_vs_cpu(tables, CFG1_CAM, "emitter soup")
    launches = _launch_counts()
    if not launches["traverse"]["emissive_pdf"] > 0:
        raise AssertionError(f"the 32x32 emitter soup render missed the emissive walk: {launches}")
    emit({"phase": "render_emissive_bvh_parity", "config": "emitter soup 32x32 2 spp depth 3",
          "launches": launches, **res})


def render_cfg5(device, paths) -> None:
    """Bench cfg5 at its own frame through the banded renderer, once."""
    import torch

    from vulkan_raytracer_tpu_torch.render import renderer
    from vulkan_raytracer_tpu_torch.scene import procedural
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    w, h, spp, depth = 1920, 1080, 8, 8
    t0 = time.perf_counter()
    tables = procedural.multi_scene().upload(device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    cam = Camera(position=np.array(CFG5_CAM[0]), direction=np.array(CFG5_CAM[1]))
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, rays = renderer.render_image(tables, cam, w, h, spp=spp, max_depth=depth, tonemap=False)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _launch_counts()
    plan = renderer.band_plan(w, h, spp)
    if not (plan == (8, 64800, 32) and renderer.LAST_RENDER == {"bands": 32, "waves": 32}):
        raise AssertionError(f"cfg5 ran {renderer.LAST_RENDER}, planned {plan}: expected 32 bands")
    # every lane traces its camera ray; a path adds at most 3 rays a bounce
    if not w * h * spp <= rays <= w * h * spp * 3 * (depth + 1):
        raise AssertionError(f"cfg5 traced {rays} rays for {w * h * spp} lanes")
    if not np.isfinite(img).all() or img.shape != (h, w, 3) or not img.mean() > 1e-3:
        raise AssertionError(f"cfg5 image not finite, misshapen or black: {img.shape} "
                             f"mean {img.mean()}")
    walk = "treelet" if tables.pbvh.n_treelets > 1 else "bvh"
    if not (launches["traverse"][f"{walk}_closest"] > 0
            and launches["traverse"][f"{walk}_shadow"] > 0 and launches["dense"]["pdf"] > 0):
        raise AssertionError(f"cfg5 render missed a kernel: launches {launches}")
    paths.add("render_cfg5", launches)
    emit({"phase": "render_cfg5", "config": "cfg5 multi_scene 1920x1080 depth 8 8 spp",
          "triangles": tables.num_triangles, "treelets": tables.pbvh.n_treelets,
          "upload_seconds": upload_s, "bands": renderer.LAST_RENDER["bands"],
          "pixels_per_band": plan[1], "lanes_per_wave": plan[0] * plan[1],
          "seconds": secs, "rays": rays, "mrays_per_s": rays / secs / 1e6,
          "peak_memory_bytes": peak, "launches": launches, "image_mean": float(img.mean())})


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
              "steps": steps["steps"], "skipped": steps["skipped"], "launches": used,
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
    paths.add("render_instanced", launches)
    waves = 2  # 4 spp of 262,144 pixels in waves of 524,288 lanes
    emit({"phase": "render_instanced",
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
          "steps": steps["steps"], "skipped": steps["skipped"], "launches": launches,
          "image_mean": float(img.mean())})
    _reset_launches()
    t0 = time.perf_counter()
    res = _cuda_vs_cpu(tables, cam, "gallery")
    emit({"phase": "render_instanced_parity", "config": "gallery 32x32 2 spp depth 3",
          "seconds": time.perf_counter() - t0, "launches": _launch_counts(), **res})
    return scene, tables


def instanced_vs_flattened(device, detail: int = 256) -> None:
    """The dragon x 4 instances uploaded both ways on the card."""
    import torch

    scene = gallery_scene(detail, n_dragons=4)
    cam = gallery_camera(4)
    out = {}
    for name, instancing in (("instanced", True), ("flattened", False)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tables = scene.upload(device, instancing=instancing)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        nbytes = torch.cuda.memory_allocated() - before
        _reset_launches()
        img, rays, secs = _render(tables, cam, 128, 128, spp=2, depth=3)
        out[name] = {"triangles": tables.num_triangles, "upload_seconds": upload_s,
                     "table_and_stream_bytes": nbytes, "seconds": secs, "rays": rays,
                     "launches": _launch_counts()}
        out[name + "_image"] = img
        del tables
    a, b = out.pop("instanced_image"), out.pop("flattened_image")
    rmse = _rmse(a, b)
    emit({"phase": "instanced_vs_flattened",
          "config": "gallery of 4 dragons 128x128 2 spp depth 3", "rmse": rmse, "bar": RMSE_BAR,
          "image_mean": float(b.mean()), **out})
    if not (np.isfinite(a).all() and b.mean() > 1e-3 and rmse < RMSE_BAR):
        raise AssertionError(f"instanced vs flattened RMSE {rmse} (bar {RMSE_BAR})")


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
    launches = _launch_counts()
    paths.add("refit", launches)
    emit({"phase": "refit", "config": "one node moved; 128x128 2 spp depth 3", **out,
          "launches": launches})


def progressive_phase(device, paths, size: int = 512, spp: int = 16) -> None:
    """The progressive Renderer on Cornell 512x512, depth 4, and the CLI's
    --progressive, --checkpoint and --resume on the card."""
    from vulkan_raytracer_tpu_torch import cli
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
    launches = _launch_counts()
    if not all(launches["dense"][c] > 0 for c in ("closest", "shadow", "pdf")):
        raise AssertionError(f"the progressive frames missed a kernel: launches {launches}")
    paths.add("progressive", launches)
    mean = (r.accum / float(spp)).cpu().numpy().reshape(h, w, 3)
    want, rays, _ = _render(tables, CFG1_CAM, w, h, spp=spp, depth=depth)
    err = float(np.abs(mean - want).max())
    if not (err <= 1e-5 and frames[-1].dtype == np.uint8 and frames[-1].shape == (h, w, 3)
            and frames[0].max() > 0 and r.rays_traced > rays):
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
    emit({"phase": "progressive", "config": f"cornell {w}x{h} depth {depth}: preview + {spp} frames",
          "frame_ms_median": statistics.median(ms[1:]), "frame_ms_min": min(ms[1:]),
          "frame_ms_max": max(ms[1:]), "preview_ms": ms[0], "rays": r.rays_traced,
          "max_abs_err_vs_render_image": err, "pipeline_equal": True,
          "cli_progressive": {"frames": prog["frames"], "seconds": prog["seconds"],
                              "frame_ms_median": statistics.median(prog["frame_ms"][1:]),
                              "max_abs_err_vs_renderer": prog_err},
          "checkpoint_resume": {"spp": [spp // 2, spp // 2], "max_abs_err_vs_one_render": resume_err,
                                "resume_seconds": part["seconds"]},
          "launches": launches})
    if not (prog["frames"] == spp + 1 and prog_err <= 1e-6 and resume_err <= 1e-6):
        raise AssertionError(f"--progressive differs from the Renderer by {prog_err}, "
                             f"8 + 8 spp resumed from 16 spp by {resume_err}")


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
    emit({"phase": "shard_one", "config": "cfg1 cornell 512x512 depth 4 64 spp, cli --shard",
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
    s_batch = {"plain": renderer.samples_per_wave(w * h, spp),
               "shard": renderer.samples_per_wave(per, spp)}
    emit({"phase": "shard_two", "config": "cfg2 dragon 512x512 depth 4 4 spp on [cuda:0, cuda:0]",
          "lanes_per_shard": per, "waves": {"plain": spp // s_batch["plain"],
                                            "per_shard": spp // s_batch["shard"]},
          "lanes_per_wave": {"plain": s_batch["plain"] * w * h, "shard": s_batch["shard"] * per},
          "runs": out, "max_abs_err": err, "launches": shard_launches,
          "image_mean": float(images["shard"].mean())})
    rays = {r["rays"] for r in out["plain"] + out["shard"]}
    if not (np.allclose(images["shard"], images["plain"], rtol=1e-5, atol=1e-6) and len(rays) == 1):
        raise AssertionError(f"cfg2 on two shards differs from one by {err}, rays {rays}")
    walks = shard_launches["traverse"]
    if not (walks["treelet_closest"] > 0 and walks["treelet_shadow"] > 0
            and shard_launches["dense"]["pdf"] > 0):
        raise AssertionError(f"cfg2 on two shards missed K5' or K3: launches {shard_launches}")
    paths.add("shard_two", shard_launches)


FLEET_TIMEOUT_S = 120  # the fleet's process-group timeout


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fleet_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of a fleet of ``world`` processes on the card (a spawn
    target): form the gloo group, diverge rank 1's tables, broadcast them,
    warm up, and render cfg1 through ``render_image_multihost`` between two
    barriers; then time the all-gather of one rank's block alone."""
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

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=FLEET_TIMEOUT_S))
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
        port = _free_port()
        procs = [ctx.Process(target=fleet_rank, args=(r, world, port, out_dir))
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
    launches = {"dense": {}, "traverse": {}}
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
            "emissive_walk_kernel": "emissive_walk"}


def ptxas_table(report: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel variant from
    ptxas's -v report."""
    table, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in _ENTRIES.items() if k in line), None)
        elif name and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            table[name] = dict(zip(("stack_frame", "spill_stores", "spill_loads"), nums))
        elif name and "Used" in line and "registers" in line:
            table[name]["registers"] = int(line.split("Used")[1].split()[0])
            name = None
    return table


def _launch_counts():
    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    return {"dense": dict(dense.LAUNCHES), "traverse": dict(tr.LAUNCHES)}


def _reset_launches() -> None:
    """Zero the kernels' launch counters, the instance-step counter and the
    alpha loop's counter."""
    from vulkan_raytracer_tpu_torch.ops import dense, instanced
    from vulkan_raytracer_tpu_torch.ops import traverse as tr
    from vulkan_raytracer_tpu_torch.render import integrator

    dense.reset_launches()
    tr.reset_launches()
    instanced.reset_stats()
    integrator.reset_alpha_loop()


def _alpha_loop() -> dict:
    """Iterations of the alpha resample loop per ``_closest`` call since the
    last reset."""
    from vulkan_raytracer_tpu_torch.render.integrator import ALPHA_LOOP

    calls = ALPHA_LOOP["calls"]
    return {"closest_calls": calls, "iterations": ALPHA_LOOP["iterations"],
            "mean": ALPHA_LOOP["iterations"] / calls if calls else 0.0,
            "max": ALPHA_LOOP["max"]}


class PathLaunches:
    """Each kernel's launches in the runs of the paths the smoke drives with
    reset counters, in all and by the phase that drove the path."""

    def __init__(self):
        self.total = {name: 0 for name in KERNELS}
        self.by_path = {name: {} for name in KERNELS}

    def add(self, phase: str, launches: dict) -> None:
        for name, (mod, key, _, _) in KERNELS.items():
            n = launches[mod][key]
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
            emit({"phase": "render_cfg2", "config": "cfg2 dragon 512x512 depth 4 4 spp",
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


def bench_configs():
    """(golden key, scene builder, camera, (gate crop, spp, depth)) of bench
    cfg2-cfg5 (bench.py:132-148), on the port's procedural scenes."""
    from vulkan_raytracer_tpu_torch.scene import procedural as P

    def hall_sky():
        s = P.hall_scene()
        s.skybox = P.sky_hdr()
        s.skybox_strength = 1.0
        return s

    return [
        ("cfg2_dragon_substitute_262k_512x512_d4", P.dragon_scene, CFG2_CAM, (16, 2, 3)),
        ("cfg3_chess_substitute_98k_512x512_d6", P.chess_scene,
         ([0.0, 4.0, 7.0], [0.0, -0.5, -1.0]), (16, 2, 4)),
        ("cfg4_sponza_substitute_256k_hdrsky_960x540_d4_8spp", hall_sky,
         ([-9.0, 1.8, 0.0], [1.0, 0.0, 0.0]), (16, 2, 3)),
        ("cfg5_multimodel_1920x1080_d8_8spp", P.multi_scene,
         ([-9.0, 2.0, 1.5], [1.0, -0.1, -0.15]), (12, 1, 4)),
    ]


def gates(device) -> None:
    """The bench gate frames of cfg2-cfg5 on the card against the committed
    NumPy-oracle goldens."""
    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    goldens = np.load(ROOT / "bench_goldens.npz")
    for key, build, (pos, direction), (crop, spp, depth) in bench_configs():
        tables = build().upload(device)
        cam = Camera(position=np.array(pos), direction=np.array(direction))
        img, rays = render_image(tables, cam, crop, crop, spp=spp, max_depth=depth,
                                 tonemap=False)
        golden = goldens[f"golden_{key}"]
        rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
        emit({"phase": "gate", "config": key, "frame": f"{crop}x{crop} {spp} spp depth {depth}",
              "rmse": rmse, "bar": RMSE_BAR, "rays": rays,
              "treelets": tables.pbvh.n_treelets})
        if not (np.isfinite(img).all() and img.shape == golden.shape and rmse < RMSE_BAR):
            raise AssertionError(f"{key}: gate RMSE {rmse} (bar {RMSE_BAR})")


def _cuda_vs_cpu(tables, cam_args, label):
    """The same 32x32, 2 spp, depth 3 render on the card and on the CPU."""
    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    def cam():
        return Camera(position=np.array(cam_args[0]), direction=np.array(cam_args[1]))

    img_gpu, rays_gpu = render_image(tables, cam(), 32, 32, spp=2, max_depth=3, tonemap=False)
    img_cpu, rays_cpu = render_image(tables.to("cpu"), cam(), 32, 32, spp=2, max_depth=3,
                                     tonemap=False)
    rmse = float(np.sqrt(np.mean((img_gpu - img_cpu) ** 2)))
    if not (np.isfinite(img_gpu).all() and img_gpu.shape == (32, 32, 3)):
        raise AssertionError(f"{label}: the 32x32 render on the card is not finite or misshapen")
    if not rmse < RMSE_BAR:
        raise AssertionError(f"{label}: port on cuda vs port on cpu RMSE {rmse} >= {RMSE_BAR}")
    if abs(rays_gpu - rays_cpu) > 1e-3 * rays_cpu:
        raise AssertionError(f"{label}: ray counts differ: {rays_gpu} on cuda, {rays_cpu} on cpu")
    return {"rmse": rmse, "bar": RMSE_BAR, "rays_cuda": rays_gpu, "rays_cpu": rays_cpu}


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
    launches, loop = _launch_counts(), _alpha_loop()
    img = stats["image"]
    if not (launches["dense"]["closest"] > 0 and launches["dense"]["pdf"] > 0):
        raise AssertionError(f"textured glb render missed K1 or K3: launches {launches}")
    if not np.isfinite(img).all() or img.shape != (512, 512, 3) or not img.mean() > 1e-3:
        raise AssertionError(f"textured glb image not finite, misshapen or black: "
                             f"{img.shape} mean {img.mean()}")
    paths.add("gltf_dense", launches)
    emit({"phase": "gltf_dense", "config": "textured.glb 512x512 depth 4 16 spp",
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
        launches, loop = _launch_counts(), _alpha_loop()
        img = stats["image"]
        if not (launches["traverse"]["treelet_closest"] > 0 and launches["dense"]["pdf"] > 0):
            raise AssertionError(f"bigasset render missed K5' closest or K3: launches {launches}")
        if not np.isfinite(img).all() or img.shape != (512, 512, 3) or not img.mean() > 1e-3:
            raise AssertionError(f"bigasset image not finite, misshapen or black: "
                                 f"{img.shape} mean {img.mean()}")
        runs.append(stats)
        emit({"phase": "gltf_bvh", "config": "bigasset.glb (147,136 tris) 512x512 depth 4 4 spp",
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
        emit({"phase": "gltf_parity", "config": f"{label} 32x32 2 spp depth 3",
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
    _ext.library()
    t1 = time.perf_counter()
    builder = "native (g++)" if native.get_lib() is not None else "numpy"
    ptxas = ptxas_table(_ext.ptxas_report())
    emit({"phase": "build", "seconds": t1 - t0, "library": lib_path.name,
          "bvh_builder": builder, "bvh_builder_seconds": time.perf_counter() - t1,
          "ptxas": ptxas})
    if set(ptxas) != set(KERNELS):
        raise AssertionError(f"ptxas reported {sorted(ptxas)}, expected every kernel variant")
    for name in KERNELS:
        if any(ptxas[name][k] for k in ("stack_frame", "spill_stores", "spill_loads")):
            raise AssertionError(f"{name} uses the stack: {ptxas[name]}")

    # 3. dense kernels
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    cornell = cornell_box_scene().upload(device)
    soup = soup_scene(1000, seed=7).upload(device)
    n_wave = 2 * 512 * 512  # lanes of one cfg1 or cfg2 wave
    # the cfg1 wave, and a ragged count whose last block is partly past the rays
    errs = check_kernels({"cornell": cornell, "soup1000": soup}, (n_wave, n_wave - 37), device)
    times = time_kernels(cornell, n_wave, device)
    shadow_cfg1 = time_cfg1_shadow(cornell)

    # 4. render: the CLI's headless path for bench cfg1
    from vulkan_raytracer_tpu_torch import cli

    with tempfile.TemporaryDirectory() as out_dir:
        _reset_launches()
        stats = cli.run(CFG1 + ["--device", "cuda", "--output", f"{out_dir}/cfg1.png"])
        launches = _launch_counts()
    img = cfg1_img = stats["image"]
    cfg1_rays = stats["rays"]
    if not all(launches["dense"][c] > 0 for c in ("closest", "shadow", "pdf")):
        raise AssertionError(f"cfg1 render missed a kernel: launches {launches}")
    if not np.isfinite(img).all() or img.shape != (512, 512, 3):
        raise AssertionError(f"cfg1 image not finite or misshapen: {img.shape}")
    if not img.mean() > 1e-3:
        raise AssertionError(f"cfg1 image is black (mean {img.mean()})")
    emit({"phase": "render", "config": "cfg1 cornell 512x512 depth 4 64 spp",
          "seconds": stats["seconds"], "rays": stats["rays"],
          "mrays_per_s": stats["mrays_per_s"], "launches": launches,
          "image_mean": float(img.mean())})
    paths = PathLaunches()
    paths.add("render", launches)

    # 5. walks: K4' and K5' against their plain versions on the cfg2 dragon
    # and on the 147,136-triangle glTF, with their times and bounds
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch.scene import procedural

    dragon_scene = procedural.dragon_scene()
    dragon = dragon_scene.upload(device)
    with tempfile.TemporaryDirectory() as tmp:
        glb = torch_glb_assets.write_bigasset_glb(Path(tmp), big=True)
        gallery = _load_glb(glb, triangles=147136, textures=5)[0].upload(device)
        walk_times = {}
        for label, tables, cam in (("cfg2", dragon, CFG2_CAM),
                                   ("gltf147k", gallery, BIGASSET_CAM)):
            if not tables.pbvh.nbytes <= STREAM_BYTES_MAX:
                raise AssertionError(f"{label}: the BVH streams take {tables.pbvh.nbytes} bytes")
            for name, e in check_walks(tables, (n_wave, n_wave - 37), device, label,
                                       cam).items():
                errs[name] = max(errs.get(name, 0.0), e)
            walk_times[label] = time_walks(tables, n_wave, device, label, cam)
        times.update(walk_times["cfg2"])
        # K3 and K1 at launches the glTF renders make
        recorded = time_recorded(device, gallery, Path(tmp))

    # 6. the BVH walks against the dense kernels
    bvh_vs_dense(device)

    # 7. render: the CLI's headless path for bench cfg2 (K5' and K3)
    paths.add("render_cfg2", render_cfg2(reps=2))

    # 8. the gate frames of cfg2-cfg5 against the committed goldens
    gates(device)

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
    emit({"phase": "bvh_forced", "config": "dragon detail 12 (712 tris) 32x32 2 spp depth 3",
          "triangles": small.num_triangles, "launches": launches, **forced})

    # 10. cpu: the Cornell render through the plain versions on the CPU, which
    # the CPU tests hold against the JAX renderer and its NumPy oracle
    cpu = _cuda_vs_cpu(cornell, ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0]), "cornell")
    emit({"phase": "cpu", "config": "cornell 32x32 2 spp depth 3", **cpu})

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

    # 15. a render whose pdf probes walk the emissive BVH
    render_emissive_bvh(device, paths)

    # 16. bench cfg5 at its own frame: the banded renderer
    render_cfg5(device, paths)

    # 17-21. instanced and dynamic scenes, and the progressive renderer
    instanced_parity(device, (n_wave, n_wave - 37))
    gallery, gallery_tables = render_instanced(device, paths)
    instanced_vs_flattened(device)
    refit_phase(device, paths, dragon_scene, dragon, gallery, gallery_tables)
    del dragon_scene, gallery, gallery_tables
    progressive_phase(device, paths)

    # 22-24. pixel sharding: --shard on the one card, two shards on it, and a
    # fleet of two processes
    shard_one(cfg1_img, cfg1_rays, paths)
    shard_two(device, dragon, paths)
    del dragon
    fleet_phase(cfg1_img, cfg1_rays, paths)

    import vulkan_raytracer_tpu_torch.viewer  # noqa: F401  (held to the same check)

    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "vulkan_raytracer_tpu"))
    if imported:
        raise AssertionError(f"the port imported {imported}")

    rows = []
    for name, (_, _, source, replaces) in KERNELS.items():
        t = times[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": paths.total[name], "launches_by_path": paths.by_path[name],
               "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
               "shape": t["shape"], "ptxas": ptxas[name]}
        if name in walk_times["gltf147k"]:
            g = walk_times["gltf147k"][name]
            row["gltf147k"] = {k: g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        if name.startswith("dense"):
            row.update({k: t[k] for k in ("live", "host_us_per_call")})
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
