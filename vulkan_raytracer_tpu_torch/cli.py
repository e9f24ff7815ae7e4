"""Command-line interface of the torch port, mirroring the JAX package's.

Same flags as ``vulkan_raytracer_tpu/cli.py:88-146`` (the reference's
src/main.cpp:113-169 plus the headless extensions), and ``--device``
(default ``cuda``).  ``-m`` takes glTF/GLB files, several of them composed
into one scene, each under its own ``-t X,Y,Z`` / ``-o W,X,Y,Z`` /
``-s X,Y,Z`` transform (T*R*S, main.cpp:159-165), or one built-in scene
(``cornell``, ``soup``, ``glass``, ``hall``, ``dragon``, ``chess``).  The
headless path renders to a PNG (and optionally a Radiance .hdr) and logs
the same ``Mrays/s`` line:

    python -m vulkan_raytracer_tpu_torch.cli -m scene.glb -r 512,512 -b 4 \\
        --spp 16 -c 0,0,2.8 -d 0,0,-1 --output out.png
    python -m vulkan_raytracer_tpu_torch.cli -m cornell -r 512,512 -b 4 \\
        --spp 64 -c 0,1,2.4 -d 0,0,-1 --output out.png

Bench cfg2 (the dragon, 262,280 triangles, on the BVH kernels) is
``-m dragon -r 512,512 -b 4 --spp 4 -c 0,2.2,4.5 -d 0,-0.25,-1``.  The
skybox may be a Radiance .hdr, PNG or JPEG file.

``--progressive`` runs the frame loop of the progressive ``Renderer`` (the
preview frame, then ``--spp`` samples) and writes the last display image;
``--interactive`` opens the terminal viewer; ``--checkpoint NPZ`` writes the
linear accumulation after the render and ``--resume NPZ`` continues on top
of one (same scene, camera, resolution, depth and estimator, held by a
fingerprint; the files are the JAX CLI's, so either package resumes the
other's); ``--trace DIR`` writes a ``torch.profiler`` chrome trace of the
render to ``DIR/trace.json``.  ``--shard`` raises ``NotImplementedError``
naming the ROADMAP item that ports it.

``--device cuda`` without a card is an error: the CLI never falls back to
the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .ops.tonemap import reinhard_jodie
from .render.renderer import Renderer, render_image
from .scene.builtin import cornell_box_scene, glass_sphere_scene, triangle_soup_scene
from .scene.camera import Camera
from .scene.gltf import quat_to_mat4
from .scene.procedural import chess_scene, dragon_scene, hall_scene
from .scene.scenegraph import Scene
from .utils import logging as log
from .utils.image import load_texture, write_hdr, write_png

DEFAULT_RESOLUTION = (800, 600)  # main.cpp:10
DEFAULT_DEPTH = 5  # main.cpp:124
DEFAULT_CAMERA_POS = (0.0, 1.0, 3.0)  # main.cpp:14
DEFAULT_CAMERA_DIR = (0.0, 0.0, -1.0)  # main.cpp:15
DEFAULT_SKYBOX = "hilly_terrain_01_4k.hdr"  # main.cpp:138

BUILTIN_SCENES = {  # vulkan_raytracer_tpu/cli.py:50-57
    "cornell": cornell_box_scene,
    "soup": triangle_soup_scene,
    "glass": glass_sphere_scene,
    "hall": hall_scene,  # bench cfg4 stand-in
    "dragon": dragon_scene,  # bench cfg2 stand-in
    "chess": chess_scene,  # bench cfg3 stand-in
}

#: flags of the JAX CLI whose code paths are not ported yet -> ROADMAP item
_NOT_PORTED = {"shard": "Queue 1, sharding and multihost"}


def _parse_floats(value: str, n: int, name: str, default):
    if value == "d":
        return np.asarray(default, np.float64)
    parts = value.split(",")
    if len(parts) != n:
        raise argparse.ArgumentTypeError(
            f"{name} - must be 'd' or provide {n} comma-separated values"
        )
    try:
        return np.asarray([float(p) for p in parts], np.float64)
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"{name} - could not parse '{value}': {e}")


def _parse_resolution(value: str):
    if value == "d":
        return DEFAULT_RESOLUTION
    parts = value.split(",")
    if len(parts) != 2:
        raise argparse.ArgumentTypeError("resolution - must be 'd' or provide 2 positive integers")
    w, h = int(parts[0]), int(parts[1])
    if w <= 0 or h <= 0:
        raise argparse.ArgumentTypeError("resolution must be positive")
    return w, h


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vkrt-torch",
        description="glTF path tracer - PyTorch/CUDA port.",
    )
    p.add_argument("-r", "--resolution", type=_parse_resolution, default=DEFAULT_RESOLUTION,
                   help="Resolution w,h (default 800,600)")
    p.add_argument("-b", "--max-ray-depth", type=int, default=DEFAULT_DEPTH,
                   help="Max ray depth (default 5)")
    p.add_argument("-m", "--models", action="append", default=None,
                   help="glTF model file(s) or builtin scene names "
                        f"({', '.join(BUILTIN_SCENES)})")
    p.add_argument("-t", "--translations", action="append", default=None,
                   metavar="X,Y,Z", help="Model translation(s); 'd' = default")
    p.add_argument("-o", "--rotations", action="append", default=None,
                   metavar="W,X,Y,Z", help="Model rotation quaternion(s); 'd' = default")
    p.add_argument("-s", "--scales", action="append", default=None,
                   metavar="X,Y,Z", help="Model scale(s); 'd' = default")
    p.add_argument("-c", "--camera-position", default="d", metavar="X,Y,Z")
    p.add_argument("-d", "--camera-direction", default="d", metavar="X,Y,Z")
    p.add_argument("--skybox", nargs="?", const=DEFAULT_SKYBOX, default=DEFAULT_SKYBOX,
                   help=f"Equirectangular HDR skybox file (default {DEFAULT_SKYBOX})")
    p.add_argument("--no-skybox", action="store_true", help="Disable the environment map")
    p.add_argument("--skybox-strength", type=float, default=1.0)
    p.add_argument("--spp", type=int, default=64, help="Samples per pixel")
    p.add_argument("--output", default="out.png", help="Output PNG path")
    p.add_argument("--hdr-output", default=None, help="Optional Radiance .hdr output")
    p.add_argument("--progressive", action="store_true",
                   help="Progressive per-frame loop (logs per-frame timing)")
    p.add_argument("--shard", action="store_true", help="(not ported)")
    p.add_argument("--interactive", action="store_true",
                   help="Terminal viewer with WASD/pan controls (needs a tty)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="Write a torch.profiler chrome trace of the render to DIR/trace.json")
    p.add_argument("--checkpoint", default=None, metavar="NPZ",
                   help="Write the linear accumulation state after rendering "
                        "so a later run can --resume with more samples")
    p.add_argument("--resume", default=None, metavar="NPZ",
                   help="Continue accumulating on top of a --checkpoint "
                        "(same scene/camera/resolution/depth)")
    p.add_argument("--nee-weighting", choices=("reference", "physical"), default="reference",
                   help="NEE estimator: 'reference' replicates the reference's throughput "
                        "quirk (raygen.rgen:54-83); 'physical' is the standard weighting")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def compose_transform(scale, rotation, translation) -> np.ndarray:
    """T * R * S composition (main.cpp:159-165; the JAX CLI's cli.py:149-161)."""
    m = np.eye(4)
    if scale is not None:
        m = np.diag(list(scale) + [1.0]) @ m
    if rotation is not None:
        w, x, y, z = rotation
        m = quat_to_mat4(w, x, y, z).astype(np.float64) @ m
    if translation is not None:
        t = np.eye(4)
        t[:3, 3] = translation
        m = t @ m
    return m.astype(np.float32)


def _get(lst, i, n, name, default):
    """The i-th per-model vector of a repeated flag, or ``default``."""
    if lst is None or i >= len(lst):
        return np.asarray(default)
    return _parse_floats(lst[i], n, name, default)


def _resolve_model(name: str, optional: bool = False):
    """Search as given, then $VKRT_RESOURCE_DIR, then ./res (the compile-time
    RESOURCE_DIR of the reference, CMakeLists.txt:56-61)."""
    candidates = [Path(name)]
    res = os.environ.get("VKRT_RESOURCE_DIR")
    if res:
        candidates.append(Path(res) / name)
    candidates.append(Path("res") / name)
    for c in candidates:
        if c.exists():
            return c
    if optional:
        return None
    raise FileNotFoundError(f"model not found: {name} (searched {candidates})")


def load_scene(args) -> Scene:
    models = args.models or ["cornell"]
    if any(m in BUILTIN_SCENES for m in models):
        if len(models) > 1:
            raise SystemExit("builtin scenes cannot be composed with other models")
        scene = BUILTIN_SCENES[models[0]]()
    else:
        scene = Scene()
        for i, model in enumerate(models):
            transform = compose_transform(
                _get(args.scales, i, 3, "scale", (1.0, 1.0, 1.0)),
                _get(args.rotations, i, 4, "rotation", (1.0, 0.0, 0.0, 0.0)),
                _get(args.translations, i, 3, "translation", (0.0, 0.0, 0.0)),
            )
            scene.load_model(_resolve_model(model), transform)
    if args.skybox and not args.no_skybox:
        sky_path = _resolve_model(args.skybox, optional=True)
        if sky_path is None:
            log.warn("skybox %s not found; rendering without environment", args.skybox)
        else:
            scene.skybox = load_texture(sky_path)[..., :3]
    scene.skybox_strength = args.skybox_strength
    return scene


def resolve_device(name: str) -> torch.device:
    """The render device; ``cuda`` without a card is an error, never a
    silent CPU render."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available here (torch {torch.__version__}); "
            "pass --device cpu to render with the plain PyTorch versions of the kernels"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: the port renders on cuda or cpu")
    return device


def _render_fingerprint(tables, camera, width, height, depth, nee) -> str:
    """Digest of everything that must match for two accumulations to blend
    (``_render_fingerprint``, vulkan_raytracer_tpu/cli.py:351-377, and the
    same digest for the same scene and camera): resolution, depth, the NEE
    estimator, the camera pose and cheap checksums of the scene (triangle
    count, coordinate sums, material count, the emissive CDF, the skybox's
    shape and strength) rather than file names."""
    def host(x):
        return x.cpu().numpy()

    h = hashlib.sha256()
    h.update(np.asarray([width, height, depth], np.int64).tobytes())
    h.update(str(nee).encode())
    h.update(np.asarray(camera.position, np.float64).tobytes())
    h.update(np.asarray(camera.direction, np.float64).tobytes())
    h.update(np.float64(getattr(camera, "fov", 0.0)).tobytes())
    for col in (tables.v0.x, tables.v0.y, tables.v0.z, tables.v2.x):
        a = host(col)
        h.update(np.int64(a.shape[0]).tobytes())
        h.update(np.float64(a.sum(dtype=np.float64)).tobytes())
    h.update(np.int64(tables.materials.base_colour.x.shape[0]).tobytes())
    h.update(np.int64(tables.num_emissive_tris).tobytes())
    if tables.num_emissive_tris:
        h.update(np.float64(host(tables.em_cdf).sum(dtype=np.float64)).tobytes())
    h.update(np.asarray((tables.skybox.h, tables.skybox.w), np.int64).tobytes())
    h.update(np.float64(host(tables.skybox_strength)).tobytes())
    return h.hexdigest()


def _load_checkpoint(path, width, height, depth, fingerprint):
    """(accumulated linear sum (H, W, 3), next sample) of a ``--checkpoint``
    file, refused unless it was rendered like this run."""
    ck = np.load(path)
    if tuple(ck["shape"]) != (height, width) or int(ck["depth"]) != depth:
        raise SystemExit("--resume checkpoint does not match this render")
    if "fingerprint" in ck and str(ck["fingerprint"]) != fingerprint:
        raise SystemExit("--resume checkpoint was rendered with a different "
                         "scene/camera/settings (fingerprint mismatch)")
    return ck["acc"].astype(np.float32).reshape(height, width, 3), int(ck["next_sample"])


def _run_progressive(args, tables, camera, width, height) -> dict:
    """The frame loop of ``--progressive`` (vulkan_raytracer_tpu/cli.py:
    241-251): the preview frame and ``--spp`` samples, one ``draw_frame``
    each; writes the last display image."""
    r = Renderer(tables, camera, width, height, args.max_ray_depth)
    frame_ms = []
    t0 = time.perf_counter()
    for i in range(args.spp + 1):  # sample 0 is the preview frame
        t_frame = time.perf_counter()
        img8 = r.draw_frame()
        frame_ms.append(1e3 * (time.perf_counter() - t_frame))
        log.info("frame %d (%.1f ms)", i, frame_ms[-1])
    rays = r.rays_traced
    dt = time.perf_counter() - t0
    write_png(args.output, img8)
    log.info("wrote %s after %d samples (%d rays)", args.output, args.spp, rays)
    mean = (r.accum / float(max(args.spp, 1))).cpu().numpy().reshape(height, width, 3)
    return {"rays": rays, "seconds": dt, "mrays_per_s": rays / dt / 1e6, "image": mean,
            "frames": args.spp + 1, "frame_ms": frame_ms}


def run(argv=None) -> dict:
    """The render behind :func:`main`; returns its statistics (``rays``,
    ``seconds``, ``mrays_per_s``, ``image`` linear mean, ``load_seconds``:
    building or importing the scene with its images, and ``upload``: the
    scene upload's seconds and counts; a ``--progressive`` run adds
    ``frames`` and ``frame_ms``).  ``--interactive`` returns after the viewer
    closes, without an image."""
    args = build_parser().parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported to the torch package yet (ROADMAP.md {item})"
            )
    device = resolve_device(args.device)
    width, height = args.resolution

    t_load = time.perf_counter()
    scene = load_scene(args)
    load_seconds = time.perf_counter() - t_load
    t_up = time.perf_counter()
    tables = scene.upload(device)
    upload = dict(scene.upload_stats, seconds=time.perf_counter() - t_up)
    log.info("scene upload took %.3fs", upload["seconds"])
    setup = {"load_seconds": load_seconds, "upload": upload}

    cam_pos = _parse_floats(args.camera_position, 3, "camera-position", DEFAULT_CAMERA_POS)
    cam_dir = _parse_floats(args.camera_direction, 3, "camera-direction", DEFAULT_CAMERA_DIR)
    camera = Camera(position=cam_pos, direction=cam_dir, aspect=width / height)

    if args.interactive:
        from .viewer import run_viewer

        # the viewer renders at full resolution and decimates the display
        # image to the terminal's cell grid on the device
        run_viewer(tables, camera, width, height, args.max_ray_depth)
        return setup
    if args.progressive:
        return {**_run_progressive(args, tables, camera, width, height), **setup}

    # checkpoint/resume: the accumulation buffer is the render's whole state
    # (raytracer.cpp:129-144), so the linear sum and the sample cursor let a
    # long render continue across runs.  The fingerprint travels in the npz,
    # so --resume refuses to blend accumulations that do not belong together.
    fingerprint = _render_fingerprint(tables, camera, width, height, args.max_ray_depth,
                                     args.nee_weighting)
    acc_prev, start_sample = None, 1
    if args.resume:
        acc_prev, start_sample = _load_checkpoint(args.resume, width, height,
                                                  args.max_ray_depth, fingerprint)
        log.info("resuming at sample %d from %s", start_sample, args.resume)

    profiler = None
    if args.trace:  # a profiler that cannot start is an error, not a warning
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    t0 = time.perf_counter()
    mean_new, rays = render_image(
        tables, camera, width, height, args.spp, args.max_ray_depth,
        start_sample=start_sample, tonemap=False, nee_weighting=args.nee_weighting,
    )
    # one linear accumulation feeds every sink (checkpoint, PNG, HDR)
    acc = np.asarray(mean_new, np.float32) * np.float32(args.spp)
    if acc_prev is not None:
        acc = acc + acc_prev
    total_spp = start_sample - 1 + args.spp
    if args.checkpoint:
        np.savez(args.checkpoint, acc=acc.astype(np.float32),
                 next_sample=np.int64(start_sample + args.spp),
                 shape=np.array([height, width]), depth=np.int64(args.max_ray_depth),
                 fingerprint=np.str_(fingerprint))
        log.info("checkpoint -> %s (%d samples)", args.checkpoint, total_spp)
    mean = acc / np.float32(total_spp)
    img = reinhard_jodie(torch.as_tensor(mean)).numpy()
    dt = time.perf_counter() - t0
    log.info(
        "rendered %dx%d @ %d spp depth %d in %.2fs - %.1f Mrays/s",
        width, height, args.spp, args.max_ray_depth, dt, rays / dt / 1e6,
    )
    if profiler is not None:
        profiler.stop()
        trace = Path(args.trace) / "trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(trace))
        log.info("wrote profiler trace to %s", trace)
    write_png(args.output, img)
    log.info("wrote %s", args.output)
    if args.hdr_output:
        write_hdr(args.hdr_output, mean)
        log.info("wrote %s (same accumulation as the PNG)", args.hdr_output)
    return {"rays": rays, "seconds": dt, "mrays_per_s": rays / dt / 1e6, "image": mean, **setup}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
