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
skybox may be a Radiance .hdr, PNG or JPEG file.  ``--progressive``,
``--interactive``, ``--shard``, ``--trace``, ``--checkpoint`` and
``--resume`` raise ``NotImplementedError`` naming the ROADMAP item that
ports them.

``--device cuda`` without a card is an error: the CLI never falls back to
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .ops.tonemap import reinhard_jodie
from .render.renderer import render_image
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
_NOT_PORTED = {
    "progressive": "Queue 1, the progressive renderer and viewer",
    "interactive": "Queue 1, the progressive renderer and viewer",
    "shard": "Queue 1, sharding and multihost",
    "trace": "Queue 1, the progressive renderer and viewer (--trace)",
    "checkpoint": "Queue 1, the progressive renderer and viewer (checkpoint/resume)",
    "resume": "Queue 1, the progressive renderer and viewer (checkpoint/resume)",
}


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
    p.add_argument("--progressive", action="store_true", help="(not ported)")
    p.add_argument("--shard", action="store_true", help="(not ported)")
    p.add_argument("--interactive", action="store_true", help="(not ported)")
    p.add_argument("--trace", default=None, metavar="DIR", help="(not ported)")
    p.add_argument("--checkpoint", default=None, metavar="NPZ", help="(not ported)")
    p.add_argument("--resume", default=None, metavar="NPZ", help="(not ported)")
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


def run(argv=None) -> dict:
    """The headless render behind :func:`main`; returns its statistics
    (``rays``, ``seconds``, ``mrays_per_s``, ``image`` linear mean,
    ``load_seconds``: building or importing the scene with its images, and
    ``upload``: the scene upload's seconds and counts)."""
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

    cam_pos = _parse_floats(args.camera_position, 3, "camera-position", DEFAULT_CAMERA_POS)
    cam_dir = _parse_floats(args.camera_direction, 3, "camera-direction", DEFAULT_CAMERA_DIR)
    camera = Camera(position=cam_pos, direction=cam_dir, aspect=width / height)

    t0 = time.perf_counter()
    mean, rays = render_image(
        tables, camera, width, height, args.spp, args.max_ray_depth,
        tonemap=False, nee_weighting=args.nee_weighting,
    )
    img = reinhard_jodie(torch.as_tensor(mean)).numpy()
    dt = time.perf_counter() - t0
    log.info(
        "rendered %dx%d @ %d spp depth %d in %.2fs - %.1f Mrays/s",
        width, height, args.spp, args.max_ray_depth, dt, rays / dt / 1e6,
    )
    write_png(args.output, img)
    log.info("wrote %s", args.output)
    if args.hdr_output:
        write_hdr(args.hdr_output, mean)
        log.info("wrote %s (same accumulation as the PNG)", args.hdr_output)
    return {"rays": rays, "seconds": dt, "mrays_per_s": rays / dt / 1e6, "image": mean,
            "load_seconds": load_seconds, "upload": upload}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
