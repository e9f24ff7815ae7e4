#!/usr/bin/env python3
"""The shading kernels against their plain versions on the bounce states of
real waves.

    python3 tools/check_torch_shade.py [--configs cfg1,glass_lights,...] [--out FILE.json]
        [--device cuda|cpu]

Run from the root of a checkout.  For each config, the first wave
``render_image`` would run is rendered once, eagerly
(``graphs._graphs_preferred`` patched off, so every bounce runs its Python),
with the three wrappers of ``ops/shade.py`` wrapped (:class:`Compare`):
each call launches its kernel and, on the same inputs, runs the kernel's
plain version, and every field of the two results is compared lane by lane
(the resolve's rays as the count each adds).  A float lane that differs is
class ``i`` when both sides are finite and at most 4 ulps apart, else class
``ii`` (a fault), as is any integer or flag that differs; each differing
lane is named by its kernel, its field, its bounce and its ulps.  On the CPU
both sides are the plain version (a self-test: no lane may differ).

One JSON line per config: lanes, calls and launches per kernel, the
differing lanes by class, kernel and field, the first few lanes, the wave's
rays and whether its radiance is finite; the exit code is 1 where a lane
differs (``--allow-class-i`` allows class i).  ``chip_smoke.py`` runs
:func:`check_config` for its configs.  It imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("hit", "scatter", "resolve")
FIRST = 8  # differing lanes listed per config


def _fields(obj, prefix: str = "") -> list:
    """(name, tensor) of every tensor of a result: dataclasses, V3s,
    tuples and dicts walked in order."""
    import torch

    from vulkan_raytracer_tpu_torch.ops.math3 import V3

    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    if isinstance(obj, V3):
        return [(f"{prefix}.{c}", t) for c, t in zip("xyz", obj)]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _fields(getattr(obj, f.name), f"{prefix}.{f.name}".lstrip("."))]
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in _fields(v, f"{prefix}.{k}".lstrip("."))]
    if isinstance(obj, tuple):
        return [x for i, v in enumerate(obj) for x in _fields(v, f"{prefix}[{i}]")]
    return []


def _ordered(bits):
    """float32 bit patterns (int64) on a line where adjacent floats are 1 apart."""
    return np.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def field_lanes(a, b) -> tuple:
    """(differing lane indices, their ulps or None for a non-float field or
    a NaN/inf on one side) of two tensors of one field."""
    import torch

    if a.dtype.is_floating_point:
        nan = torch.isnan(a) & torch.isnan(b)
        diff = (a.view(torch.int32) != b.view(torch.int32)) & ~nan
        idx = torch.nonzero(diff).flatten()
        if not idx.numel():
            return idx.cpu().numpy(), []
        x, y = a[idx].cpu().numpy(), b[idx].cpu().numpy()
        xb = _ordered(x.view(np.int32).astype(np.int64))
        yb = _ordered(y.view(np.int32).astype(np.int64))
        finite = np.isfinite(x) & np.isfinite(y)
        ulps = [int(u) if f else None for u, f in zip(np.abs(xb - yb), finite)]
        return idx.cpu().numpy(), ulps
    idx = torch.nonzero(a != b).flatten().cpu().numpy()
    return idx, [None] * len(idx)


class Compare:
    """Inside, each shading wrapper launches its kernel and, on the same
    inputs, runs its plain version; :attr:`lanes` collects each differing
    lane's first differing field of each call."""

    def __init__(self, keep: bool = False):
        self.lanes = []  # {"kernel", "call", "bounce", "lane", "field", "ulps", "class"}
        self.calls = {k: 0 for k in KERNELS}
        self.max_abs = {k: 0.0 for k in KERNELS}
        self.bounce = -1
        #: with ``keep``, each kernel's first call (bounce 0: every lane
        #: live), for :func:`time_kept`: kernel -> (tables, args)
        self.keep, self.kept = keep, {}

    def _compare(self, kernel: str, got, want) -> None:
        import torch

        call = self.calls[kernel]
        self.calls[kernel] += 1
        seen = set()
        got, want = _fields(got), _fields(want)
        names = [name for name, _ in got]
        if names != [name for name, _ in want]:  # a field missing or out of order: a fault
            self.lanes.append({"kernel": f"shade_{kernel}_kernel", "call": call,
                               "bounce": self.bounce, "lane": None,
                               "field": f"{names} != {[name for name, _ in want]}",
                               "ulps": None, "class": "ii"})
            return
        for (name, a), (_, b) in zip(got, want):
            idx, ulps = field_lanes(a.reshape(-1), b.reshape(-1))
            if len(idx) and a.dtype.is_floating_point:
                d = (a.reshape(-1)[idx].double() - b.reshape(-1)[idx].double()).abs()
                d = d[~torch.isnan(d)]
                if d.numel():
                    self.max_abs[kernel] = max(self.max_abs[kernel], float(d.max()))
            for lane, u in zip(idx.tolist(), ulps):
                if lane in seen:
                    continue
                seen.add(lane)
                self.lanes.append({"kernel": f"shade_{kernel}_kernel", "call": call,
                                   "bounce": self.bounce, "lane": lane, "field": name,
                                   "ulps": u, "class": "i" if u is not None and u <= 4 else "ii"})

    @contextlib.contextmanager
    def on(self):
        from vulkan_raytracer_tpu_torch.ops import shade
        from vulkan_raytracer_tpu_torch.render import graphs

        saved = (shade.shade_hit, shade.shade_scatter, shade.shade_resolve,
                 graphs._graphs_preferred)
        hit, scatter, resolve, _ = saved

        def c_hit(tables, s, b, *args):
            self.bounce = int(b)
            if self.keep and "hit" not in self.kept:
                self.kept["hit"] = (tables, s, b, *args)
            got = hit(tables, s, b, *args)
            self._compare("hit", got, shade.shade_hit_reference(tables, s, b, *args))
            return got

        def c_scatter(*args):
            if self.keep and "scatter" not in self.kept:
                self.kept["scatter"] = args
            got = scatter(*args)
            self._compare("scatter", got, shade.shade_scatter_reference(*args))
            return got

        def c_resolve(*args):
            rays = args[-1]
            if self.keep and "resolve" not in self.kept:
                self.kept["resolve"] = (*args[:-1], rays.clone())
            before = rays.clone()
            want_rays = rays.clone()
            want = shade.shade_resolve_reference(*args[:-1], want_rays)
            got = resolve(*args)
            self._compare("resolve", (got, rays - before), (want, want_rays - before))
            return got

        shade.shade_hit, shade.shade_scatter, shade.shade_resolve = c_hit, c_scatter, c_resolve
        graphs._graphs_preferred = lambda tables: False
        try:
            yield self
        finally:
            (shade.shade_hit, shade.shade_scatter, shade.shade_resolve,
             graphs._graphs_preferred) = saved

    def summary(self) -> dict:
        def count(key):
            out = {}
            for lane in self.lanes:
                out[str(lane[key])] = out.get(str(lane[key]), 0) + 1
            return out

        return {"calls": dict(self.calls), "max_abs_err": dict(self.max_abs),
                "differing_lanes": len(self.lanes),
                "by_class": {c: sum(x["class"] == c for x in self.lanes) for c in ("i", "ii")},
                "by_kernel": count("kernel"), "by_field": count("field"),
                "by_bounce": count("bounce"), "first": self.lanes[:FIRST]}


# ---------------------------------------------------------------------------
# The configs: the bench's, the smoke's glTF, soup and gallery frames, and a
# glass scene with analytic lights and dispersion
# ---------------------------------------------------------------------------


def lights_scene():
    """The built-in glass sphere, dispersive, under two point lights (one with
    a range) and a directional light, beside its emissive quad: both NEE
    strategies, delta lights, dispersion, transmission and volume
    absorption."""
    from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
    from vulkan_raytracer_tpu_torch.scene.builtin import glass_sphere_scene

    s = glass_sphere_scene(dispersion=0.4)
    s.point_lights += [
        tsg.PointLight(position=np.array([0.8, 1.6, 0.6], np.float32),
                       colour=np.array([1.0, 0.9, 0.7], np.float32), intensity=6.0, range=0.0),
        tsg.PointLight(position=np.array([-0.7, 1.2, 1.0], np.float32),
                       colour=np.array([0.6, 0.7, 1.0], np.float32), intensity=4.0, range=3.0)]
    s.directional_lights += [
        tsg.DirectionalLight(direction=np.array([0.3, -1.0, -0.4], np.float32),
                             colour=np.array([1.0, 1.0, 1.0], np.float32), intensity=1.5)]
    return s


def wild_aniso_scene(n_side: int = 32, seed: int = 3):
    """A wall of n_side x n_side quads facing the camera, each with its own
    anisotropic material whose rotation is a random finite float32 bit
    pattern (every exponent, both signs; the largest float among them),
    under an emissive quad: the hit kernel's sine and cosine of the rotation
    against torch.sin / torch.cos on every magnitude."""
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Material, Primitive, Scene

    r = np.random.default_rng(seed)
    n = n_side * n_side
    angles = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    angles = np.where(np.isfinite(angles), angles, np.float32(1.0))  # the image stays finite
    special = np.array([0.0, -0.0, 105614.99, 105615.0, 105616.0, 1.5707964, 3.1415927, 1e5,
                        -3e7, 3.4028235e38], np.float32)
    angles[:special.size] = special
    s = Scene()
    prims = []
    for k in range(n):
        m = Material()
        m.metallic_factor = float(k % 2)
        m.roughness_factor = 0.4
        m.anisotropy_strength = 0.7
        m.anisotropy_rotation = float(angles[k])
        s.materials.append(m)
        x0, y0 = (k % n_side) / n_side * 2.0 - 1.0, (k // n_side) / n_side * 2.0
        d = 2.0 / n_side
        pos = np.array([[x0, y0, 0.0], [x0 + d, y0, 0.0], [x0 + d, y0 + d, 0.0],
                        [x0, y0 + d, 0.0]], np.float32)
        prims.append(Primitive(positions=pos, normals=np.tile([0.0, 0.0, 1.0], (4, 1)).astype(
            np.float32), tangents=np.tile([1.0, 0.0, 0.0, 1.0], (4, 1)).astype(np.float32),
            uvs=np.zeros((4, 2), np.float32), indices=np.array([0, 1, 2, 0, 2, 3], np.uint32),
            material=k))
    s.mesh_pool.append(prims)
    s.add_node(s.root, np.eye(4, dtype=np.float32), mesh=0)
    light = Material()
    light.emissive_factor = np.full(3, 8.0, np.float32)
    s.add_raw_mesh(np.array([[-0.5, 2.4, 0.5], [0.5, 2.4, 0.5], [0.5, 2.4, 1.5],
                             [-0.5, 2.4, 1.5]], np.float32),
                   np.tile([0.0, -1.0, 0.0], (4, 1)).astype(np.float32),
                   np.array([0, 2, 1, 0, 3, 2], np.uint32), light)
    return s


def configs(tmp: Path) -> dict:
    """name -> (build the scene's tables on a device, camera, width, height,
    spp, depth)."""
    import chip_smoke
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch import bench
    from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg

    def glb(big: bool):
        def build(device):
            scene = tsg.Scene()
            path = (torch_glb_assets.write_bigasset_glb(tmp, big=True) if big
                    else torch_glb_assets.write_textured_glb(tmp))
            scene.load_model(path)
            return scene.upload(device)
        return build

    out = {}
    for cfg in bench.CONFIGS:
        name = cfg["key"].split("_")[0]
        out[name] = (lambda device, c=cfg: c["build"]().upload(device), cfg["cam"], cfg["w"],
                     cfg["h"], cfg["spp"], cfg["depth"])
    out["gltf147k"] = (glb(True), chip_smoke.BIGASSET_CAM, 512, 512, 4, 4)
    out["textured"] = (glb(False), chip_smoke.TEXTURED_CAM, 512, 512, 16, 4)
    out["soup"] = (lambda device: chip_smoke.emitter_soup_scene(100000, 5000, seed=31)
                   .upload(device), ([0.0, 0.0, 3.0], [0.0, 0.0, -1.0]), 512, 512, 4, 4)
    out["gallery"] = (lambda device: chip_smoke.gallery_scene().upload(device, instancing=True),
                      chip_smoke.gallery_camera(), 512, 512, 4, 4)
    out["glass_lights"] = (lambda device: lights_scene().upload(device),
                           ([0.0, 0.9, 2.6], [0.0, -0.2, -1.0]), 512, 512, 2, 6)
    out["wild_aniso"] = (lambda device: wild_aniso_scene().upload(device),
                         ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0]), 512, 512, 2, 3)
    return out


def _event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_kept(kept: dict, reps: int = 20, plain_reps: int = 3) -> dict:
    """Each kept call's device time on the card: the kernel ``reps`` times
    in one captured CUDA graph (as a wave's program launches it), per launch,
    from CUDA events around its replay, each launch on the next of enough
    copies of the call's inputs that the copies span
    ``check_torch_trace.COLD_BYTES``, four times the card's L2, so no launch
    finds its inputs in L2; the plain version eagerly on the same copies in
    turn, CUDA events over ``plain_reps`` runs; the bound, the lane columns'
    bytes (``shade.lane_bytes``: each on the lanes the call reads it on) at
    the memory rate."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import shade

    out = {}
    for k, args in kept.items():  # the wave's tensors are inference tensors
        with torch.inference_mode():
            out[k] = _time_one(getattr(shade, f"shade_{k}"),
                               getattr(shade, f"shade_{k}_reference"), k, args, reps,
                               plain_reps)
    return out


def _time_one(kernel, plain, k: str, args, reps: int, plain_reps: int) -> dict:
    """:func:`time_kept` of one kernel's call ``args``."""
    from check_torch_trace import _cold_ms, _copies, _plain_ms
    from chip_smoke import HBM_BYTES_PER_S

    from vulkan_raytracer_tpu_torch.ops import shade

    nbytes = shade.lane_bytes(k, args, kernel(*args))
    copies = _copies(args, nbytes)
    return {"ms": _cold_ms(kernel, copies, reps),
            "plain_ms": _plain_ms(plain, copies, plain_reps),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "bytes": nbytes, "lanes": int(args[1]["active"].shape[0]), "copies": len(copies)}


def check_config(name: str, spec, device, tables=None, timing: bool = False) -> dict:
    """Render ``spec``'s first wave under :class:`Compare`; one JSON-able
    line.  ``tables`` may be given to skip the build; with ``timing`` (a
    card), each kernel's first call is timed against its plain version
    (:func:`time_kept`)."""
    import torch
    from profile_torch_wave import first_wave, wave

    from vulkan_raytracer_tpu_torch.ops import shade
    from vulkan_raytracer_tpu_torch.render import graphs
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    build, cam, width, height, spp, depth = spec
    if tables is None:
        tables = build(device)
    camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]), aspect=width / height)
    lanes, samples, _ = first_wave(tables, width, height, spp)
    graphs.settle()
    before = dict(shade.LAUNCHES)
    t0 = time.perf_counter()
    with Compare(keep=timing).on() as cmp:
        radiance, rays = wave(tables, camera, width, height, depth, lanes, samples)()
    launched = {k: shade.LAUNCHES[k] - before[k] for k in KERNELS}
    if device.type == "cuda" and launched != cmp.calls:
        raise AssertionError(f"{name}: {cmp.calls} shading calls, but {launched} launches")
    line = {"config": name, "lanes": len(lanes) * len(samples), "launches": launched,
            "rays": int(rays), "finite": bool(torch.isfinite(radiance).all()),
            "seconds": time.perf_counter() - t0, **cmp.summary()}
    if timing:
        line["timing"] = time_kept(cmp.kept)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default="cfg1,cfg2,cfg3,cfg4,gltf147k,textured,soup,gallery,"
                   "glass_lights,wild_aniso")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--allow-class-i", action="store_true")
    p.add_argument("--timing", action="store_true",
                   help="time each kernel's first call against its plain version (a card)")
    p.add_argument("--out", help="write every line here as well")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("check_torch_shade.py: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    bad = False
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        specs = configs(Path(tmp))
        for name in args.configs.split(","):
            line = check_config(name, specs[name], device, timing=args.timing)
            lines.append(line)
            print(json.dumps(line), flush=True)
            bad |= bool(line["by_class"]["ii"] or (line["by_class"]["i"]
                                                   and not args.allow_class_i))
            bad |= not line["finite"]
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
