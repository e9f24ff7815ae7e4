#!/usr/bin/env python3
"""Count the kernels one wave would launch on a card, on the CPU.

    python3 tools/count_torch_wave_kernels.py [--size 64] [--depth 4] [--root DIR]
        [--scene cornell|textured|textured_bvh|instanced]

Run from the root of a checkout (``--root`` imports another checkout's
package, e.g. the parent commit unpacked under ``out/parent``).  Renders one
wave of bench cfg1's Cornell box (or the textured glb of
tests/test_textured_glb.py with its alpha loop, on the dense sweeps or
uploaded onto the BVH walks; or ``instanced``: ``chip_smoke.gallery_scene``
with 4 dragons of 712 triangles, each a BLAS (``DENSE_MAX_TRIS`` shrunk to
500), beside the dense floor and panels, a repacked wave; ``--size`` squared
lanes, sample 1) on CPU tables under a ``TorchDispatchMode`` and counts the
aten ops that launch a kernel on a card (views, allocations and the host's
scalar wrappers aside), each hand-written kernel's plain version, and each
of ``ops/wave.py``'s wrappers, as one launch.  Prints one JSON line: kernels
per wave, per bounce (from a depth-0 wave against the asked depth), per
alpha resample pass (the most one pass issued), per instance step (the
instanced scene's kernels between two steps, the most one issued), the
bounces run, the ops most often issued and the kernels by the port
function that issued them (``by_function``: the innermost function of the
package on the Python stack, its module and name).  A count, not a device
metric: the card's own counts come from ``tools/profile_torch_wave.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

#: aten ops that launch nothing on a card
NOT_KERNELS = {"empty", "empty_strided", "unbind", "select", "slice", "view", "alias", "detach",
               "expand", "t", "_unsafe_view", "as_strided", "lift_fresh", "unsqueeze", "squeeze",
               "permute", "transpose", "split", "narrow", "_local_scalar_dense", "scalar_tensor"}
#: (module, function): the plain versions of the hand-written kernels, one launch a call
PLAIN = (("dense", "closest_sweep_reference"), ("dense", "shadow_sweep_reference"),
         ("dense", "pdf_sweep_reference"), ("traverse", "bvh_walk_reference"),
         ("traverse", "treelet_walk_reference"), ("traverse", "emissive_pdf_walk_reference"),
         ("shade", "shade_hit_reference"), ("shade", "shade_scatter_reference"),
         ("shade", "shade_resolve_reference"), ("wave", "primary_rays"),
         ("wave", "alpha_commit"), ("trace", "hit_finish_reference"),
         ("trace", "instance_step_reference"), ("trace", "coherence_key_reference"),
         ("trace", "permute_reference"))


def _tables(scene: str):
    """CPU tables of ``scene`` and its camera (position, direction)."""
    import tempfile

    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    if scene == "cornell":
        return cornell_box_scene().upload("cpu"), ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if scene == "instanced":
        sys.path.append(str(Path(__file__).resolve().parent.parent))
        import chip_smoke

        from vulkan_raytracer_tpu_torch.ops import dense

        dense.DENSE_MAX_TRIS = 500  # the 712-triangle dragon walks its BLAS
        tables = chip_smoke.gallery_scene(detail=12, n_dragons=4).upload("cpu", instancing=True)
        assert [g.pblas is not None for g in tables.inst.groups] == [True, False, False]
        return tables, chip_smoke.gallery_camera(4)
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg

    s = tsg.Scene()
    with tempfile.TemporaryDirectory() as tmp:
        s.load_model(torch_glb_assets.write_textured_glb(tmp))
    return (s.upload("cpu", traversal="bvh" if scene == "textured_bvh" else "auto"),
            ([0.0, 0.0, 2.8], [0.0, 0.0, -1.0]))


def count(size: int, depth: int, scene: str = "cornell") -> dict:
    import importlib

    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    from vulkan_raytracer_tpu_torch.render import integrator, renderer
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    import sys as _sys

    package = str(Path(integrator.__file__).resolve().parent.parent)

    def issuer() -> str:
        """The innermost function of the package on the stack."""
        f = _sys._getframe(2)
        while f is not None and not f.f_code.co_filename.startswith(package):
            f = f.f_back
        if f is None:
            return "?"
        return f"{Path(f.f_code.co_filename).stem}.{f.f_code.co_name}"

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.kernels, self.paused, self.ops, self.by_function = 0, 0, {}, {}

        def add(self, where: str) -> None:
            self.kernels += 1
            self.by_function[where] = self.by_function.get(where, 0) + 1

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if not self.paused and name not in NOT_KERNELS:
                self.add(issuer())
                self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    mode = Count()

    def one_launch(fn, where):
        def call(*args, **kw):
            mode.paused += 1
            try:
                return fn(*args, **kw)
            finally:
                mode.paused -= 1
                mode.add(where)
        return call

    for mod, name in PLAIN:
        try:
            m = importlib.import_module(f"vulkan_raytracer_tpu_torch.ops.{mod}")
        except ImportError:  # a checkout without that module
            continue
        if hasattr(m, name):
            setattr(m, name, one_launch(getattr(m, name), f"{mod}.{name}"))
    passes = []
    alpha_pass = integrator._alpha_pass

    def counted_pass(*args, **kw):
        before = mode.kernels
        try:
            return alpha_pass(*args, **kw)
        finally:
            passes.append(mode.kernels - before)

    integrator._alpha_pass = counted_pass
    steps, last = [], []
    try:
        from vulkan_raytracer_tpu_torch.ops import trace

        step = trace.instance_step

        def counted_step(*args, **kw):  # a step and its instance's launch
            if last:
                steps.append(mode.kernels - last[0])
            last[:] = [mode.kernels] if args[7] is not None else []
            return step(*args, **kw)

        trace.instance_step = counted_step
    except ImportError:  # a checkout without that module
        pass
    tables, (pos, direction) = _tables(scene)
    cam = Camera(position=np.array(pos), direction=np.array(direction))
    view_inv, proj_inv = renderer.camera_uniforms(cam)
    out = {}
    for d in (0, depth):
        mode.kernels, mode.ops, mode.by_function = 0, {}, {}
        integrator.reset_bounce_widths()
        with mode:
            integrator.render_sample(tables, view_inv, proj_inv, size, size, 1, d)
        out[d] = (mode.kernels, sum(integrator.BOUNCE_WIDTHS.values()), dict(mode.ops),
                  dict(mode.by_function))
    kernels, bounces, ops, by_function = out[depth]
    return {"scene": scene, "lanes": size * size, "depth": depth, "bounces": bounces,
            "kernels_per_wave": kernels,
            "kernels_per_bounce": (kernels - out[0][0]) / max(bounces - out[0][1], 1),
            "kernels_per_alpha_pass": max(passes, default=0),
            "kernels_per_instance_step": max(steps, default=0),
            "top_ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:10]),
            "by_function": dict(sorted(by_function.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    p.add_argument("--scene", default="cornell",
                   choices=("cornell", "textured", "textured_bvh", "instanced"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    print(json.dumps({"root": args.root, **count(args.size, args.depth, args.scene)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
