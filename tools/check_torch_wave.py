#!/usr/bin/env python3
"""The wave's kernels (``ops/wave.py``) against their plain versions on real
waves.

    python3 tools/check_torch_wave.py [--configs cfg1,gltf147k,...] [--timing]
        [--out FILE.json] [--device cuda|cpu]

Run from the root of a checkout.  For each config, the first wave
``render_image`` would run is rendered once, eagerly
(``graphs._graphs_preferred`` patched off, so every call runs its Python),
with the two wrappers of ``ops/wave.py`` wrapped (:class:`Compare`): each
call launches its kernel and, on the same inputs, runs its plain version
(the alpha commit on a copy of the resample loop's state, which the kernel
writes over), and every field of the two results is compared lane by lane,
the commit's count of pending lanes too.  A float lane that differs is class
``i`` when both sides are finite and at most 4 ulps apart, else class
``ii`` (a fault), as is any integer or flag that differs
(``tools/check_torch_shade.py``'s rule).  On the CPU both sides are the
plain version (a self-test: no lane may differ).

With ``--timing`` (a card) each kernel's first call of the wave (the alpha
commit's: the first pass of the first bounce, every lane pending) is timed
with its inputs out of L2: the kernel 20 times in a captured CUDA graph,
per launch from CUDA events, each launch on the next of copies of its
inputs that span ``check_torch_trace.COLD_BYTES``, four times the card's L2
(the commit, which writes over its state: each on its own copy, every copy
restored and the L2 flushed by a ``COLD_BYTES`` write before each timed
replay, :func:`_commit_ms`), against its plain version eagerly, with its
bytes bound (``wave.primary_rays_bytes``, ``wave.alpha_commit_bytes``) at
the card's memory rate.

One JSON line per config; the exit code is 1 where a lane differs
(``--allow-class-i`` allows class i).  ``chip_smoke.py`` runs
:func:`check_config` for its configs.  It imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("primary_rays", "alpha_commit")
FIRST = 8  # differing lanes listed per config
CONFIGS = ("cfg1", "cfg2", "cfg3", "cfg4", "cfg5", "gltf147k", "textured", "soup", "gallery",
           "alpha_gallery")


class Compare:
    """Inside, each wave wrapper launches its kernel and, on the same
    inputs, runs its plain version; :attr:`lanes` collects each differing
    lane's first differing field of each call."""

    def __init__(self, keep: bool = False):
        self.lanes = []  # {"kernel", "call", "lane", "field", "ulps", "class"}
        self.calls = {k: 0 for k in KERNELS}
        self.max_abs = {k: 0.0 for k in KERNELS}
        self.pending = []  # the lanes pending at each commit call
        #: with ``keep``, each kernel's first call: kernel -> its arguments
        self.keep, self.kept = keep, {}

    def _compare(self, kernel: str, got, want) -> None:
        import torch
        from check_torch_shade import _fields, field_lanes

        call = self.calls[kernel]
        self.calls[kernel] += 1
        got, want = _fields(got), _fields(want)
        names = [name for name, _ in got]
        if names != [name for name, _ in want]:  # a field missing or out of order: a fault
            self.lanes.append({"kernel": f"{kernel}_kernel", "call": call, "lane": None,
                               "field": f"{names} != {[name for name, _ in want]}",
                               "ulps": None, "class": "ii"})
            return
        seen = set()
        for (name, a), (_, b) in zip(got, want):
            idx, ulps = field_lanes(a.reshape(-1), b.reshape(-1))
            if len(idx) and a.dtype.is_floating_point:
                d = (a.reshape(-1)[idx].double() - b.reshape(-1)[idx].double()).abs()
                d = d[~torch.isnan(d)]
                if d.numel():
                    self.max_abs[kernel] = max(self.max_abs[kernel], float(d.max()))
            for lane, u in zip(idx.tolist(), ulps):
                if lane not in seen:
                    seen.add(lane)
                    self.lanes.append({"kernel": f"{kernel}_kernel", "call": call, "lane": lane,
                                       "field": name, "ulps": u,
                                       "class": "i" if u is not None and u <= 4 else "ii"})

    @contextlib.contextmanager
    def on(self):
        import torch

        from vulkan_raytracer_tpu_torch.ops import wave
        from vulkan_raytracer_tpu_torch.render import graphs

        saved = (wave.primary_rays, wave.alpha_commit, graphs._graphs_preferred)
        rays, commit, _ = saved

        def c_rays(*args):
            if self.keep and "primary_rays" not in self.kept:
                self.kept["primary_rays"] = args
            got = rays(*args)
            self._compare("primary_rays", got, wave.primary_rays_reference(*args))
            return got

        def c_commit(tables, st, t_c, tri_c, u_c, v_c, count=None):
            before = {k: v.clone() for k, v in st.items()}
            want = wave.alpha_commit_reference(tables, before, t_c, tri_c, u_c, v_c)
            if count is None:
                count = torch.zeros((), dtype=torch.int64, device=tri_c.device)
            if self.keep and "alpha_commit" not in self.kept:
                self.kept["alpha_commit"] = (tables, before, t_c, tri_c, u_c, v_c, want)
            self.pending.append(int(before["pending"].sum()))
            commit(tables, st, t_c, tri_c, u_c, v_c, count)
            self._compare("alpha_commit", (st, count.reshape(1)),
                          (want, want["pending"].sum().reshape(1)))

        wave.primary_rays, wave.alpha_commit = c_rays, c_commit
        graphs._graphs_preferred = lambda tables: False
        try:
            yield self
        finally:
            wave.primary_rays, wave.alpha_commit, graphs._graphs_preferred = saved

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
                "pending_per_pass": {"first": self.pending[:1], "sum": sum(self.pending),
                                     "passes": len(self.pending)},
                "first": self.lanes[:FIRST]}


def configs(tmp: Path) -> dict:
    """name -> (build the scene's tables on a device, camera, width, height,
    spp, depth): ``tools/check_torch_shade.py``'s configs and the smoke's
    instanced alpha gallery."""
    import chip_smoke
    from check_torch_shade import configs as shade_configs

    out = shade_configs(tmp)
    out["alpha_gallery"] = (
        lambda device: chip_smoke.alpha_gallery_scene().upload(device, instancing=True),
        chip_smoke.TEXTURED_CAM, 128, 128, 16, 4)
    return out


def _commit_ms(tables, before, t_c, tri_c, u_c, v_c, nbytes: int, reps: int) -> float:
    """Device ms an alpha commit: ``reps`` commits in one captured CUDA
    graph, each on its own copy of the pass's state and candidate hit (as
    many copies as make ``check_torch_trace.COLD_BYTES``, at least
    ``reps``); before each timed replay every copy's state is restored and
    a buffer of ``COLD_BYTES`` written, so no commit finds its inputs in L2.
    The mean of three replays."""
    import torch
    from check_torch_trace import COLD_BYTES

    from vulkan_raytracer_tpu_torch.ops import wave

    n = max(reps, -(-COLD_BYTES // nbytes))
    copies = [({k: v.clone() for k, v in before.items()}, t_c.clone(), tri_c.clone(),
               u_c.clone(), v_c.clone(), torch.zeros((), dtype=torch.int64, device=tri_c.device))
              for _ in range(n)]

    def restore():
        for st, *_ in copies:
            for k, v in st.items():
                v.copy_(before[k])

    graph = torch.cuda.CUDAGraph()
    restore()
    with torch.cuda.graph(graph):
        for st, t, tri, u, v, count in copies[:reps]:
            wave.alpha_commit(tables, st, t, tri, u, v, count)
    flush = torch.empty(COLD_BYTES, dtype=torch.uint8, device=tri_c.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(4):  # the first warms up
        restore()
        flush.zero_()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    del graph, copies, flush
    return sum(runs[1:]) / 3


def time_kept(kept: dict, reps: int = 20, plain_reps: int = 3) -> dict:
    """Each kept call's device time on the card per launch, its plain
    version's and its bytes bound (see the module's docstring)."""
    import torch
    from check_torch_shade import _event_ms
    from check_torch_trace import _cold_ms, _copies, _plain_ms
    from chip_smoke import HBM_BYTES_PER_S

    from vulkan_raytracer_tpu_torch.ops import wave

    out = {}
    with torch.inference_mode():  # the wave's tensors are inference tensors
        if "primary_rays" in kept:
            args = kept["primary_rays"]
            samples, lanes, _, _, _, repack, _ = args
            nbytes = wave.primary_rays_bytes(lanes.shape[0], samples.shape[0], repack)
            copies = _copies(args, nbytes)
            out["primary_rays"] = {
                "ms": _cold_ms(wave.primary_rays, copies, reps),
                "plain_ms": _plain_ms(wave.primary_rays_reference, copies, plain_reps),
                "bytes": nbytes, "lanes": lanes.shape[0] * samples.shape[0]}
        if "alpha_commit" in kept:
            tables, before, t_c, tri_c, u_c, v_c, want = kept["alpha_commit"]
            ti = torch.clamp_min(tri_c, 0)
            if tables.inst is not None:
                ti, _ = tables.inst.decode(ti)
            blend = before["pending"] & (tri_c >= 0) & (tables.alpha.mode[ti] == 2)
            nbytes = wave.alpha_commit_bytes(before, tri_c, want, blend)
            out["alpha_commit"] = {
                "ms": _commit_ms(tables, before, t_c, tri_c, u_c, v_c, nbytes, reps),
                "plain_ms": _event_ms(
                    lambda: wave.alpha_commit_reference(tables, before, t_c, tri_c, u_c, v_c),
                    plain_reps),
                "bytes": nbytes, "lanes": tri_c.shape[0],
                "pending": int(before["pending"].sum())}
    for t in out.values():
        t.update(bound_ms=1e3 * t["bytes"] / HBM_BYTES_PER_S, bound_by="bytes")
    return out


def check_config(name: str, spec, device, tables=None, timing: bool = False) -> dict:
    """Render ``spec``'s first wave under :class:`Compare`; one JSON-able
    line.  ``tables`` may be given to skip the build; with ``timing`` (a
    card), each kernel's first call is timed (:func:`time_kept`)."""
    import numpy as np
    import torch
    from profile_torch_wave import first_wave, wave

    from vulkan_raytracer_tpu_torch.ops import wave as wave_ops
    from vulkan_raytracer_tpu_torch.render import graphs
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    build, cam, width, height, spp, depth = spec
    if tables is None:
        tables = build(device)
    camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]), aspect=width / height)
    lanes, samples, _ = first_wave(tables, width, height, spp)
    graphs.settle()
    before = dict(wave_ops.LAUNCHES)
    t0 = time.perf_counter()
    with Compare(keep=timing).on() as cmp:
        radiance, rays = wave(tables, camera, width, height, depth, lanes, samples)()
    launched = {k: wave_ops.LAUNCHES[k] - before[k] for k in KERNELS}
    if device.type == "cuda" and launched != cmp.calls:
        raise AssertionError(f"{name}: {cmp.calls} wave kernel calls, but {launched} launches")
    line = {"config": name, "lanes": len(lanes) * len(samples), "launches": launched,
            "alpha": bool(tables.has_alpha), "rays": int(rays),
            "finite": bool(torch.isfinite(radiance).all()),
            "seconds": time.perf_counter() - t0, **cmp.summary()}
    if timing:
        line["timing"] = time_kept(cmp.kept)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=",".join(CONFIGS))
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
        print("check_torch_wave.py: CUDA is not available", file=sys.stderr)
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
