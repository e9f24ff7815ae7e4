#!/usr/bin/env python3
"""The kernels around the traversal launches (``ops/trace.py``) against
their plain versions on real waves.

    python3 tools/check_torch_trace.py [--configs cfg1,gltf147k,...] [--timing]
        [--out FILE.json] [--device cuda|cpu]

Run from the root of a checkout.  For each config, the first wave
``render_image`` would run is rendered once, eagerly
(``graphs._graphs_preferred`` patched off, so every call runs its Python),
with the four wrappers of ``ops/trace.py`` wrapped (:class:`Compare`): each
call launches its kernel and, on the same inputs, runs its plain version
(an instance step on a copy of the scan's state, which the kernel writes
over; a gather's columns are also copied by the copy mode against
``copy_``), and every field of the two results is compared lane by lane.
The kernels are to be bit-equal, so any lane that differs is a fault; it
is named by kernel, call, field and ulps, and classed as
``tools/check_torch_shade.py`` classes it: ``i`` when both sides are finite
and at most 4 ulps apart, else ``ii``, as is any integer or flag.  On the
CPU both sides are the plain version (a self-test).

With ``--timing`` (a card) one call of each kernel is timed: the finish's,
the key's and a middle instance step's (a merge and a next instance) first
call of the wave, and the permutation that moves the most bytes (a re-sort's
gather of the whole state).  The kernel runs 20 times in a captured CUDA
graph, per launch from CUDA events, each launch on the next of enough copies
of the call's lane inputs that the copies span :data:`COLD_BYTES`, four
times the card's L2, and each launch's outputs kept: no launch finds its
inputs in L2, so its bytes bound (``trace.hit_finish_bytes`` etc.) at the
card's memory rate is a lower limit on its time.  Its plain version runs
eagerly on the same copies in turn; beside the permutation,
``torch.index_select`` over the same columns, captured the same way
(``library_ms``).

One JSON line per config; the exit code is 1 where a lane differs.
``chip_smoke.py`` runs :func:`check_config` for its configs.  It imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("hit_finish", "instance_step", "coherence_key", "permute")
FIRST = 8  # differing lanes listed per config
CONFIGS = ("cfg1", "cfg2", "cfg3", "gltf147k", "gallery", "cfg4", "textured", "soup",
           "alpha_gallery")
#: The bytes the copies of a timed call's lane inputs span: four times the
#: H100's 50 MB L2.
COLD_BYTES = 4 * 50 * 10**6


def _clone(x):
    """A copy of a tensor, or of the tensors of a dict, list or tuple (a
    named tuple stays one); anything else (the scene tables) is shared."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    if isinstance(x, tuple):
        items = (_clone(v) for v in x)
        return x._make(items) if hasattr(x, "_make") else tuple(items)
    return x


class Compare:
    """Inside, each trace wrapper launches its kernel and, on the same
    inputs, runs its plain version; :attr:`lanes` collects each differing
    lane's first differing field of each call."""

    def __init__(self, keep: bool = False):
        self.lanes = []  # {"kernel", "call", "lane", "field", "ulps", "class"}
        self.calls = {k: 0 for k in KERNELS}
        self.max_abs = {k: 0.0 for k in KERNELS}
        self.modes = {}  # "kernel mode" -> calls
        #: with ``keep``, the calls timed (see the module's docstring)
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
            if a.dtype != b.dtype or a.shape != b.shape:
                self.lanes.append({"kernel": f"{kernel}_kernel", "call": call, "lane": None,
                                   "field": f"{name}: {a.dtype} {tuple(a.shape)} != "
                                            f"{b.dtype} {tuple(b.shape)}",
                                   "ulps": None, "class": "ii"})
                continue
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

    def _mode(self, key: str) -> None:
        self.modes[key] = self.modes.get(key, 0) + 1

    @contextlib.contextmanager
    def on(self):
        import torch

        from vulkan_raytracer_tpu_torch.ops import trace
        from vulkan_raytracer_tpu_torch.render import graphs

        saved = {k: getattr(trace, k) for k in KERNELS}
        preferred = graphs._graphs_preferred

        def c_finish(tables, rays, t, hit, mode):
            self._mode(f"hit_finish {mode}")
            if self.keep and "hit_finish" not in self.kept:
                self.kept["hit_finish"] = (tables, rays, t, hit, mode)
            got = saved["hit_finish"](tables, rays, t, hit, mode)
            self._compare("hit_finish", got,
                          trace.hit_finish_reference(tables, rays, t, hit, mode))
            return got

        def c_step(tables, st, rays, active, t_max, t_min, prev, nxt, shadow):
            self._mode(f"instance_step {'shadow' if shadow else 'closest'}")
            before = _clone(st)
            args = (tables, before, rays, active, t_max, t_min, prev, nxt, shadow)
            middle = prev is not None and nxt is not None
            if self.keep and middle and "instance_step" not in self.kept:
                self.kept["instance_step"] = (tables, st, *args[2:])
            want = trace.instance_step_reference(*args)
            got = saved["instance_step"](tables, st, *args[2:])
            self._compare("instance_step", {k: got[k] for k in want}, want)
            return got

        def c_key(tables, o, d, active):
            self._mode("coherence_key")
            if self.keep and "coherence_key" not in self.kept:
                self.kept["coherence_key"] = (tables, o, d, active)
            got = saved["coherence_key"](tables, o, d, active)
            self._compare("coherence_key", got,
                          trace.coherence_key_reference(tables, o, d, active))
            return got

        def c_permute(cols, perm=None, mode="gather", out=None):
            self._mode(f"permute {mode}")
            cols = list(cols)
            if mode == "copy":
                out = list(out)
                plain = trace.permute_reference(cols, mode="copy", out=[_clone(c) for c in out])
                got = saved["permute"](cols, mode="copy", out=out)
                self._compare("permute", tuple(got), tuple(plain))
                return got
            got = saved["permute"](cols, perm, mode)
            self._compare("permute", tuple(got), tuple(trace.permute_reference(cols, perm, mode)))
            if mode == "gather":  # the copy mode on the same columns
                self._mode("permute copy")
                copies = saved["permute"](got, mode="copy", out=[torch.empty_like(c) for c in got])
                self._compare("permute", tuple(copies), tuple(trace.permute_reference(
                    got, mode="copy", out=[torch.empty_like(c) for c in got])))
                kept = self.kept.get("permute")
                if self.keep and (kept is None or trace.permute_bytes(cols, mode)
                                  > trace.permute_bytes(kept[0], kept[2])):
                    self.kept["permute"] = (cols, perm, mode)
            return got

        trace.hit_finish, trace.instance_step = c_finish, c_step
        trace.coherence_key, trace.permute = c_key, c_permute
        graphs._graphs_preferred = lambda tables: False
        try:
            yield self
        finally:
            for k, fn in saved.items():
                setattr(trace, k, fn)
            graphs._graphs_preferred = preferred

    def summary(self) -> dict:
        def count(key):
            out = {}
            for lane in self.lanes:
                out[str(lane[key])] = out.get(str(lane[key]), 0) + 1
            return out

        return {"calls": dict(self.calls), "modes": dict(self.modes),
                "max_abs_err": dict(self.max_abs), "differing_lanes": len(self.lanes),
                "by_class": {c: sum(x["class"] == c for x in self.lanes) for c in ("i", "ii")},
                "by_kernel": count("kernel"), "by_field": count("field"),
                "first": self.lanes[:FIRST]}


def _copies(args: tuple, nbytes: int) -> list:
    """``args`` and copies of it (:func:`_clone`), so many that the calls'
    ``nbytes`` each span :data:`COLD_BYTES`."""
    return [args] + [_clone(args) for _ in range(max(2, -(-COLD_BYTES // nbytes)) - 1)]


def _cold_ms(fn, copies: list, reps: int = 20) -> float:
    """Device ms a launch of ``fn``: ``reps`` calls, each on the next of
    ``copies``, captured in one CUDA graph with every call's outputs kept,
    a replay timed with CUDA events.  With one copy the inputs stay in L2
    from launch to launch."""
    import torch
    from check_torch_shade import _event_ms

    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(reps):
            outs.append(fn(*copies[i % len(copies)]))
    ms = _event_ms(graph.replay, 3)
    del graph, outs
    return ms / reps


def _plain_ms(fn, copies: list, reps: int = 3) -> float:
    """Device ms a call of the plain ``fn``, eagerly, on ``copies`` in turn."""
    from check_torch_shade import _event_ms

    turn = itertools.cycle(copies)
    return _event_ms(lambda: fn(*next(turn)), reps)


def time_kept(kept: dict) -> dict:
    """Each kept call's device time on the card per launch, its plain
    version's, its bytes bound and, for the permutation, ``index_select``'s
    over the same columns (see the module's docstring)."""
    import torch
    from chip_smoke import HBM_BYTES_PER_S

    from vulkan_raytracer_tpu_torch.ops import trace

    out = {}
    with torch.inference_mode():  # the wave's tensors are inference tensors
        if "hit_finish" in kept:
            args = kept["hit_finish"]
            nbytes = trace.hit_finish_bytes(args[3])
            copies = _copies(args, nbytes)
            out["hit_finish"] = {
                "ms": _cold_ms(trace.hit_finish, copies),
                "plain_ms": _plain_ms(trace.hit_finish_reference, copies),
                "bytes": nbytes, "lanes": args[3].shape[0], "mode": args[4],
                "found": int((args[3] >= 0).sum())}
        if "instance_step" in kept:
            args = kept["instance_step"]
            active, t_max, nxt, shadow = args[3], args[4], args[7], args[8]
            n = active.shape[0]
            nbytes = trace.instance_step_bytes(
                n, first=False, prev=True, nxt=True, shadow=shadow,
                t_max_lanes=isinstance(t_max, torch.Tensor), t_lo=False)
            copies = _copies(args, nbytes)
            out["instance_step"] = {  # the plain version writes over no state
                "ms": _cold_ms(trace.instance_step, copies),
                "plain_ms": _plain_ms(trace.instance_step_reference, copies),
                "bytes": nbytes, "lanes": n, "shadow": shadow,
                "next_blas": nxt.group.pblas is not None}
        if "coherence_key" in kept:
            args = kept["coherence_key"]
            n = args[3].shape[0]
            nbytes = trace.coherence_key_bytes(n)
            copies = _copies(args, nbytes)
            out["coherence_key"] = {
                "ms": _cold_ms(trace.coherence_key, copies),
                "plain_ms": _plain_ms(trace.coherence_key_reference, copies),
                "bytes": nbytes, "lanes": n}
        if "permute" in kept:
            cols, perm, mode = args = kept["permute"]
            nbytes = trace.permute_bytes(cols, mode)
            copies = _copies(args, nbytes)
            out["permute"] = {
                "ms": _cold_ms(trace.permute, copies),
                "plain_ms": _plain_ms(trace.permute_reference, copies),
                "library_ms": _cold_ms(
                    lambda cs, p, _: [torch.index_select(c, 0, p) for c in cs], copies),
                "bytes": nbytes, "lanes": perm.shape[0], "columns": len(cols), "mode": mode}
    for t in out.values():
        t.update(bound_ms=1e3 * t["bytes"] / HBM_BYTES_PER_S, bound_by="bytes")
    return out


def check_config(name: str, spec, device, tables=None, timing: bool = False) -> dict:
    """Render ``spec``'s first wave under :class:`Compare`; one JSON-able
    line.  ``tables`` may be given to skip the build; with ``timing`` (a
    card), one call of each kernel is timed (:func:`time_kept`)."""
    import numpy as np
    import torch
    from profile_torch_wave import first_wave, wave

    from vulkan_raytracer_tpu_torch.ops import instanced, trace
    from vulkan_raytracer_tpu_torch.render import graphs
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    build, cam, width, height, spp, depth = spec
    if tables is None:
        tables = build(device)
    camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]), aspect=width / height)
    lanes, samples, _ = first_wave(tables, width, height, spp)
    graphs.settle()
    before = dict(trace.LAUNCHES)
    instanced.reset_stats()
    t0 = time.perf_counter()
    with Compare(keep=timing).on() as cmp:
        radiance, rays = wave(tables, camera, width, height, depth, lanes, samples)()
    launched = {k: trace.LAUNCHES[k] - before[k] for k in trace.LAUNCHES}
    copies = launched.pop("permute_copy")  # the check's own: the eager wave copies nothing
    kernels = {**launched, "permute": launched["permute"] + copies}
    if device.type == "cuda" and kernels != cmp.calls:
        raise AssertionError(f"{name}: {cmp.calls} calls, but {kernels} launches")
    line = {"config": name, "lanes": len(lanes) * len(samples), "launches": launched,
            "instance_steps": dict(instanced.STATS), "rays": int(rays),
            "finite": bool(torch.isfinite(radiance).all()),
            "seconds": time.perf_counter() - t0, **cmp.summary()}
    if timing:
        line["timing"] = time_kept(cmp.kept)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=",".join(CONFIGS))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--timing", action="store_true",
                   help="time one call of each kernel against its plain version (a card)")
    p.add_argument("--out", help="write every line here as well")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("check_torch_trace.py: CUDA is not available", file=sys.stderr)
        return 2
    from check_torch_wave import configs

    device = torch.device(args.device)
    bad = False
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        specs = configs(Path(tmp))
        for name in args.configs.split(","):
            line = check_config(name, specs[name], device, timing=args.timing)
            lines.append(line)
            print(json.dumps(line), flush=True)
            bad |= bool(line["differing_lanes"]) or not line["finite"]
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
