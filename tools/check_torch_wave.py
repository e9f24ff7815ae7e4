#!/usr/bin/env python3
"""The wave's kernels (``ops/wave.py``) against their plain versions on real
waves.

    python3 tools/check_torch_wave.py [--configs cfg1,gltf147k,...] [--timing]
        [--synthetic] [--root DIR] [--out FILE.json] [--device cuda|cpu]

Run from the root of a checkout.  For each config, the first wave
``render_image`` would run is rendered once, eagerly
(``graphs._graphs_preferred`` patched off, so every call runs its Python),
with the three wrappers of ``ops/wave.py`` a wave calls wrapped
(:class:`Compare`): each call launches its kernel and, on the same inputs,
runs its plain version (the alpha commit, which finishes the traversal's
raw hit on the pending lanes: on a copy of the resample loop's state, which
the kernel writes over, against ``alpha_pass_reference``, the plain finish
and commit; the wave's tail, ``wave_sum``, on copies of the band's sum and
the frame's ray counter, which it adds into, and also with the other
radiance flag than its wave's on the same inputs, into copies of both, so
that each wave holds both of its kernel's instances: the line's
``other_flag``), and every field of the two results is compared lane by
lane, the count of pending lanes the commit leaves in its control block
too.  The configs are the smoke's (``tools/check_torch_shade.py``'s, the
instanced alpha gallery), ``cfg4_gate``, bench cfg4's gate crop under its
HDR sky, and :data:`SAMPLE_WAVES`, one sample of a whole frame as the
progressive frame and ``render_sample`` run it (its radiance asked for; on
a repacked scene in pixel order).  A float lane that differs is class
``i`` when both sides are finite and at most 4 ulps apart, else class
``ii`` (a fault), as is any integer or flag that differs
(``tools/check_torch_shade.py``'s rule).  On the CPU both sides are the
plain version (a self-test: no lane may differ).

With ``--timing`` (a card) each kernel's first call of the wave (the alpha
commit's: the first pass of the first bounce, every lane pending) is timed
with its inputs out of L2 (a pass's tail after its traversal: the fused
commit with its count, or in an older checkout's package, whose commit
took the finished hit, the finish over every lane, the count's memset and
the commit): the kernel 20 times in a captured CUDA graph,
per launch from CUDA events, each launch on the next of copies of its
inputs that span ``check_torch_trace.COLD_BYTES``, four times the card's L2
(the commit, which writes over its state: each on its own copy, every copy
restored and the L2 flushed by a ``COLD_BYTES`` write before each timed
replay, :func:`_commit_ms`), against its plain version eagerly, with its
bytes bound (``wave.primary_rays_bytes``, ``wave.alpha_commit_bytes``,
``wave.wave_sum_bytes``, which leaves out the scratch a repacked wave's
kernel writes and reads back: ``scratch_bytes``) at the card's memory
rate; the tail also with the other radiance flag than its wave's
(``other_flag_ms``: the per-lane radiance written or not).  Then every
alpha pass of the wave is timed so, with its pending lanes and its bound:
the ``alpha_passes`` table, whose ``lost_us`` is the time above the
bounds, summed over the wave.

With ``--synthetic`` the alpha commit is held bit-equal to its plain
version on raw traversal results (rays, t and hit ids) and loop states
made from a seed at pending shares
of none, one lane, ~1% and every lane, over the smoke's alpha gallery
instanced and flattened and its untextured twin, at 1, 1,025 and 524,287
lanes (and on a card timed cold at 524,288): :func:`synthetic`.

``--root DIR`` checks and times the package of another checkout (the
parent commit's, unpacked under ``out/``) with this tree's tool.

One JSON line per config; the exit code is 1 where a lane differs
(``--allow-class-i`` allows class i).  ``chip_smoke.py`` runs
:func:`check_config` for its configs and :func:`synthetic`.  It imports
neither jax nor the JAX package.
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
KERNELS = ("primary_rays", "alpha_commit", "wave_sum")
FIRST = 8  # differing lanes listed per config
#: one sample of a whole frame over a config's scene: name -> the config
SAMPLE_WAVES = {"cfg1_sample": "cfg1", "cfg2_sample": "cfg2"}
CONFIGS = ("cfg1", "cfg2", "cfg3", "cfg4", "cfg5", "gltf147k", "textured", "soup", "gallery",
           "alpha_gallery", "cfg4_gate", *SAMPLE_WAVES)
#: The synthetic passes' pending shares (None: one lane) and lane counts
#: (:func:`synthetic`); the last count is timed on a card.
PENDING_SHARES = (0.0, None, 0.01, 1.0)
SYNTHETIC_LANES = (1, 1025, 524287, 524288)


class Compare:
    """Inside, each wave wrapper launches its kernel and, on the same
    inputs, runs its plain version; :attr:`lanes` collects each differing
    lane's first differing field of each call; :attr:`calls` counts each
    kernel's launches (a repacked wave's tail is two); :attr:`other_flag`
    the tail's checks with the other radiance flag and their launches."""

    def __init__(self, keep: bool = False):
        self.lanes = []  # {"kernel", "call", "lane", "field", "ulps", "class"}
        self.calls = {k: 0 for k in KERNELS}
        self.max_abs = {k: 0.0 for k in KERNELS}
        self.pending = []  # the lanes pending at each commit call
        self.other_flag = {"checks": 0, "launches": 0}
        #: with ``keep``, each kernel's first call: kernel -> its arguments;
        #: and every commit call's
        self.keep, self.kept, self.commits = keep, {}, []
        self.last_finish = None  # an older package's last finish: (rays, t, hit, mode)

    def _compare(self, kernel: str, got, want, prefix: str = "") -> None:
        """Compare a call's results; ``prefix`` names a second check of the
        same call (its fields so prefixed), which counts no launch."""
        import torch
        from check_torch_shade import _fields, field_lanes

        call = self.calls[kernel]
        self.calls[kernel] += not prefix
        got, want = _fields(got, prefix), _fields(want, prefix)
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

        from vulkan_raytracer_tpu_torch.ops import trace, wave
        from vulkan_raytracer_tpu_torch.render import graphs

        saved = (wave.primary_rays, wave.alpha_commit, graphs._graphs_preferred,
                 trace.hit_finish, wave.wave_sum)
        rays, commit, _, finish, tail = saved

        def c_rays(*args):
            if self.keep and "primary_rays" not in self.kept:
                self.kept["primary_rays"] = args
            got = rays(*args)
            self._compare("primary_rays", got, wave.primary_rays_reference(*args))
            return got

        def c_commit(tables, st, raw, loop=None):
            before = {k: v.clone() for k, v in st.items()}
            raw = (tuple(c.clone() for c in raw[0]), raw[1].clone(), raw[2].clone(), raw[3])
            want = wave.alpha_pass_reference(tables, before, raw)
            if loop is None:
                loop = torch.zeros(4, dtype=torch.int64, device=raw[2].device)
            if self.keep:
                self.commits.append((tables, before, raw, want))
                self.kept.setdefault("alpha_commit", self.commits[0])
            self.pending.append(int(before["pending"].sum()))
            commit(tables, st, raw, loop)
            self._compare("alpha_commit", (st, loop[3].reshape(1)),
                          (want, want["pending"].sum().reshape(1)))

        def c_commit_finished(tables, st, t_c, tri_c, u_c, v_c, count=None):
            # an older package's commit, which took the finished hit: its
            # pass's raw hit is the last finish's arguments
            before = {k: v.clone() for k, v in st.items()}
            want = wave.alpha_commit_reference(tables, before, t_c, tri_c, u_c, v_c)
            if count is None:
                count = torch.zeros((), dtype=torch.int64, device=tri_c.device)
            if self.keep:
                self.commits.append((tables, before, self.last_finish, want))
                self.kept.setdefault("alpha_commit", self.commits[0])
            self.pending.append(int(before["pending"].sum()))
            commit(tables, st, t_c, tri_c, u_c, v_c, count)
            self._compare("alpha_commit", (st, count.reshape(1)),
                          (want, want["pending"].sum().reshape(1)))

        def c_sum(tables, s, repack, total, frame_rays, rays, k, radiance):
            from check_torch_trace import _clone

            args = (tables, _clone(s), repack, total.clone(), frame_rays.clone(), rays, k,
                    radiance)
            if self.keep and "wave_sum" not in self.kept:
                self.kept["wave_sum"] = args
            want_total, want_rays = _clone(args[3]), _clone(args[4])
            want = wave.wave_sum_reference(tables, s, repack, want_total, want_rays, rays, k,
                                           True)
            # the other flag's instance on the same inputs, into copies of the sums
            o_total, o_rays = total.clone(), frame_rays.clone()
            before = wave.LAUNCHES["wave_sum"]
            o_got = tail(tables, s, repack, o_total, o_rays, rays, k, not radiance)
            self.other_flag["launches"] += wave.LAUNCHES["wave_sum"] - before
            self.other_flag["checks"] += 1
            self._compare("wave_sum", (o_got, o_total, o_rays.reshape(1)),
                          (None if radiance else want, want_total, want_rays.reshape(1)),
                          prefix="other_flag")
            got = tail(tables, s, repack, total, frame_rays, rays, k, radiance)
            self._compare("wave_sum", (got, total, frame_rays.reshape(1)),
                          (want if radiance else None, want_total, want_rays.reshape(1)))
            self.calls["wave_sum"] += bool(repack)  # the scatter, then the sum
            return got

        def c_finish(tables, rays, t, hit, mode):
            self.last_finish = (tuple(c.clone() for c in rays), t.clone(), hit.clone(), mode)
            return finish(tables, rays, t, hit, mode)

        if not fused():
            c_commit = c_commit_finished  # noqa: F811
            trace.hit_finish = c_finish
        wave.primary_rays, wave.alpha_commit, wave.wave_sum = c_rays, c_commit, c_sum
        graphs._graphs_preferred = lambda tables: False
        try:
            yield self
        finally:
            (wave.primary_rays, wave.alpha_commit, graphs._graphs_preferred,
             trace.hit_finish, wave.wave_sum) = saved

    def summary(self) -> dict:
        def count(key):
            out = {}
            for lane in self.lanes:
                out[str(lane[key])] = out.get(str(lane[key]), 0) + 1
            return out

        return {"calls": dict(self.calls), "other_flag": dict(self.other_flag),
                "max_abs_err": dict(self.max_abs),
                "differing_lanes": len(self.lanes),
                "by_class": {c: sum(x["class"] == c for x in self.lanes) for c in ("i", "ii")},
                "by_kernel": count("kernel"), "by_field": count("field"),
                "pending_per_pass": {"first": self.pending[:1], "sum": sum(self.pending),
                                     "passes": len(self.pending)},
                "first": self.lanes[:FIRST]}


def configs(tmp: Path) -> dict:
    """name -> (build the scene's tables on a device, camera, width, height,
    spp, depth): ``tools/check_torch_shade.py``'s configs and the smoke's
    instanced alpha gallery, bench cfg4's gate crop (16x16, 2 spp, depth 3
    under its HDR sky), and :data:`SAMPLE_WAVES` (their config's, 1 spp)."""
    import chip_smoke
    from check_torch_shade import configs as shade_configs

    out = shade_configs(tmp)
    out["alpha_gallery"] = (
        lambda device: chip_smoke.alpha_gallery_scene().upload(device, instancing=True),
        chip_smoke.TEXTURED_CAM, 128, 128, 16, 4)
    build, cam = out["cfg4"][:2]
    out["cfg4_gate"] = (build, cam, 16, 16, 2, 3)
    for name, config in SAMPLE_WAVES.items():
        build, cam, width, height, _, depth = out[config]
        out[name] = (build, cam, width, height, 1, depth)
    return out


def fused() -> bool:
    """Does the imported package's alpha commit take the traversal's raw
    hit (and finish it itself)?  An older one took the finished hit."""
    import inspect

    from vulkan_raytracer_tpu_torch.ops import wave

    return "raw" in inspect.signature(wave.alpha_commit).parameters


def _commit_ms(tables, before, raw, reps: int = 20) -> float:
    """Device ms a pass's tail after its traversal, from its raw hit: the
    alpha commit with its control block (in an older package: the finish,
    then the commit with its count).  ``reps`` of them in one captured CUDA
    graph, each on its own copy of the pass's state and raw hit; before
    each timed replay every copy's state is restored and a buffer of
    ``check_torch_trace.COLD_BYTES`` written, so no pass finds its inputs in
    L2.  The mean of three replays."""
    import torch
    from check_torch_trace import COLD_BYTES

    dev = raw[2].device
    copies = [({k: v.clone() for k, v in before.items()},
               (tuple(c.clone() for c in raw[0]), raw[1].clone(), raw[2].clone(), raw[3]),
               torch.zeros(4, dtype=torch.int64, device=dev)) for _ in range(reps)]

    def restore():
        for st, *_ in copies:
            for k, v in st.items():
                v.copy_(before[k])

    graph = torch.cuda.CUDAGraph()
    restore()
    with torch.cuda.graph(graph):
        for st, r, loop in copies:
            _run_pass(tables, st, r, loop)
    flush = torch.empty(COLD_BYTES, dtype=torch.uint8, device=dev)
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


def _run_pass(tables, st, raw, loop) -> None:
    """A pass's tail on the card: the fused commit with the control block
    ``loop`` (four int64), or in an older package the finish and the commit,
    its count at ``loop[3]`` (where the fused commit leaves its own)."""
    from vulkan_raytracer_tpu_torch.ops import trace, wave

    if fused():
        wave.alpha_commit(tables, st, raw, loop)
    else:
        wave.alpha_commit(tables, st, *trace.hit_finish(tables, *raw), loop[3])


def _pass_reference(tables, before, raw) -> dict:
    """The plain version of a pass's tail (the finish, then the commit)."""
    from vulkan_raytracer_tpu_torch.ops import trace, wave

    return wave.alpha_commit_reference(tables, before, *trace.hit_finish_reference(tables, *raw))


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
        if "wave_sum" in kept:
            args = kept["wave_sum"]
            tables, s, repack, _, _, _, k, flag = args
            lanes = s["active"].shape[0]
            env = tables.skybox
            nbytes = wave.wave_sum_bytes(lanes // k, k, repack, env.h * env.w, flag)
            copies = _copies(args, nbytes + wave.wave_sum_scratch_bytes(lanes, repack))
            # the other flag's time and bytes beside the wave's own
            other = [(*c[:7], not flag) for c in copies]
            out["wave_sum"] = {
                "ms": _cold_ms(wave.wave_sum, copies, reps),
                "plain_ms": _plain_ms(wave.wave_sum_reference, copies, plain_reps),
                "bytes": nbytes, "scratch_bytes": wave.wave_sum_scratch_bytes(lanes, repack),
                "lanes": lanes, "samples": k, "repack": bool(repack), "radiance": bool(flag),
                "sky_texels": env.h * env.w,
                "other_flag_ms": _cold_ms(wave.wave_sum, other, reps),
                "other_flag_bytes": wave.wave_sum_bytes(lanes // k, k, repack, env.h * env.w,
                                                        not flag)}
        if "alpha_commit" in kept:
            tables, before, raw, want = kept["alpha_commit"]
            out["alpha_commit"] = {
                "ms": _commit_ms(tables, before, raw, reps),
                "plain_ms": _event_ms(lambda: _pass_reference(tables, before, raw), plain_reps),
                "bytes": commit_bytes(*kept["alpha_commit"]),
                "bytes_lanes_only": commit_bytes(*kept["alpha_commit"], rows=False),
                "lanes": raw[2].shape[0], "pending": int(before["pending"].sum())}
    for t in out.values():
        t.update(bound_ms=1e3 * t["bytes"] / HBM_BYTES_PER_S, bound_by="bytes")
        if "other_flag_bytes" in t:
            t["other_flag_bound_ms"] = 1e3 * t["other_flag_bytes"] / HBM_BYTES_PER_S
    return out


def commit_bytes(tables, before, raw, want, rows: bool = True) -> int:
    """The bytes a pass's tail must move, its BLEND candidates found from
    the tables: ``wave.alpha_commit_bytes`` with, where ``rows``, the
    finish's table rows of the pending lanes' hits
    (``trace.finish_table_bytes``); in an older package the finish over
    every lane (``trace.hit_finish_bytes``) and the commit's bytes."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import trace, wave

    rays, t, hit, mode = raw
    _, tri_c, _, _ = trace.hit_finish_reference(tables, *raw)
    ti = torch.clamp_min(tri_c, 0)
    if tables.inst is not None:
        ti, _ = tables.inst.decode(ti)
    blend = before["pending"] & (tri_c >= 0) & (tables.alpha.mode[ti] == 2)
    if not fused():
        return trace.hit_finish_bytes(hit) + wave.alpha_commit_bytes(before, tri_c, want, blend)
    pend = hit[before["pending"]]
    table = trace.finish_table_bytes(tables, pend, mode) if rows else 0
    return wave.alpha_commit_bytes(before, hit, want, blend, table)


def pass_table(commits: list) -> dict:
    """Every alpha pass of a wave timed cold (:func:`_commit_ms`), in µs,
    with its pending lanes and bytes bound; the sums and the time above the
    bounds."""
    import torch
    from chip_smoke import HBM_BYTES_PER_S

    rows = []
    with torch.inference_mode():
        for k, call in enumerate(commits):
            bound = 1e6 * commit_bytes(*call) / HBM_BYTES_PER_S
            rows.append({"pass": k, "pending": int(call[1]["pending"].sum()),
                         "us": 1e3 * _commit_ms(*call[:3]), "bound_us": bound})
    us, bound = sum(r["us"] for r in rows), sum(r["bound_us"] for r in rows)
    return {"passes": rows, "us_sum": us, "bound_us_sum": bound, "lost_us": us - bound}


def check_config(name: str, spec, device, tables=None, timing: bool = False,
                 sample: bool = False) -> dict:
    """Render ``spec``'s first wave under :class:`Compare` (with ``sample``
    one sample of the whole frame as ``render_sample`` runs it); one
    JSON-able line.  ``tables`` may be given to skip the build; with
    ``timing`` (a card), each kernel's first call is timed
    (:func:`time_kept`)."""
    import numpy as np
    import torch
    from profile_torch_wave import first_wave, wave

    from vulkan_raytracer_tpu_torch.ops import wave as wave_ops
    from vulkan_raytracer_tpu_torch.render import graphs, integrator, renderer
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    build, cam, width, height, spp, depth = spec
    if tables is None:
        tables = build(device)
    camera = Camera(position=np.array(cam[0]), direction=np.array(cam[1]), aspect=width / height)
    if sample:
        n = width * height

        def run():
            with torch.inference_mode():
                return integrator.render_sample(tables, *renderer.camera_uniforms(camera),
                                                width, height, 1, depth)
    else:
        lanes, samples, _ = first_wave(tables, width, height, spp)
        n = len(lanes) * len(samples)
        run = wave(tables, camera, width, height, depth, lanes, samples)
    graphs.settle()
    before = dict(wave_ops.LAUNCHES)
    t0 = time.perf_counter()
    with Compare(keep=timing).on() as cmp:
        radiance, rays = run()
    launched = {k: wave_ops.LAUNCHES.get(k, 0) - before.get(k, 0) for k in KERNELS}
    launched["wave_sum"] -= cmp.other_flag["launches"]
    if device.type == "cuda" and launched != cmp.calls:
        raise AssertionError(f"{name}: {cmp.calls} wave kernel calls, but {launched} launches")
    line = {"config": name, "lanes": n, "launches": launched,
            "alpha": bool(tables.has_alpha), "rays": int(rays),
            "finite": bool(torch.isfinite(radiance).all()),
            "seconds": time.perf_counter() - t0, **cmp.summary()}
    if timing:
        line["timing"] = time_kept(cmp.kept)
        if cmp.commits:
            line["alpha_passes"] = pass_table(cmp.commits)
    return line


def synthetic_pass(tables, n: int, share, seed: int):
    """One alpha pass's inputs over ``tables``, made from ``seed``: the loop's
    state (``share`` of the lanes pending; None: one lane) and the
    traversal's raw result, (rays, t, hit, mode) (15% missed, the rest any
    triangle, BVH slot or encoded id of the tables' mode; rays from points
    in [-1, 1]^3 in random directions)."""
    import torch

    dev = tables.device
    g = torch.Generator(device=dev).manual_seed(seed)
    if tables.inst is not None:
        mode, ids = "instanced", tables.inst.num_proto_tris * tables.inst.num_instances
    elif tables.pbvh is not None:
        mode, ids = "bvh", tables.pbvh.tri_id.shape[0]
    else:
        mode, ids = "dense", tables.num_triangles

    def rand():
        return torch.rand(n, generator=g, device=dev)

    hit = torch.where(rand() < 0.15, -1, torch.randint(0, ids, (n,), generator=g, device=dev,
                                                       dtype=torch.int32)).int()
    t = torch.where(hit >= 0, rand() * 4, torch.inf)
    d = torch.randn((3, n), generator=g, device=dev)
    d = d / d.norm(dim=0)
    rays = tuple(c.contiguous() for c in (*(rand() * 2 - 1 for _ in range(3)), *d))
    if share is None:
        pending = torch.zeros(n, dtype=torch.bool, device=dev)
        pending[n // 2] = True
    else:
        pending = rand() < share
    st = dict(t_lo=rand(), pending=pending, t=torch.full((n,), torch.inf, device=dev),
              tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
              u=torch.zeros(n, device=dev), v=torch.zeros(n, device=dev),
              seed=torch.randint(0, 2**32, (n,), generator=g, device=dev))
    return st, (rays, t, hit, mode)


def synthetic(device, timing: bool = False) -> dict:
    """The alpha commit against its plain version (the finish, then the
    commit) on synthetic passes (:func:`synthetic_pass`) at
    :data:`PENDING_SHARES` and :data:`SYNTHETIC_LANES` over the smoke's
    alpha gallery (a MASK texture and a BLEND row) uploaded instanced and
    flattened and its untextured twin: the state written over the loop's
    buffers and the count of pending lanes it leaves in its control block
    bit-equal, else the case is listed.  With ``timing`` (a card) each
    share at the largest count is timed cold over the instanced gallery
    (:func:`_commit_ms`)."""
    import chip_smoke
    import torch

    from vulkan_raytracer_tpu_torch.ops import wave

    scenes = {"instanced": chip_smoke.alpha_gallery_scene().upload(device, instancing=True),
              "flattened": chip_smoke.alpha_gallery_scene().upload(device, instancing=False),
              "untextured": chip_smoke.alpha_gallery_scene(textured=False).upload(
                  device, instancing=True)}
    differing, checked, launches = [], 0, wave.LAUNCHES["alpha_commit"]
    for name, tables in scenes.items():
        for n in SYNTHETIC_LANES[:-1]:
            for s, share in enumerate(PENDING_SHARES):
                st, raw = synthetic_pass(tables, n, share, seed=n + s)
                want = _pass_reference(tables, st, raw)
                loop = torch.zeros(4, dtype=torch.int64, device=device)
                loop[3] = 99
                _run_pass(tables, st, raw, loop)
                checked += 1
                fields = [k for k in want if not torch.equal(st[k], want[k])]
                got = int(loop[3])
                if fields or got != int(want["pending"].sum()) or int(loop[0]):
                    differing.append({"scene": name, "lanes": n, "share": share,
                                      "fields": fields, "count": got, "word": int(loop[0])})
    out = {"checked": checked, "differing": differing,
           "launches": wave.LAUNCHES["alpha_commit"] - launches}
    if timing:
        from chip_smoke import HBM_BYTES_PER_S

        n, tables = SYNTHETIC_LANES[-1], scenes["instanced"]
        rows = []
        with torch.inference_mode():
            for s, share in enumerate(PENDING_SHARES):
                st, raw = synthetic_pass(tables, n, share, seed=s)
                want = _pass_reference(tables, st, raw)
                rows.append({"share": share, "pending": int(st["pending"].sum()),
                             "us": 1e3 * _commit_ms(tables, st, raw),
                             "bound_us": 1e6 * commit_bytes(tables, st, raw, want)
                             / HBM_BYTES_PER_S})
        out["timing"] = {"lanes": n, "scene": "instanced", "by_share": rows}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=",".join(CONFIGS))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--allow-class-i", action="store_true")
    p.add_argument("--timing", action="store_true",
                   help="time each kernel's first call against its plain version, and every "
                        "alpha pass of each wave (a card)")
    p.add_argument("--synthetic", action="store_true",
                   help="hold the alpha commit on synthetic passes (timed with --timing)")
    p.add_argument("--root", default=str(ROOT), help="the checkout whose package is checked")
    p.add_argument("--out", help="write every line here as well")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "tools"))
    from check_torch_trace import _import_root

    _import_root(args.root)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("check_torch_wave.py: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    bad = False
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        specs = configs(Path(tmp))
        for name in filter(None, args.configs.split(",")):
            line = {"root": args.root, **check_config(name, specs[name], device,
                                                      timing=args.timing,
                                                      sample=name in SAMPLE_WAVES)}
            lines.append(line)
            print(json.dumps(line), flush=True)
            bad |= bool(line["by_class"]["ii"] or (line["by_class"]["i"]
                                                   and not args.allow_class_i))
            bad |= not line["finite"]
    if args.synthetic:
        line = {"root": args.root, "synthetic": synthetic(device, timing=args.timing)}
        lines.append(line)
        print(json.dumps(line), flush=True)
        bad |= bool(line["synthetic"]["differing"])
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
