#!/usr/bin/env python3
"""Which lanes make a render on the card differ from the same render on the
CPU, and why.

    python3 tools/torch_lane_diff.py [--scene cornell|gallery|gltf147k|cfg4|soup|all]
        [--device cuda|cpu] [--out FILE.json]
    python3 tools/torch_lane_diff.py --uploads [--device cuda|cpu]

Run from the root of a checkout.  ``--device cuda`` (the default) needs an
NVIDIA card and fails without one; ``--device cpu`` renders both sides on the
CPU, a self-test that must find no differing lane.  The scenes are those whose
card-vs-CPU RMSE ``chip_smoke.py`` reports: the built-in Cornell box,
``chip_smoke.gallery_scene()`` (instanced), the 147,136-triangle
``bigasset.glb`` of ``tools/torch_glb_assets.py``, the bench's cfg4 hall under
its HDR sky at its gate crop (16x16, 2 spp, depth 3), and the emitter soup of
``chip_smoke.emitter_soup_scene(100000, 5000, seed=31)``; the others at 32x32,
2 spp, depth 3.

For a scene, :func:`diagnose`:

1. renders the frame with ``render_image`` on the scene's device and on
   ``tables.to("cpu")`` (the plain versions of every kernel), keeping each
   lane's radiance (a lane is one (pixel, sample)), and lists the pixels whose
   linear value differs by more than 1e-6 in any channel;
2. renders only those pixels again on both devices with ``integrator._bounce``,
   ``shade.shade_hit`` and ``wave.wave_sum`` wrapped (the module's
   attributes, restored afterwards), keeping every lane's state at each
   bounce (``origin``, ``direction``, ``throughput``, ``value``, ``seed``,
   ``active``, ``mat_pdf``, ``wavelength``, ``sky_w``), the hit's ``tri`` and
   ``t``, the state after the loop and the radiance; a repacked wave's lanes
   are mapped back through ``s["slot"]``.  Self-check: each lane's radiance
   must be the one it had in the whole frame, bit for bit, on each device;
3. finds each differing lane's first difference: the first bounce, then the
   first field in the order above (the hit after the state it was traced
   from), and its distance in ulps; and, on a card, names the aten op it
   comes from (:func:`attribute`): the step that produced the field is run
   again for that lane alone on both devices, every aten op of the card's run
   is recomputed on the CPU from the same inputs, and the op whose CPU result,
   put in place of the card's, makes the field come out as on the CPU is the
   one named.  A shading kernel of ``ops/shade.py`` is opened up there: its
   plain version, bit-equal to it on the card, runs in its place on the
   card, so the aten op inside it is named; where the kernel differs from
   its plain version, the kernel itself (``shade_scatter_kernel``, ...) is.

A lane is class ``i`` (a last-ulp flip) when its first difference is in a
float field and is at most 4 ulps: on a card, at the output of the op named
(the step's arithmetic after the op may widen it before the field is
recorded: a 1-ulp ``rsqrt`` has shown as 24 ulps of a direction), elsewhere
in the field.  It is class ``ii`` (a fault) when the difference is larger,
in an integer or a flag (a seed, an ``active`` flag, a hit id from equal ray
inputs), a NaN or inf on one side, when the lane's result depends on the
wave it ran in, or when no op explains it.  The report gives each lane's
pixel, sample, first bounce, field, ulps, op, the hit ids on both sides from
that bounce on, the pixel's error and its share of the frame's squared
error, then the lanes by class, by first bounce, by field and by op.  The tool leaves the package's launch counters and
statistics as it found them.  It imports neither jax nor the JAX package.

``--uploads`` holds two uploads of one scene on one device against each
other instead, the 4-dragon gallery instanced and flattened: first
``chip_smoke.py``'s ``instanced_vs_flattened`` check (:func:`check_uploads`:
the bounce-0 first hits lane by lane, :func:`hits_agree`, and the 128x128
32 spp image against the 2e-3 bar; the exit code is 1 where it fails), then
(:func:`compare_uploads`) the 2 spp frame that check used to be, with each
differing lane's first difference (hit ids left out).  ``--wrong-transform
DX`` moves the first dragon of the instanced upload, a fault the check must
catch (the 2 spp frame is left as it is).
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
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

ROOT = Path(__file__).resolve().parent.parent

#: a pixel differs when a channel of its linear value differs by more than this
PIXEL_TOL = 1e-6
#: the largest first difference, in ulps of a float field, of a last-ulp flip
FLIP_ULPS = 4
#: the wave state compared at each bounce, in this order
STATE_FIELDS = ("origin", "direction", "throughput", "value", "seed", "active", "mat_pdf",
                "wavelength", "sky_w")
HIT_FIELDS = ("tri", "t")
#: integer and flag fields: any difference is a fault
EXACT_FIELDS = {"seed", "active", "tri", "preview", "slot"}
#: aten ops whose results are uninitialised memory or host scalars
_UNCHECKED = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
              "_local_scalar_dense", "resize_", "set_"}

#: the instanced-vs-flattened check (:func:`check_uploads`): its frame
#: (size, spp, depth), the bar of its image, the ulps its first hits' t may
#: differ by (163 measured on the CPU at this frame), the barycentric margin
#: of a crack and the share of lanes that may be cracks (2 of 524,288 measured)
UPLOADS_FRAME = (128, 32, 3)
RMSE_BAR = 2e-3
HIT_T_ULPS = 512
EDGE_MARGIN = 1e-3
MAX_CRACK_SHARE = 1e-4

#: scene -> (size, spp, depth); the smoke's parity frames, cfg4 at its gate crop
FRAMES = {"cornell": (32, 2, 3), "gallery": (32, 2, 3), "gltf147k": (32, 2, 3),
          "cfg4": (16, 2, 3), "soup": (32, 2, 3)}


def _np(v):
    """A V3 as an (N, 3) numpy array, a tensor as a numpy array."""
    from vulkan_raytracer_tpu_torch.ops.math3 import V3

    if isinstance(v, V3):
        return np.stack([c.detach().cpu().numpy() for c in v], axis=-1)
    return v.detach().cpu().numpy()


def _lane_keys(lanes, first: int, k: int) -> np.ndarray:
    """(n * k, 2) int64 (pixel, sample) of a wave's lanes, samples-major, as
    ``integrator.Waves.run`` lays them out for the pixel ``lanes`` at
    samples ``first`` .. ``first + k - 1``."""
    pix = np.asarray(lanes.cpu(), np.int64)
    return np.stack([np.tile(pix, k), np.repeat(np.arange(first, first + k), pix.shape[0])],
                    axis=1)


class Record:
    """Lanes of the waves rendered while :meth:`on` is active.  ``radiance``
    maps (pixel, sample) to its (3,) radiance; with ``bounces``, ``steps`` maps
    it to {bounce: {"state": {...}, "hit": {...}}} and ``final`` to the state
    after the loop (every field as a numpy value)."""

    def __init__(self, bounces: bool):
        self.bounces = bounces
        self.radiance, self.steps, self.final = {}, {}, {}
        self._keys = None
        self._hit = None

    def _lanes(self, s: dict) -> list:
        n = s["active"].shape[0]
        pos = s["slot"].cpu().numpy() if "slot" in s else np.arange(n)
        return [tuple(k) for k in self._keys[pos].tolist()]

    def _state(self, s: dict) -> dict:
        return {k: _np(v) for k, v in s.items()}

    @contextlib.contextmanager
    def on(self):
        """Record the renders inside; with ``bounces`` they run eagerly
        (``graphs._graphs_preferred`` patched off): a replayed graph runs no
        Python, so its bounces could not be recorded."""
        from vulkan_raytracer_tpu_torch.ops import shade, wave
        from vulkan_raytracer_tpu_torch.render import graphs, integrator

        saved = (integrator.Waves.run, integrator._bounce, shade.shade_hit,
                 wave.wave_sum, graphs._graphs_preferred)
        run, bounce, shade_hit, wave_sum, _ = saved

        def rec_run(waves, first, k, pixel_order=False, radiance=False):
            self._keys = _lane_keys(waves.lanes, first, k)
            # the waves' radiance, which a frame's own waves do not ask for
            out, rays = run(waves, first, k, pixel_order=pixel_order, radiance=True)
            # in pixel order (one sample of a whole frame) row j is pixel j
            rows = (np.stack([np.arange(len(self._keys)), self._keys[:, 1]], axis=1)
                    if pixel_order else self._keys)
            for key, row in zip(map(tuple, rows.tolist()), _np(out)):
                self.radiance[key] = row
            return (out if radiance else None), rays

        def rec_bounce(tables, s, b, *args):
            lanes = self._lanes(s)
            state = self._state(s)
            out = bounce(tables, s, b, *args)
            hit = self._hit
            for i, key in enumerate(lanes):
                self.steps.setdefault(key, {})[b] = {
                    "state": {k: v[i] for k, v in state.items()},
                    "hit": {k: v[i] for k, v in hit.items()}}
            return out

        def rec_shade_hit(tables, s, b, max_depth, t, tri, u, v):
            self._hit = {"tri": _np(tri), "t": _np(t)}
            return shade_hit(tables, s, b, max_depth, t, tri, u, v)

        def rec_wave_sum(tables, s, *args):
            lanes, state = self._lanes(s), self._state(s)
            for i, key in enumerate(lanes):
                self.final[key] = {k: v[i] for k, v in state.items()}
            return wave_sum(tables, s, *args)

        integrator.Waves.run = rec_run
        if self.bounces:
            integrator._bounce, shade.shade_hit = rec_bounce, rec_shade_hit
            wave.wave_sum = rec_wave_sum
            graphs._graphs_preferred = lambda tables: False
        try:
            yield self
        finally:
            (integrator.Waves.run, integrator._bounce, shade.shade_hit,
             wave.wave_sum, graphs._graphs_preferred) = saved


@contextlib.contextmanager
def counters_kept():
    """Leave the kernels' launch counters, the instance steps, the alpha
    loop's counter and the bounce widths as they were."""
    from vulkan_raytracer_tpu_torch.render import integrator

    kept = [(d, dict(d)) for d in integrator._COUNTERS]
    try:
        yield
    finally:
        for d, was in kept:
            d.clear()
            d.update(was)


def _camera(cam, width: int, height: int):
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    c = Camera(position=np.array(cam[0], np.float64), direction=np.array(cam[1], np.float64))
    c.aspect = width / height
    return c


def render_frame(tables, cam, width: int, height: int, spp: int, depth: int):
    """``render_image`` (linear, start sample 1) with each lane's radiance
    kept; returns (image (H, W, 3), rays, {(pixel, sample): radiance})."""
    from vulkan_raytracer_tpu_torch.render.renderer import render_image

    rec = Record(bounces=False)
    with rec.on():
        img, rays = render_image(tables, _camera(cam, width, height), width, height, spp=spp,
                                 max_depth=depth, tonemap=False)
    return img, rays, rec.radiance


def record_lanes(tables, cam, width: int, height: int, spp: int, depth: int, pixels) -> Record:
    """Samples 1..spp of ``pixels`` (flat indices) rendered again in one wave
    through ``renderer._render_wave``, every bounce of every lane kept."""
    from vulkan_raytracer_tpu_torch.render import renderer

    view_inv, proj_inv = renderer.camera_uniforms(_camera(cam, width, height))
    rec = Record(bounces=True)
    lanes = torch.as_tensor(np.asarray(pixels, np.int64), device=tables.device)
    with rec.on(), torch.inference_mode():
        renderer._render_wave(tables, view_inv, proj_inv, width, height, depth,
                              list(range(1, spp + 1)), lanes, "reference")
    return rec


def self_check(frame: dict, rec: Record) -> list:
    """Lanes whose radiance in ``rec`` is not the one they had in the whole
    frame, bit for bit."""
    return sorted(k for k, v in rec.radiance.items()
                  if not np.array_equal(np.asarray(v).view(np.int32),
                                        np.asarray(frame[k]).view(np.int32)))


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 bits as integers in the order of the floats (+0 and -0 both 0)."""
    bits = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(bits < 0, -(2**31) - bits, bits)


def field_difference(name: str, a, b):
    """None where ``a`` and ``b`` are equal bit for bit, else {"kind": "exact"
    | "nonfinite" | "float", "ulps": the largest distance (float only)}."""
    a, b = np.asarray(a), np.asarray(b)
    if name in EXACT_FIELDS or a.dtype.kind in "biu":
        return None if np.array_equal(a, b) else {"kind": "exact", "ulps": None}
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    if np.array_equal(a32.view(np.int32), b32.view(np.int32)):
        return None
    if not np.array_equal(np.isfinite(a32), np.isfinite(b32)) or not (
            np.isfinite(a32).all() or np.array_equal(np.isnan(a32), np.isnan(b32))):
        return {"kind": "nonfinite", "ulps": None}
    fin = np.isfinite(a32) & np.isfinite(b32)
    ulps = int(np.abs(_ordered(a32[fin]) - _ordered(b32[fin])).max()) if fin.any() else 0
    return {"kind": "float", "ulps": ulps}


def _state_at(rec: Record, key, b):
    """A lane's state entering bounce ``b``: a lane not in that bounce's wave
    was dead and already final (the width ladder's tail)."""
    step = rec.steps.get(key, {}).get(b)
    return step["state"] if step is not None else rec.final[key]


def first_difference(ra: Record, rb: Record, key, hit_fields=HIT_FIELDS):
    """The first field of lane ``key`` that differs between the two records:
    {"bounce": b or "end", "field", "kind", "ulps"}, or None."""
    steps = sorted(set(ra.steps.get(key, {})) | set(rb.steps.get(key, {})))
    for b in steps:
        sa, sb = _state_at(ra, key, b), _state_at(rb, key, b)
        for f in STATE_FIELDS:
            d = field_difference(f, sa[f], sb[f])
            if d:
                return {"bounce": b, "field": f, **d}
        ha, hb = ra.steps.get(key, {}).get(b), rb.steps.get(key, {}).get(b)
        if ha is not None and hb is not None and sa["active"] and sb["active"]:
            for f in hit_fields:
                d = field_difference(f, ha["hit"][f], hb["hit"][f])
                if d:
                    return {"bounce": b, "field": f, **d}
    for f in STATE_FIELDS:
        d = field_difference(f, ra.final[key][f], rb.final[key][f])
        if d:
            return {"bounce": "end", "field": f, **d}
    d = field_difference("radiance", ra.radiance[key], rb.radiance[key])
    return {"bounce": "end", "field": "radiance", **d} if d else None


def classify(diff: dict, op=None, attributed: bool = False, op_ulps=None) -> str:
    """``i`` for a last-ulp flip, else ``ii``.  The first difference must be
    in a float field.  Where an op was looked for, one must have been named,
    and the difference is measured at its output (``op_ulps``): the step's
    arithmetic after it may widen a flip of its result before the field is
    recorded.  Elsewhere it is the field's: at most FLIP_ULPS either way."""
    if diff["kind"] != "float":
        return "ii"
    if attributed:
        return "i" if op is not None and op_ulps <= FLIP_ULPS else "ii"
    return "i" if diff["ulps"] <= FLIP_ULPS else "ii"


def _hits_from(ra: Record, rb: Record, key, b) -> list:
    """[bounce, tri on side a, tri on side b] from bounce ``b`` on."""
    start = 0 if b == "end" else b
    steps = sorted(set(ra.steps.get(key, {})) | set(rb.steps.get(key, {})))
    out = []
    for s in steps:
        if s < start:
            continue
        ta, tb = (r.steps.get(key, {}).get(s) for r in (ra, rb))
        out.append([s, None if ta is None else int(ta["hit"]["tri"]),
                    None if tb is None else int(tb["hit"]["tri"])])
    return out


# ---------------------------------------------------------------------------
# Naming the op: one lane's step again, each aten op held against the CPU
# ---------------------------------------------------------------------------


#: The shading kernels counted as ops (ops/shade.py): wrapper -> plain version
_KERNEL_OPS = {"shade_hit": "shade_hit_reference", "shade_scatter": "shade_scatter_reference",
               "shade_resolve": "shade_resolve_reference"}


def _map_tree(x, fn):
    """``x`` (dataclasses, V3s, tuples, dicts) with each tensor ``t`` replaced
    by ``fn(t)``."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map_tree(getattr(x, f.name), fn)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _map_tree(v, fn) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_map_tree(v, fn) for v in x)) if hasattr(x, "_fields") else tuple(
            _map_tree(v, fn) for v in x)
    return x


def _tensors_of(x) -> list:
    out = []
    _map_tree(x, out.append)
    return out


class AgainstCPU(TorchDispatchMode):
    """A dispatch mode over a run on the card: with ``check``, every aten op
    with a floating result is computed again on the CPU from copies of the
    same inputs, and the ops whose results differ are kept in ``differ`` (op
    name -> largest ulps, in order of first appearance); ops named in
    ``substitute`` hand on the CPU's result in place of the card's.  Given
    ``cpu_tables`` (the scene on the CPU), a shading kernel's call is opened
    up: its plain version, bit-equal to it on the card, runs in its place
    under the mode (:meth:`_kernel_op`)."""

    def __init__(self, check: bool, substitute=(), cpu_tables=None):
        super().__init__()
        self.check, self.substitute = check, frozenset(substitute)
        self.cpu_tables = cpu_tables
        self.differ = {}
        self._cache = {}  # CPU copies of large inputs (the scene's tables)
        self._saved = {}

    def __enter__(self):
        if self.cpu_tables is not None:
            from vulkan_raytracer_tpu_torch.ops import shade

            self._saved = {name: getattr(shade, name) for name in _KERNEL_OPS}
            for name, ref in _KERNEL_OPS.items():
                setattr(shade, name, self._kernel_op(name, self._saved[name], getattr(shade, ref)))
        return super().__enter__()

    def __exit__(self, *exc):
        from vulkan_raytracer_tpu_torch.ops import shade

        for name, fn in self._saved.items():
            setattr(shade, name, fn)
        self._saved = {}
        return super().__exit__(*exc)

    def _kernel_op(self, name: str, fn, ref):
        """The wrapper ``fn`` of a shading kernel on the card, as ops: the
        kernel runs and, on the same inputs, its plain version ``ref`` runs
        on the card under this mode, so that each of its aten ops is checked
        against (or replaced by) the CPU's as any other; its result goes on.
        Where the kernel differs from its plain version on the card, the
        kernel is the op (``shade_scatter_kernel``, ...), its ulps the
        largest of its results; substituted, its plain version runs on the
        CPU from copies of its inputs."""
        from torch.utils._python_dispatch import _disable_current_modes

        op = f"{name}_kernel"

        def call(tables, *args):
            if tables.device.type != "cuda":
                return fn(tables, *args)
            if op in self.substitute:
                with _disable_current_modes():
                    cargs = _map_tree(args, lambda t: t.detach().cpu().clone())
                    want = ref(self.cpu_tables, *cargs)
                    if name == "shade_resolve":  # it adds its rays into its last argument
                        args[-1].copy_(cargs[-1])
                    return _map_tree(want, lambda t: t.to(tables.device))
            with _disable_current_modes():
                kargs = (*args[:-1], args[-1].clone()) if name == "shade_resolve" else args
                got = fn(tables, *kargs)
            out = ref(tables, *args)
            with _disable_current_modes():
                worst = None
                for o, r in zip(_tensors_of((got, kargs[-1])), _tensors_of((out, args[-1]))):
                    o, r = o.detach().cpu(), r.detach().cpu()
                    if o.is_floating_point():
                        d = field_difference(op, o.numpy(), r.numpy())
                        if d:
                            worst = max(worst or 0, 2**31 if d["ulps"] is None else d["ulps"])
                    elif not torch.equal(o, r):
                        worst = 2**31
                if worst is not None:
                    self.differ[op] = max(self.differ.get(op, 0), worst)
            return out

        return call

    @staticmethod
    def _on_card(x) -> bool:
        return isinstance(x, torch.Tensor) and x.device.type == "cuda"

    @staticmethod
    def _reference(func, args, kwargs):
        """The op on the CPU."""
        return func(*args, **kwargs)

    def _to_cpu(self, x):
        if isinstance(x, torch.device):
            return torch.device("cpu")
        if not isinstance(x, torch.Tensor):
            return x
        if x.device.type == "cpu" or x.numel() < 4096:
            return x.to("cpu", copy=True)
        key = (x.untyped_storage().data_ptr(), x.storage_offset(), tuple(x.shape), x.stride(),
               x.dtype, x._version)
        if key not in self._cache:
            self._cache[key] = (x, x.cpu())  # x kept, so its storage is not reused
        return self._cache[key][1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        on_card = any(self._on_card(x) for x in tree_flatten((args, kwargs))[0])
        want = on_card and name not in _UNCHECKED and (self.check or name in self.substitute)
        if want:
            cargs, ckwargs = tree_map(self._to_cpu, (args, kwargs))
        out = func(*args, **kwargs)
        if not want:
            return out
        ref = self._reference(func, cargs, ckwargs)
        outs, refs = tree_flatten(out)[0], tree_flatten(ref)[0]
        worst = None
        for o, r in zip(outs, refs):
            if isinstance(o, torch.Tensor) and o.is_floating_point():
                d = field_difference(name, o.detach().cpu().numpy(), r.numpy())
                if d:
                    worst = max(worst or 0, 2**31 if d["ulps"] is None else d["ulps"])
        if worst is None:
            return out
        self.differ[name] = max(self.differ.get(name, 0), worst)
        if name not in self.substitute:
            return out
        if func._schema.is_mutable:
            for o, r in zip(outs, refs):
                if isinstance(o, torch.Tensor):
                    o.copy_(r)
            return out
        dev = next(o.device for o in outs if isinstance(o, torch.Tensor))
        return tree_map(lambda r: r.to(dev) if isinstance(r, torch.Tensor) else r, ref)


def _lane_state(state: dict, device) -> dict:
    """One lane's recorded state as a one-lane wave state on ``device``."""
    from vulkan_raytracer_tpu_torch.ops.math3 import V3

    out = {}
    for k, v in state.items():
        a = np.asarray(v)
        if a.ndim == 1:  # a V3 field: (3,) per lane
            out[k] = V3(*(torch.as_tensor(a[i:i + 1].copy(), device=device) for i in range(3)))
        else:
            out[k] = torch.as_tensor(a.reshape(1).copy(), device=device)
    if "slot" in out:
        out["slot"] = torch.zeros(1, dtype=torch.int64, device=device)
    return out


def _step_runner(rec: Record, key, diff, frame_args):
    """A function that runs again, for lane ``key`` alone on the given
    tables, the step whose result first differed, and returns that result's
    field ``diff["field"]`` as numpy; and the value ``rec`` holds for it."""
    from vulkan_raytracer_tpu_torch.ops import shade, wave
    from vulkan_raytracer_tpu_torch.render import integrator, renderer

    cam, width, height, depth = frame_args
    field, b = diff["field"], diff["bounce"]
    steps = sorted(rec.steps[key])
    if field == "radiance":
        final = rec.final[key]

        def run(tables):
            return _np(wave.radiance_reference(tables, _lane_state(final, tables.device)))[0]

        return run, rec.radiance[key]
    if field in HIT_FIELDS:
        state = rec.steps[key][b]["state"]
        want = rec.steps[key][b]["hit"][field]
        bounce = b
    elif b == 0:
        view_inv, proj_inv = renderer.camera_uniforms(_camera(cam, width, height))

        def run(tables):
            o, d, seed = integrator.generate_primary_rays(
                view_inv, proj_inv, width, height, int(key[1]),
                torch.tensor([key[0]], device=tables.device), device=tables.device)
            return _np({"origin": o, "direction": d, "seed": seed}[field])[0]

        return run, _state_at(rec, key, 0)[field]
    else:
        bounce = max(s for s in steps if b == "end" or s < b)
        state = rec.steps[key][bounce]["state"]
        want = _state_at(rec, key, b)[field] if b != "end" else rec.final[key][field]

    def run(tables):
        hit = {}
        shade_hit = shade.shade_hit

        def keep(tables_, s, b_, max_depth, t, tri, u, v):
            hit.update(tri=_np(tri)[0], t=_np(t)[0])
            return shade_hit(tables_, s, b_, max_depth, t, tri, u, v)

        shade.shade_hit = keep
        try:
            out, _ = integrator._bounce(tables, _lane_state(state, tables.device), bounce,
                                        depth, "reference")
        finally:
            shade.shade_hit = shade_hit
        return hit[field] if field in HIT_FIELDS else _np(out[field])[0]

    return run, want


def attribute(tables, cpu_tables, rec_dev: Record, rec_cpu: Record, key, diff,
              frame_args) -> dict:
    """Name the aten op behind lane ``key``'s first difference ``diff`` (see
    the module docstring).  Returns {"op": a name, names joined by "+", or
    None, "op_ulps": the largest difference of its results, "ops_differing":
    {op: ulps}, "wave_dependent": bool}: the step run alone must give each
    device's recorded value, else the lane depends on its wave."""
    run, want = _step_runner(rec_cpu, key, diff, frame_args)
    want_dev = _step_runner(rec_dev, key, diff, frame_args)[1]
    field = diff["field"]
    with torch.inference_mode():
        if (field_difference(field, run(cpu_tables), want) is not None
                or field_difference(field, run(tables), want_dev) is not None):
            return {"op": None, "op_ulps": None, "ops_differing": {}, "wave_dependent": True}
        with AgainstCPU(check=True, cpu_tables=cpu_tables) as mode:
            run(tables)
        differ = dict(mode.differ)
        op = None
        op_ulps = None
        for names in [[n] for n in differ] + ([list(differ)] if len(differ) > 1 else []):
            with AgainstCPU(check=False, substitute=names, cpu_tables=cpu_tables):
                if field_difference(field, run(tables), want) is None:
                    op, op_ulps = "+".join(names), max(differ[n] for n in names)
                    break
    return {"op": op, "op_ulps": op_ulps, "ops_differing": differ, "wave_dependent": False}


# ---------------------------------------------------------------------------
# The diagnosis of one frame
# ---------------------------------------------------------------------------


def compare(rec_a: Record, rec_b: Record, hit_fields=HIT_FIELDS) -> dict:
    """{lane: first difference} of every lane the two records share that
    differs anywhere."""
    out = {}
    for key in sorted(set(rec_a.radiance) & set(rec_b.radiance)):
        d = first_difference(rec_a, rec_b, key, hit_fields)
        if d:
            out[key] = d
    return out


def summarise(lanes: list) -> dict:
    """Lanes counted by class, first bounce, field and op."""
    def count(f):
        out = {}
        for lane in lanes:
            k = str(f(lane))
            out[k] = out.get(k, 0) + 1
        return out

    return {"by_class": {"i": sum(x.get("class") == "i" for x in lanes),
                         "ii": sum(x.get("class") == "ii" for x in lanes)},
            "by_first_bounce": count(lambda x: x["bounce"]),
            "by_field": count(lambda x: x["field"]), "by_op": count(lambda x: x.get("op"))}


def diagnose(tables, cam, width: int, height: int, spp: int, depth: int) -> dict:
    """The frame on ``tables.device`` against ``tables.to("cpu")``: images,
    rays, RMSE, the differing pixels and lanes, each lane's first difference,
    class and (on a card) op.
    ``void`` is true where the self-check failed on either device.  The
    frames' kernel launches are counted as any render's; those of the
    re-renders and the replays are not."""
    cpu_tables = tables.to("cpu")
    on_card = tables.device.type == "cuda"
    img_a, rays_a, frame_a = render_frame(tables, cam, width, height, spp, depth)
    img_b, rays_b, frame_b = render_frame(cpu_tables, cam, width, height, spp, depth)
    err = (img_a.astype(np.float64) - img_b.astype(np.float64)).reshape(-1, 3)
    sq = (err ** 2).sum(axis=1)
    pixels = np.flatnonzero((np.abs(err) > PIXEL_TOL).any(axis=1))
    lanes, void, attr_s = [], [], 0.0
    with counters_kept():  # the frames' launches stay counted, the rest not
        if pixels.size:
            rec_a = record_lanes(tables, cam, width, height, spp, depth, pixels)
            rec_b = record_lanes(cpu_tables, cam, width, height, spp, depth, pixels)
            void = self_check(frame_a, rec_a) + self_check(frame_b, rec_b)
            diffs = compare(rec_a, rec_b)
            for key in sorted(diffs, key=lambda k: -sq[k[0]]):
                d = diffs[key]
                lane = {"pixel": int(key[0]), "sample": int(key[1]), **d,
                        "hits": _hits_from(rec_a, rec_b, key, d["bounce"]),
                        "pixel_abs_err": float(np.abs(err[key[0]]).max()),
                        "pixel_sq_err_share": float(sq[key[0]] / sq.sum())}
                if on_card:
                    t0 = time.perf_counter()
                    lane.update(attribute(tables, cpu_tables, rec_a, rec_b, key, d,
                                          (cam, width, height, depth)))
                    attr_s += time.perf_counter() - t0
                lane["class"] = "ii" if key in void or lane.get("wave_dependent") else \
                    classify(d, lane.get("op"), on_card, lane.get("op_ulps"))
                lanes.append(lane)
    rmse = float(np.sqrt(np.mean(err ** 2)))
    return {"images": (img_a, img_b), "rays": (rays_a, rays_b), "rmse": rmse,
            "differing_pixels": int(pixels.size), "differing_lanes": len(lanes),
            "attributed": sum("op" in x for x in lanes), "attribution_s": attr_s,
            "void": bool(void), "wave_dependent_lanes": [list(map(int, k)) for k in void],
            **summarise(lanes), "lanes": lanes}


def compare_uploads(scene, cam, width: int, height: int, spp: int, depth: int, device) -> dict:
    """One scene uploaded instanced and flattened on one device: RMSE, rays,
    the pixels that differ by more than 1e-6, and each of their lanes' first
    difference between the two uploads (hit ids are not compared: the
    instanced ones encode the instance) and radiance on each side."""
    tables = {k: scene.upload(device, instancing=k == "instanced")
              for k in ("instanced", "flattened")}
    frames = {k: render_frame(t, cam, width, height, spp, depth) for k, t in tables.items()}
    (img_a, rays_a, _), (img_b, rays_b, _) = frames["instanced"], frames["flattened"]
    err = (img_a.astype(np.float64) - img_b.astype(np.float64)).reshape(-1, 3)
    pixels = np.flatnonzero((np.abs(err) > PIXEL_TOL).any(axis=1))
    lanes = []
    if pixels.size:
        with counters_kept():
            rec = {k: record_lanes(t, cam, width, height, spp, depth, pixels)
                   for k, t in tables.items()}
        for key, d in compare(rec["instanced"], rec["flattened"], ("t",)).items():
            lanes.append({"pixel": int(key[0]), "sample": int(key[1]), **d,
                          "radiance": [rec[k].radiance[key].tolist() for k in rec],
                          "pixel_abs_err": float(np.abs(err[key[0]]).max())})
    lanes.sort(key=lambda x: -x["pixel_abs_err"])
    return {"rmse": float(np.sqrt(np.mean(err ** 2))), "rays": [rays_a, rays_b],
            "differing_pixels": int(pixels.size), "differing_lanes": len(lanes),
            **{k: v for k, v in summarise(lanes).items() if k in ("by_first_bounce", "by_field")},
            "lanes": lanes}


def first_hits(tables, cam, width: int, height: int, spp: int):
    """The bounce-0 closest hit of samples 1..spp of every pixel (samples
    major): (camera rays (origin, direction), t, hit id); ``t`` is inf and
    the id -1 on a miss."""
    from vulkan_raytracer_tpu_torch.ops.math3 import EPS, INF
    from vulkan_raytracer_tpu_torch.render import integrator, renderer

    view_inv, proj_inv = renderer.camera_uniforms(_camera(cam, width, height))
    dev = tables.device
    pixels = torch.arange(width * height, device=dev).repeat(spp)
    samples = torch.arange(1, spp + 1, device=dev).repeat_interleave(width * height)
    o, d, _ = integrator.generate_primary_rays(view_inv, proj_inv, width, height, samples,
                                               pixels, device=dev)
    active = torch.ones(pixels.shape[0], dtype=torch.bool, device=dev)
    with torch.inference_mode():
        t, tri, _, _ = integrator._closest_opaque(tables, o, d, t_min=EPS, t_max=INF,
                                                  active=active)
    return (o, d), t, tri


def flattened_ids(inst, enc: np.ndarray) -> np.ndarray:
    """The flattened upload's triangle id of each encoded instanced hit id
    (-1 stays -1): both uploads order the instances depth first, and a
    flattened instance holds its prototype's triangles in order."""
    count = np.zeros(inst.num_instances, np.int64)
    proto_off = np.zeros(inst.num_instances, np.int64)
    for g in inst.groups:
        ids = g.inst_id.cpu().numpy()
        count[ids], proto_off[ids] = g.tri_cnt, g.tri_off
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    enc = np.asarray(enc, np.int64)
    proto, ii = enc % inst.num_proto_tris, enc // inst.num_proto_tris
    return np.where(enc >= 0, start[ii] + proto - proto_off[ii], -1)


def _edge_margin(flat, ids: np.ndarray, rays, lanes: np.ndarray) -> np.ndarray:
    """How far inside its triangle each lane's ray passes, in barycentric
    units (min(u, v, 1 - u - v); below 0 outside), on the flattened
    upload's world-space triangles."""
    from vulkan_raytracer_tpu_torch.ops.dense import mt
    from vulkan_raytracer_tpu_torch.ops.math3 import v3_gather

    idx = torch.as_tensor(ids, device=flat.device)
    at = torch.as_tensor(lanes, device=flat.device)
    v0 = v3_gather(flat.v0, idx)
    e1, e2 = v3_gather(flat.v1, idx) - v0, v3_gather(flat.v2, idx) - v0
    ray = [c[at] for c in (*rays[0], *rays[1])]
    _, u, v, _ = mt([*v0, *e1, *e2], ray)
    return torch.minimum(torch.minimum(u, v), 1.0 - u - v).cpu().numpy()


def hits_agree(inst, flat, cam, width: int, height: int, spp: int) -> dict:
    """Bounce-0 first hits of an instanced and a flattened upload of one
    scene, lane by lane (``chip_smoke.py``'s ``instanced_vs_flattened``).
    Where both hit one triangle, t must agree within ``HIT_T_ULPS`` ulps:
    the instanced route maps the ray into object space, the flattened one
    the triangles into world space.  A lane may hit another triangle, or hit
    on one route only, where it is a tie (the two t within ``HIT_T_ULPS``)
    or a crack: the nearer hit lies within ``EDGE_MARGIN`` of its
    triangle's edge, where the routes' rounding puts the ray on either side
    (Moeller-Trumbore is not watertight); cracks may be at most
    ``MAX_CRACK_SHARE`` of the lanes.  Anything else is a fault."""
    rays, t_i, enc = first_hits(inst, cam, width, height, spp)
    _, t_f, tri_f = first_hits(flat, cam, width, height, spp)
    t_i, t_f = t_i.cpu().numpy(), t_f.cpu().numpy()
    a, b = flattened_ids(inst.inst, enc.cpu().numpy()), tri_f.cpu().numpy().astype(np.int64)
    hit_a, hit_b = a >= 0, b >= 0
    ulps = np.abs(_ordered(t_i) - _ordered(t_f))
    same = hit_a & hit_b & (a == b)
    other = (hit_a | hit_b) & ~same
    tie = other & hit_a & hit_b & (ulps <= HIT_T_ULPS)
    lanes = np.flatnonzero(other & ~tie)
    nearer = np.where(t_i[lanes] <= t_f[lanes], a[lanes], b[lanes])
    margin = _edge_margin(flat, nearer, rays, lanes) if lanes.size else np.zeros(0)
    crack = np.abs(margin) <= EDGE_MARGIN
    faults = int((~crack).sum()) + int((ulps[same] > HIT_T_ULPS).sum())
    n = int(a.size)
    out = {"lanes": n, "hits": int(hit_b.sum()), "same_triangle": int(same.sum()),
           "t_ulps_max": int(ulps[same].max()) if same.any() else 0,
           "t_ulps_over_bound": int((ulps[same] > HIT_T_ULPS).sum()),
           "hit_on_one_route": int((hit_a != hit_b).sum()), "ties": int(tie.sum()),
           "cracks": int(crack.sum()), "crack_margins": [float(m) for m in margin[crack]],
           "faults": faults, "t_ulps_bound": HIT_T_ULPS, "edge_margin": EDGE_MARGIN,
           "max_cracks": int(MAX_CRACK_SHARE * n)}
    out["ok"] = faults == 0 and out["cracks"] <= out["max_cracks"] and out["hits"] > 0
    return out


def check_uploads(scene, cam, device, frame=UPLOADS_FRAME, shift: float = 0.0) -> dict:
    """``chip_smoke.py``'s ``instanced_vs_flattened``: ``scene`` uploaded
    instanced and flattened on ``device``; the first hits of the frame's
    lanes (:func:`hits_agree`) and its image, whose RMSE must stay below
    ``RMSE_BAR``: at 32 spp one flipped path (a lane of this frame measured 2.37
    apart) moves the frame's RMSE by at most 3.3e-4.  ``shift`` moves the
    first instance by that much in x before the instanced upload: a wrong
    instance transform, which the check must catch."""
    from vulkan_raytracer_tpu_torch.render.renderer import render_image

    size, spp, depth = frame
    flat = scene.upload(device, instancing=False)
    node = next(n for n in scene.iter_depth_first() if n.mesh >= 0)
    kept = node.world_transform
    node.world_transform = kept.copy()
    node.world_transform[0, 3] += shift
    try:
        inst = scene.upload(device, instancing=True)
    finally:
        node.world_transform = kept
    hits = hits_agree(inst, flat, cam, size, size, spp)
    images = {}
    for name, tables in (("instanced", inst), ("flattened", flat)):
        img, rays = render_image(tables, _camera(cam, size, size), size, size, spp=spp,
                                 max_depth=depth, tonemap=False)
        images[name] = {"image": img, "rays": rays}
    a, b = images["instanced"]["image"], images["flattened"]["image"]
    rmse = float(np.sqrt(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))
    image_ok = bool(np.isfinite(a).all() and b.mean() > 1e-3 and rmse < RMSE_BAR)
    return {"frame": f"{size}x{size} {spp} spp depth {depth}", "shift": shift,
            "first_hits": hits, "rmse": rmse, "bar": RMSE_BAR, "image_mean": float(b.mean()),
            "rays": [images[k]["rays"] for k in images], "image_ok": image_ok,
            "ok": hits["ok"] and image_ok}


def scene_case(name: str, device):
    """(tables on ``device``, camera (position, direction), size, spp, depth)
    of one of the scenes in :data:`FRAMES`."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs

    size, spp, depth = FRAMES[name]
    if name == "cornell":
        from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

        return cornell_box_scene().upload(device), cs.CFG1_CAM, size, spp, depth
    if name == "gallery":
        return cs.gallery_scene().upload(device), cs.gallery_camera(), size, spp, depth
    if name == "soup":
        scene = cs.emitter_soup_scene(100000, 5000, seed=31)
        return scene.upload(device), cs.CFG1_CAM, size, spp, depth
    if name == "cfg4":
        from vulkan_raytracer_tpu_torch import bench

        cfg = next(c for c in bench.CONFIGS if c["key"].startswith("cfg4"))
        if cfg["crop"] != (size, spp, depth):
            raise AssertionError(f"cfg4's gate crop is {cfg['crop']}, not {(size, spp, depth)}")
        return cfg["build"]().upload(device), cfg["cam"], size, spp, depth
    import torch_glb_assets

    from vulkan_raytracer_tpu_torch.scene.scenegraph import Scene

    scene = Scene()
    with tempfile.TemporaryDirectory() as tmp:
        scene.load_model(torch_glb_assets.write_bigasset_glb(Path(tmp), big=True))
    return scene.upload(device), cs.BIGASSET_CAM, size, spp, depth


def report(res: dict, lanes_shown: int = 40) -> dict:
    """The JSON-ready part of a :func:`diagnose` result."""
    out = {k: v for k, v in res.items() if k not in ("images", "lanes")}
    out["lanes"] = res["lanes"][:lanes_shown]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", choices=[*FRAMES, "all"], default="all")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--uploads", action="store_true",
                   help="instead: chip_smoke.py's instanced_vs_flattened check (4 dragons "
                        "uploaded both ways on --device: first hits and the 128x128 32 spp "
                        "image), then the lanes of the 2 spp frame it replaced")
    p.add_argument("--wrong-transform", type=float, default=0.0, metavar="DX",
                   help="with --uploads: move the first dragon by DX in x before the "
                        "instanced upload, a fault the check must catch")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_lane_diff.py: --device cuda needs an NVIDIA card; "
                         "--device cpu runs the CPU-against-CPU self-test")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if args.uploads:
        sys.path.insert(0, str(ROOT / "tools"))
        import chip_smoke as cs

        scene, cam = cs.gallery_scene(n_dragons=4), cs.gallery_camera(4)
        check = check_uploads(scene, cam, device, shift=args.wrong_transform)
        lanes = compare_uploads(scene, cam, 128, 128, 2, 3, device)
        device_name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
        print(json.dumps({"device": device_name, **check,
                          "lanes_2spp": {**lanes, "lanes": lanes["lanes"][:8]}}), flush=True)
        return 0 if check["ok"] else 1
    results = {}
    for name in FRAMES if args.scene == "all" else [args.scene]:
        tables, cam, size, spp, depth = scene_case(name, device)
        res = report(diagnose(tables, cam, size, size, spp, depth))
        res.update(scene=name, frame=f"{size}x{size} {spp} spp depth {depth}",
                   device=torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu")
        results[name] = res
        print(json.dumps({k: v for k, v in res.items() if k != "lanes"}), flush=True)
        del tables
        if args.out:  # after each scene, so a cut run keeps what it found
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
