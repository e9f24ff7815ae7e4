"""Wavefront path-tracing integrator on torch tensors.

Port of :mod:`vulkan_raytracer_tpu.render.integrator`: every pixel sample
is a lane, the bounce loop is a Python loop that stops once no lane is
alive, and each ``traceRayEXT`` of the reference (shaders/raygen.rgen,
lightsample.glsl) is one dense sweep from
:mod:`vulkan_raytracer_tpu_torch.ops.dense` or, for a scene uploaded with
BVH streams, one BVH walk from :mod:`vulkan_raytracer_tpu_torch.ops.traverse`;
each launches a CUDA kernel on CUDA tensors.  An instanced scene
(``tables.inst``) runs the same kernels once per instance through
:mod:`vulkan_raytracer_tpu_torch.ops.instanced`; its hit ids encode
(instance, prototype triangle), which :func:`eval_hit` and the alpha test
decode.  All vector state is in
component form (``V3`` of (N,) tensors).  The algorithm, its RNG draw order and its quirks are the JAX
module's (integrator.py:13-27): NEE runs with the throughput that already
includes the current hit's estimator, paths end on emissive hits weighted
against NEE by the balance heuristic, and sample 0 is the preview sample.

Between a bounce's traversal launches its lanes are shaded by the three
kernels of :mod:`vulkan_raytracer_tpu_torch.ops.shade` (the hit's state,
the material and light samples up to the shadow ray, the NEE resolve),
what XLA fuses of the JAX bounce body; on CPU tensors their plain versions,
this module's former torch code regrouped (:func:`sample_lights` stays
here as the unsplit composition the tests hold the split against).

glTF materials come with their six texture slots (base colour,
metallic-roughness, normal map, emissive, transmission, anisotropy) and with
MASK/BLEND alpha.  Alpha runs as the JAX accept/reject resample loop
(:func:`_closest`): the closest-hit kernel is launched again past each
rejected candidate with per-lane ``t_min``, so the kernels themselves stay
alpha-free, and each pass's test and commit is one kernel
(:func:`..ops.wave.alpha_commit`); on alpha scenes the occlusion rays go
through the same loop.

A frame's waves run through :class:`Waves` (the JAX ``lax.scan`` of
renderer.py:52-88): each wave's initial state is one kernel
(:func:`..ops.wave.primary_rays`) reading the wave's sample numbers, pixel
lanes and camera from the device, and on CUDA tables the whole wave, its
sum into the band's sum included, is one captured program
(:mod:`.graphs`), so the host neither reads the device nor makes a tensor
of host data between a frame's first wave and its read at its end.

The port takes the JAX package's default settings as fixed: the skybox
fetch is deferred to one lookup after the loop, and NEE prunes lanes whose
contribution is zero regardless of occlusion (on alpha-free scenes).  The
emissive-pdf probe is the dense pdf sweep up to ``EMISSIVE_MAX_TRIS``
emissive triangles and the walk of the emissive-only BVH above.

Scenes whose rays walk BVH streams (:func:`_repack_preferred`, the JAX
``_beam_occlusion`` rule) run a repacked wavefront (integrator.py:918-1137):
lanes start in 32x32-block pixel order, and every bounce after the first
re-sorts them by their coherence key (:func:`..ops.trace.coherence_key`:
dead last, then the direction octant, then the Morton cell of the origin),
every column in one :func:`..ops.trace.permute`; NEE occlusion rays are
re-sorted by their own key (:func:`_shadow`).  Once at most half the lanes are alive
the live ones are a prefix of the sorted wave, so the loop goes on at half and
then a quarter of the width (the width ladder) and rejoins the tail at the
end; ``slot`` carries each lane's output position.  A lane's state never
depends on its neighbours, so the image and the ray count are those of the
unsorted loop, bit for bit.  :data:`BOUNCE_WIDTHS` counts the bounces run at
each width.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import dense, instanced, rng, shade, trace, traverse, wave
from ..ops.bsdf import material_bsdf, material_pdf
from ..ops.dense import EMISSIVE_MAX_TRIS, dense_closest, dense_emissive_pdf, dense_shadow
from ..ops.instanced import instanced_closest, instanced_shadow
from ..ops.math3 import EPS, INF, V3, v3_to_tangent
from ..ops.shade import (  # noqa: F401  (eval_hit: the plain hit, as it was here)
    _balance, _offset_origin, _sample_analytic, _sample_emissive, eval_hit)
from ..ops.texture import sample_equirect
from ..ops.traverse import bvh_closest, bvh_emissive_pdf, bvh_shadow
from ..ops.wave import alpha_test as _alpha_test  # noqa: F401  (its name here before)
from . import graphs

_F32 = torch.float32

#: The alpha resample loop since the last reset: ``calls`` of :func:`_closest`
#: on an alpha scene, their ``iterations`` (closest-hit launches) in all, and
#: ``max``, the most iterations one call took.
ALPHA_LOOP = {"calls": 0, "iterations": 0, "max": 0}


def reset_alpha_loop() -> None:
    for k in ALPHA_LOOP:
        ALPHA_LOOP[k] = 0


#: Bounces since the last reset, by the width of the wave they ran at: a
#: repacked wave of n lanes shows n, n // 2 and n // 4 once the ladder stepped.
BOUNCE_WIDTHS: dict[int, int] = {}


def reset_bounce_widths() -> None:
    BOUNCE_WIDTHS.clear()


# ---------------------------------------------------------------------------
# Traversal dispatch (integrator.py:105-127, 270-299): an instanced scene
# takes the two-level traversal, a scene uploaded with BVH streams walks
# them, and every other scene takes the dense sweeps.
# ---------------------------------------------------------------------------


def _closest_opaque(tables, o: V3, d: V3, *, t_min, t_max, active):
    if tables.inst is not None:
        return instanced_closest(tables, o, d, t_min=t_min, t_max=t_max, active=active)
    if tables.pbvh is not None:
        return bvh_closest(tables, o, d, t_min=t_min, t_max=t_max, active=active)
    return dense_closest(tables, o, d, t_min=t_min, t_max=t_max, active=active)


def _count_alpha_loop(passes: int, calls: int = 1, most: int | None = None) -> None:
    """Count ``calls`` resample loops that ran ``passes`` passes in all, at
    most ``most`` in one call (one call: ``passes``)."""
    ALPHA_LOOP["calls"] += calls
    ALPHA_LOOP["iterations"] += passes
    ALPHA_LOOP["max"] = max(ALPHA_LOOP["max"], passes if most is None else most)


def _alpha_pass(tables, o: V3, d: V3, t_max, st: dict, count=None) -> None:
    """One pass of the resample loop over its state ``st`` (the loop's own
    buffers): trace the nearest candidate above each
    pending lane's ``t_lo``, then test and commit it
    (:func:`..ops.wave.alpha_commit`, one kernel on the card), the next
    state written over ``st`` and, where given, the lanes still pending
    into ``count``."""
    t_c, tri_c, u_c, v_c = _closest_opaque(tables, o, d, t_min=st["t_lo"], t_max=t_max,
                                           active=st["pending"])
    wave.alpha_commit(tables, st, t_c, tri_c, u_c, v_c, count)


def _closest(tables, o: V3, d: V3, *, t_min, t_max, active, seed):
    """traceRayEXT closest hit with any-hit alpha (hit.rahit;
    integrator.py:165-217).  Returns ((t, tri, u, v), seed).

    Alpha-free scenes take the opaque traversal once.  Alpha scenes run the
    accept/reject loop: trace the nearest candidate above each lane's
    ``t_lo``, test it, and move ``t_lo`` of a rejected lane strictly past its
    candidate (t * (1 + 4e-7) + 1e-30 in float32); repeat while a lane is
    pending (:func:`_alpha_pass`).  Candidates are thus tested in t order.
    Each pass is one closest-hit launch and one test-and-commit launch,
    counted in :data:`ALPHA_LOOP`; the loop's state is buffers of its own,
    which each pass writes over.

    Eagerly the host reads whether a lane is pending before each pass.  In a
    wave being captured the loop becomes a WHILE node on the count of
    pending lanes, which each pass's commit writes (:mod:`.graphs`).
    """
    if not tables.has_alpha:
        return _closest_opaque(tables, o, d, t_min=t_min, t_max=t_max, active=active), seed
    n = o.x.shape[0]
    dev = o.x.device

    def own(x):
        return x.clone(memory_format=torch.contiguous_format)

    st = dict(t_lo=own(trace.lanes(t_min, n, dev)), pending=own(active),
              t=torch.full((n,), torch.inf, dtype=_F32, device=dev),
              tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
              u=torch.zeros(n, dtype=_F32, device=dev), v=torch.zeros(n, dtype=_F32, device=dev),
              seed=own(seed))
    body = functools.partial(_alpha_pass, tables, o, d, t_max)
    cap = graphs.current_capture()
    if cap is not None:
        cap.loop(body, st, done=_count_alpha_loop)
    else:
        passes = 0
        while bool(st["pending"].any()):
            body(st)
            passes += 1
        _count_alpha_loop(passes)
    return (st["t"], st["tri"], st["u"], st["v"]), st["seed"]


def _shadow_unsorted(tables, o: V3, d: V3, *, t_max, active, seed):
    """Occlusion with tMin = 0 (shadow.rahit; integrator.py:270-288).
    Returns (occluded, seed).  On alpha scenes the nearest *accepted* hit
    within t_max occludes: the query runs the :func:`_closest` loop."""
    if not tables.has_alpha:
        if tables.inst is not None:
            return instanced_shadow(tables, o, d, t_max=t_max, active=active), seed
        if tables.pbvh is not None:
            return bvh_shadow(tables, o, d, t_max=t_max, active=active), seed
        return dense_shadow(tables, o, d, t_max=t_max, active=active), seed
    (_, tri, _, _), seed = _closest(tables, o, d, t_min=0.0, t_max=t_max, active=active,
                                    seed=seed)
    return (tri >= 0) & active, seed


def _shadow(tables, o: V3, d: V3, *, t_max, active, seed):
    """Occlusion query (integrator.py:234-267).  On a repacked scene the
    rays are sorted by their own coherence key first (NEE rays
    point at the lights, not along the material rays the wave is sorted
    for), and the flags and seeds are scattered back: BLEND alpha draws
    random numbers inside the query, so a seed travels with its lane."""
    if not _repack_preferred(tables):
        return _shadow_unsorted(tables, o, d, t_max=t_max, active=active, seed=seed)
    perm = torch.argsort(trace.coherence_key(tables, o, d, active), stable=True)
    bounded = isinstance(t_max, torch.Tensor)
    cols = trace.permute([*o, *d, active, seed, *((t_max,) if bounded else ())], perm)
    occ_p, seed_p = _shadow_unsorted(tables, V3(*cols[0:3]), V3(*cols[3:6]),
                                     t_max=cols[8] if bounded else t_max, active=cols[6],
                                     seed=cols[7])
    occ, seed = trace.permute([occ_p, seed_p], perm, "scatter")
    return occ, seed


def _emissive_pdf(tables, o: V3, d: V3, *, t_min, active):
    if tables.num_emissive_tris == 0:
        return torch.zeros(o.x.shape[0], dtype=_F32, device=o.x.device)
    if tables.num_emissive_tris > EMISSIVE_MAX_TRIS:
        return bvh_emissive_pdf(tables, o, d, t_min=t_min, active=active)
    return dense_emissive_pdf(tables, o, d, t_min=t_min, active=active)


# ---------------------------------------------------------------------------
# Lane order: 32x32 pixel blocks and the coherence re-sort
# ---------------------------------------------------------------------------


def _repack_preferred(tables) -> bool:
    """Does this scene run a repacked wavefront?  The JAX ``_beam_occlusion``
    rule (integrator.py:220-231): a flattened scene that walks BVH streams
    because it has more than ``DENSE_MAX_TRIS`` triangles, or an instanced
    scene with a prototype that walks its own streams.  Dense scenes, and a
    small scene put on the BVH path by ``traversal="bvh"``, keep lane order."""
    if tables.inst is not None:
        return any(g.pblas is not None for g in tables.inst.groups)
    return tables.pbvh is not None and tables.num_triangles > dense.DENSE_MAX_TRIS


@functools.lru_cache(maxsize=8)
def block_order(width: int, height: int, block: int = 32):
    """Pixel permutation grouping 32x32 image blocks into consecutive lanes
    (integrator.py:376-395).  Returns (order, inverse) numpy int32 arrays;
    cached, so callers must not mutate them."""
    idx = np.arange(width * height)
    px, py = idx % width, idx // width
    nbx = -(-width // block)
    key = ((py // block) * nbx + (px // block)) * (block * block) + (py % block) * block + (
        px % block
    )
    order = np.argsort(key, kind="stable").astype(np.int32)
    inverse = np.argsort(order, kind="stable").astype(np.int32)
    return order, inverse


def _sort_wavefront(tables, s: dict) -> dict:
    """The wave state sorted by its coherence key (:func:`..ops.trace.coherence_key`;
    integrator.py:352-373), stably, as ``jnp.argsort`` sorts: every column
    gathered in one :func:`..ops.trace.permute`."""
    key = trace.coherence_key(tables, s["origin"], s["direction"], s["active"])
    perm = torch.argsort(key, stable=True)
    return graphs._state_like(s, trace.permute(graphs._leaves(s), perm))


def _split(s: dict, m: int):
    """The first ``m`` lanes of every field, and the rest."""
    def part(sl):
        return {k: V3(v.x[sl], v.y[sl], v.z[sl]) if isinstance(v, V3) else v[sl]
                for k, v in s.items()}

    return part(slice(None, m)), part(slice(m, None))


def _join(head: dict, tail: dict) -> dict:
    return {k: V3(*(torch.cat([a, b]) for a, b in zip(v, tail[k]))) if isinstance(v, V3)
            else torch.cat([v, tail[k]]) for k, v in head.items()}


# ---------------------------------------------------------------------------
# Primary rays (raygen.rgen:33-43)
# ---------------------------------------------------------------------------


def generate_primary_rays(view_inv, proj_inv, width, height, sample_count, lane_idx=None, *,
                          device):
    """Camera rays for the given pixel lanes; returns (origin V3, direction
    V3, seed).  Port of integrator.py:403-442, the rays of
    :func:`..ops.wave.camera_rays` from host data.

    ``sample_count`` is an int or a per-lane tensor; ``lane_idx`` selects
    pixel lanes (default: all width*height pixels).  ``view_inv``/``proj_inv``
    are float32 (4, 4) arrays; the rays lie on ``device``.  A wave's rays
    come from :func:`..ops.wave.primary_rays` instead, which reads all of
    that from the device.
    """
    if lane_idx is None:
        idx = torch.arange(width * height, dtype=torch.int64, device=device)
    else:
        idx = rng.as_u32(lane_idx, device).to(device)
    counts = rng.as_u32(sample_count, device)
    return wave.camera_rays(idx, counts, wave.camera_tensor(view_inv, proj_inv, device), width,
                            height)


# ---------------------------------------------------------------------------
# Next-event estimation (shaders/lightsample.glsl)
# ---------------------------------------------------------------------------


def sample_lights(tables, hit, wavelength, view_world: V3, seed, mask):
    """Port of sampleLights (lightsample.glsl:143-173; integrator.py:803-892).

    Strategy pick between analytic and emissive NEE, BSDF x cos / pdf with
    balance-heuristic MIS for area lights (delta lights exempt).
    Returns (contribution V3, seed, rays_traced (0-d int64 tensor)).
    """
    has_analytic = tables.num_point + tables.num_directional > 0
    has_emissive = tables.num_emissive_tris > 0
    n = hit.t.shape[0]
    dev = hit.t.device
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    if not has_analytic and not has_emissive:
        return V3.full((0.0, 0.0, 0.0), n, dev), seed, rays

    if has_analytic:
        u, seed_s = rng.rnd(seed)  # drawn whenever analytic lights exist (:150)
        seed = torch.where(mask, seed_s, seed)
        pick_analytic = (u < 0.5) | (not has_emissive)
    else:
        pick_analytic = torch.zeros(n, dtype=torch.bool, device=dev)

    radiance = V3.full((0.0, 0.0, 0.0), n, dev)
    light_dir = V3.full((0.0, 0.0, 0.0), n, dev)
    pdf = torch.zeros(n, dtype=_F32, device=dev)
    t_max = torch.full((n,), INF, dtype=_F32, device=dev)
    delta = pick_analytic

    if has_analytic:
        rad_a, dir_a, pdf_a, tmax_a, seed = _sample_analytic(
            tables, hit, seed, mask & pick_analytic
        )
        radiance = rad_a.where(pick_analytic, radiance)
        light_dir = dir_a.where(pick_analytic, light_dir)
        pdf = torch.where(pick_analytic, pdf_a, pdf)
        t_max = torch.where(pick_analytic, tmax_a, t_max)
        rays = rays + (mask & pick_analytic).sum()
    if has_emissive:
        rad_e, dir_e, tmax_e, seed = _sample_emissive(tables, hit, seed, mask & ~pick_analytic)
        radiance = radiance.where(pick_analytic, rad_e)
        light_dir = light_dir.where(pick_analytic, dir_e)
        t_max = torch.where(pick_analytic, t_max, tmax_e)
        rays = rays + (mask & ~pick_analytic).sum()

    # NdotL / black-light pruning (integrator.py:848-865): a lane whose NEE
    # contribution is zero whatever the occlusion traces nothing; the ray
    # counters above keep the reference's accounting.  Not on alpha scenes:
    # their occlusion query draws per-lane RNG (BLEND), and pruning would
    # desync the streams from the JAX run.
    tview = v3_to_tangent(view_world, hit.tangent, hit.bitangent, hit.normal)
    tlight = v3_to_tangent(light_dir, hit.tangent, hit.bitangent, hit.normal)
    bsdf_val = material_bsdf(hit, wavelength, tview, tlight)
    trace_mask = mask
    if not tables.has_alpha:
        trace_mask = mask & radiance.any_nonzero() & bsdf_val.any_nonzero()

    # ONE occlusion launch for both branches (lightsample.glsl:45, :131)
    ray_o = _offset_origin(hit, light_dir)
    occluded, seed = _shadow(tables, ray_o, light_dir, t_max=t_max, active=trace_mask,
                             seed=seed)
    radiance = radiance.where(~occluded & trace_mask, 0.0)
    if has_emissive:
        # pdf probe over all emissive surfaces along the verified ray
        # (lightsample.glsl:136); only surviving emissive-branch lanes
        visible = mask & ~pick_analytic & ~occluded & radiance.any_nonzero()
        pdf_e = _emissive_pdf(tables, ray_o, light_dir, t_min=0.0, active=visible)
        pdf = torch.where(pick_analytic, pdf, pdf_e)
        radiance = radiance.where(pick_analytic | visible, 0.0)
        rays = rays + visible.sum()

    got_light = radiance.any_nonzero() & mask
    pdf = pdf / float(max(1, int(has_analytic) + int(has_emissive)))  # :161
    mis = torch.where(delta, 1.0, _balance(pdf, material_pdf(hit, tview, tlight)))
    scale = mis * torch.abs(hit.normal.dot(light_dir)) / torch.clamp_min(pdf, 1e-30)
    contrib = (radiance * bsdf_val * scale).where(got_light & bsdf_val.any_nonzero(), 0.0)
    return contrib, seed, rays


# ---------------------------------------------------------------------------
# The bounce loop (raygen.rgen:52-88)
# ---------------------------------------------------------------------------


def _bounce(tables, s: dict, b, max_depth: int, nee_weighting: str, rays=None):
    """One bounce of every lane of the wave state ``s`` (integrator.py:961-1046):
    returns the next state and ``rays`` (a 0-d int64 tensor, made if not
    given) with the bounce's rays added (material + NEE + terminal emissive
    probes).  A dead lane's fields come out as they went in.  ``b`` is the
    bounce index: a Python int eagerly, an int32 device scalar in a captured
    wave (:func:`_wave_program`).

    The traversal launches (:func:`_closest`, :func:`_shadow`, the emissive
    pdf probes) alternate with the three shading kernels of
    :mod:`..ops.shade`: the hit's state, the material and light samples up to
    the shadow ray, and the NEE resolve, which also counts the rays.
    Nothing here reads the device on the host but the resample loops of an
    alpha scene (:func:`_closest`), which a capture turns into WHILE nodes,
    so the bounce can be captured (:mod:`.graphs`)."""
    n = s["active"].shape[0]
    BOUNCE_WIDTHS[n] = BOUNCE_WIDTHS.get(n, 0) + 1
    if rays is None:
        rays = torch.zeros((), dtype=torch.int64, device=s["active"].device)

    (t, tri, u, v), seed = _closest(tables, s["origin"], s["direction"], t_min=EPS, t_max=INF,
                                    active=s["active"], seed=s["seed"])
    hs = shade.shade_hit(tables, s, b, max_depth, t, tri, u, v)
    # emissive MIS probe (raygen.rgen:67-73) for the terminal emissive hits
    pdf_probe = _emissive_pdf(tables, s["origin"], s["direction"], t_min=EPS,
                              active=hs.probe_mask)
    # the material sample (raygen.rgen:79-84), then NEE for the surviving
    # lanes up to their shadow ray (raygen.rgen:54-56)
    st, ls = shade.shade_scatter(tables, s, hs, pdf_probe, seed)
    occluded = visible = pdf_e = None
    if ls is not None:
        # ONE occlusion launch for both strategies (lightsample.glsl:45, :131)
        occluded, st["seed"] = _shadow(tables, ls.ray_o, ls.light_dir, t_max=ls.t_max,
                                       active=ls.trace_mask, seed=st["seed"])
        if tables.num_emissive_tris > 0:
            # pdf probe over all emissive surfaces along the verified ray
            # (lightsample.glsl:136); only surviving emissive-branch lanes
            visible = ls.vis_pre & ~occluded
            pdf_e = _emissive_pdf(tables, ls.ray_o, ls.light_dir, t_min=0.0, active=visible)
    st["value"] = shade.shade_resolve(tables, s, hs, st, ls, occluded, visible, pdf_e,
                                      nee_weighting, rays)
    return dict(s, **st, sky_w=hs.sky_w), rays


#: The hand-written kernels' launch counters, by module (``graphs``:
#: ``loop_cond_kernel``'s, which only the device loops launch; ``trace``'s
#: ``permute_copy``: the permute kernel's copies of a program's state, which
#: only a program makes): what the bench, the smoke, the tools and the tests
#: read (:func:`launch_counts`) and zero (:func:`reset_counters`).
LAUNCH_COUNTERS = {"dense": dense.LAUNCHES, "traverse": traverse.LAUNCHES,
                   "shade": shade.LAUNCHES, "wave": wave.LAUNCHES, "trace": trace.LAUNCHES,
                   "graphs": graphs.LAUNCHES}
#: The Python-side counters a bounce advances; a captured wave adds what each
#: part's capture counted times the runs of its body (:mod:`.graphs`).
_COUNTERS = (*(d for name, d in LAUNCH_COUNTERS.items() if name != "graphs"), instanced.STATS,
             BOUNCE_WIDTHS, ALPHA_LOOP)


def launch_counts(loops: bool = True) -> dict:
    """Each kernel's launches since the last :func:`reset_counters`, by
    module; with ``loops``, those only a captured program makes too:
    ``loop_cond_kernel``'s (``graphs``) and the state copies
    (``trace``'s ``permute_copy``)."""
    return {name: {k: n for k, n in d.items() if loops or k != "permute_copy"}
            for name, d in LAUNCH_COUNTERS.items() if loops or name != "graphs"}


def reset_counters() -> None:
    """Zero the launch counters, the instance steps, the bounce widths and
    the alpha loop's counter, once the device loops' counts so far are in
    (:func:`.graphs.settle`)."""
    graphs.settle()
    for d in (*LAUNCH_COUNTERS.values(), instanced.STATS, ALPHA_LOOP):
        for k in d:
            d[k] = 0
    BOUNCE_WIDTHS.clear()


def _step(tables, s: dict, b: int, max_depth: int, nee_weighting: str, sort_first: bool, rays):
    """One step of the eager bounce loop: the coherence re-sort where asked,
    then :func:`_bounce`, adding its rays into ``rays``."""
    if sort_first:
        s = _sort_wavefront(tables, s)
    return _bounce(tables, s, b, max_depth, nee_weighting, rays)


def _radiance(tables, s: dict):
    """(N, 3) radiance of the wave state ``s`` after its last bounce: the
    value gathered plus the deferred skybox, one equirect fetch for the whole
    loop."""
    sky = sample_equirect(tables.skybox, s["direction"].to_array()) * tables.skybox_strength
    return (s["value"] + s["sky_w"] * V3.from_array(sky)).to_array()


@functools.lru_cache(maxsize=8)
def block_lanes(width: int, height: int, device) -> torch.Tensor:
    """:func:`block_order`'s pixel order as int64 on ``device``, computed
    there (a copy from the host would synchronise); cached, so callers must
    not mutate it."""
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    px, py = idx % width, idx // width
    nbx = -(-width // 32)
    key = ((py // 32) * nbx + (px // 32)) * 1024 + (py % 32) * 32 + (px % 32)
    return torch.argsort(key, stable=True)


def _add_wave(total, frame_rays, radiance, rays, k: int) -> None:
    """Add a wave's radiance, summed over its ``k`` samples (samples-major
    lanes), into ``total`` and its rays into ``frame_rays``
    (renderer.py:79-80, 87)."""
    total.add_(radiance if k == 1 else radiance.reshape(k, -1, 3).sum(dim=0))
    frame_rays.add_(rays)


class Waves:
    """The waves of one frame: one tables, camera, size, depth and NEE
    weighting, over one band of pixel lanes at a time (integrator.py:900-1138
    under renderer.py:52-88's ``lax.scan``).

    :meth:`band` starts a band: its pixel lanes (int64, on the tables'
    device) and a zero :attr:`sum`.  :meth:`run` traces samples ``first`` ..
    ``first + k - 1`` of every lane of the band in one wave (lane i is pixel
    ``lanes[i % n]`` at sample ``first + i // n``), adds its radiance summed
    over the samples into :attr:`sum` ((n, 3), aligned with the lanes) and
    its rays into :attr:`rays` (0-d int64, the frame's), and returns the
    wave's (radiance per lane, rays).

    On CUDA tables (``graphs._graphs_preferred``) a wave is one launch of a
    captured program (:mod:`.graphs`) that reads its sample numbers, pixel
    lanes and camera from the device and owns the sum and the ray counter:
    the camera goes to the device once a frame (from pinned memory,
    non-blocking), a band's lanes device to device, a wave's sample numbers
    by an ``arange`` there, so the host neither makes a tensor of host data
    nor reads the device inside the waves.  The returned tensors are then
    the program's own, overwritten by its next launch.  Else each wave runs
    eagerly (:func:`_wave`)."""

    def __init__(self, tables, view_inv, proj_inv, width: int, height: int, max_depth: int,
                 nee_weighting: str = "reference"):
        if nee_weighting not in ("reference", "physical"):
            raise ValueError(
                f"nee_weighting must be 'reference' or 'physical', not {nee_weighting!r}")
        self.tables, self.width, self.height = tables, width, height
        self.max_depth, self.nee_weighting = max_depth, nee_weighting
        self.repack = _repack_preferred(tables)
        dev = self.device = tables.device
        self.cache = graphs.cache(tables) if graphs._graphs_preferred(tables) else None
        if self.cache is None:
            self.cam = torch.empty(32, dtype=_F32, device=dev)
            self.rays = torch.zeros((), dtype=torch.int64, device=dev)
        else:
            self.cam = self.cache.buffer("cam", (32,), _F32, dev)
            self.rays = self.cache.buffer("rays", (), torch.int64, dev)
            self.rays.zero_()
        host = wave.camera_tensor(view_inv, proj_inv)
        if dev.type == "cuda":
            # the allocator keeps a pinned block until the copies from it ran
            host = host.pin_memory()
        self.cam.copy_(host, non_blocking=True)
        self.lanes = self.sum = None

    def band(self, lanes) -> None:
        """Start a band over the pixel ``lanes`` (a tensor on the tables'
        device): a zero :attr:`sum`."""
        n = lanes.shape[0]
        if self.cache is None:
            self.lanes = lanes.to(torch.int64)
            self.sum = torch.zeros((n, 3), dtype=_F32, device=self.device)
            return
        self.lanes = self.cache.buffer("lanes", (n,), torch.int64, self.device)
        self.lanes.copy_(lanes)  # device to device
        self.sum = self.cache.buffer("sum", (n, 3), _F32, self.device)
        self.sum.zero_()

    def run(self, first: int, k: int, pixel_order: bool = False):
        """One wave of ``k`` samples from ``first`` over the band (with
        ``pixel_order``, one sample of a whole frame on the repacked
        wavefront, the radiance comes back in pixel order).  Returns
        (radiance (n * k, 3) samples-major, rays (0-d int64))."""
        opts = dict(width=self.width, height=self.height, max_depth=self.max_depth,
                    nee_weighting=self.nee_weighting, repack=self.repack,
                    pixel_order=pixel_order)
        if self.cache is None:
            io = dict(samples=torch.arange(first, first + k, dtype=torch.int64,
                                           device=self.device), lanes=self.lanes, cam=self.cam)
            radiance, rays = _wave_eager(self.tables, io, **opts)
            _add_wave(self.sum, self.rays, radiance, rays, k)
            return radiance, rays
        samples = self.cache.buffer("samples", (k,), torch.int64, self.device)
        torch.arange(first, first + k, out=samples)
        io = dict(samples=samples, lanes=self.lanes, cam=self.cam, sum=self.sum, rays=self.rays)
        key = (self.lanes.shape[0], k, self.width, self.height, pixel_order, self.max_depth,
               self.nee_weighting, self.repack)
        return self.cache.run(self.tables, key, io, functools.partial(_wave_eager, **opts),
                              functools.partial(_wave_program, **opts), _COUNTERS)


def render_sample(tables, view_inv, proj_inv, width, height, sample_count, max_depth,
                  lane_idx=None, nee_weighting="reference"):
    """Path-trace one sample for every pixel (or the given pixel lanes).

    Port of integrator.py:900-1138: one :class:`Waves` wave of one sample.
    Returns (radiance (N, 3), rays_traced (0-d int64 tensor)), tensors of
    their own: the counter tallies every traversal of an active lane
    (material + shadow/verify + pdf probes), the Mrays/s numerator.
    ``sample_count`` is an int.

    ``nee_weighting``: "reference" weights NEE by the throughput that
    includes the hit's own BSDF estimator (raygen.rgen:54-83, the
    reference's quirk); "physical" by the throughput up to the hit.

    On a repacked scene (:func:`_repack_preferred`) the lanes are re-sorted
    between bounces and, when N is a multiple of 4, run the width ladder;
    the radiance comes back in the order of ``lane_idx`` (in pixel order
    without it: the lanes start in 32x32-block order, integrator.py:931-934)
    all the same.
    """
    waves = Waves(tables, view_inv, proj_inv, width, height, max_depth, nee_weighting)
    dev = tables.device
    if lane_idx is not None:
        lanes = torch.as_tensor(lane_idx, device=dev).to(torch.int64)
    elif waves.repack:
        lanes = block_lanes(width, height, dev)
    else:
        lanes = torch.arange(width * height, dtype=torch.int64, device=dev)
    waves.band(lanes)
    radiance, rays = waves.run(sample_count, 1, pixel_order=lane_idx is None and waves.repack)
    return radiance.clone(), rays.clone()


def _wave_eager(tables, io: dict, *, width, height, max_depth, nee_weighting, repack,
                pixel_order):
    """A wave eagerly, from its inputs ``io`` (``samples``, ``lanes``,
    ``cam``): its initial state (:func:`..ops.wave.primary_rays`), then
    :func:`_wave`.  Returns (radiance in lane order, rays)."""
    s = wave.primary_rays(io["samples"], io["lanes"], io["cam"], width, height, repack,
                          pixel_order)
    return _wave(tables, s, max_depth, nee_weighting, repack)


def _wave(tables, s: dict, max_depth: int, nee_weighting: str, repack: bool):
    """The bounce loop over the initial wave state ``s``, eagerly: the host
    reads the live count before each bounce (integrator.py:1051-1124).
    Returns (radiance in lane order, rays)."""
    n = s["active"].shape[0]
    rays = torch.zeros((), dtype=torch.int64, device=s["active"].device)

    def run_phase(b, s, live_floor, live, sorted_=False):
        """Bounce while bounces remain and more than ``live_floor`` lanes are
        alive (integrator.py:1051-1069): the loop ends early once every lane
        terminated, the wavefront analogue of the per-thread `break`.  The
        live count is read on the host unless known (``live``: the start).
        Returns (next bounce, state, live lanes at the last test)."""
        while b <= max_depth:
            if live is None:
                live = int(s["active"].sum())
            if live <= live_floor:
                break
            s, _ = _step(tables, s, b, max_depth, nee_weighting,
                         repack and b > 0 and not sorted_, rays)
            sorted_, live = False, None
            b += 1
        return b, s, live

    # the width ladder (integrator.py:1071-1124): the sort puts dead lanes
    # last, so once at most n/2 (then n/4) lanes live they are a prefix;
    # the tail is dead, its state final, and rejoins after the loop
    ladder = repack and n % 4 == 0
    b, s, live = run_phase(0, s, n // 2 if ladder else 0, n)  # every lane starts alive
    tails = []
    for width, live_floor in ((n // 2, n // 4), (n // 4, 0)) if ladder else ():
        if b > max_depth or live == 0:
            break
        s, tail = _split(_sort_wavefront(tables, s), width)  # the live lanes, all of them
        tails.append(tail)
        b, s, live = run_phase(b, s, live_floor, live, sorted_=True)
    for tail in reversed(tails):
        s = _join(s, tail)
    return _lane_radiance(tables, s, repack), rays


def _wave_program(tables, io: dict, cap, *, width, height, max_depth: int, nee_weighting: str,
                  repack: bool, pixel_order: bool):
    """:func:`_wave_eager` and the wave's sum as a program of captured parts
    (``graphs._Capture`` ``cap``): the same control flow as device-side
    loops, JAX's ``while_loop``s and ``cond``s.  Its first node is the
    primary-ray kernel, which reads the program's inputs (``io``'s
    ``samples``, ``lanes`` and ``cam``); each phase writes a bounce's next
    state over its state; its last nodes add the wave's radiance, summed
    over its samples, into ``io["sum"]`` and its rays into ``io["rays"]``.
    The bounce index ``b``, the live count, the rays and whether the next
    bounce re-sorts are device scalars the parts write, so no part reads the
    device on the host.  Returns the (radiance, rays) tensors the program
    writes."""
    s = wave.primary_rays(io["samples"], io["lanes"], io["cam"], width, height, repack,
                          pixel_order)
    n = s["active"].shape[0]
    dev = s["active"].device
    b = torch.zeros((), dtype=torch.int32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    live = s["active"].sum()
    sort_next = torch.zeros((), dtype=torch.int64, device=dev)  # 0 on a phase's first bounce

    def phase(st, live_floor):
        """WHILE b <= max_depth and more than ``live_floor`` lanes live: the
        re-sort from the phase's second bounce on, then a bounce."""
        def bounce():
            if repack:
                cap.if_(graphs.Cond(sort_next),
                        lambda: graphs._copy_state(st, _sort_wavefront(tables, st)))
            out, _ = _bounce(tables, st, b, max_depth, nee_weighting, rays)
            graphs._copy_state(st, out)
            b.add_(1)
            live.copy_(st["active"].sum())
            if repack:
                sort_next.fill_(1)

        if repack:
            sort_next.zero_()
        cap.while_(graphs.Cond(live, live_floor, b, max_depth), bounce, "phase")

    ladder = repack and n % 4 == 0
    phase(s, n // 2 if ladder else 0)
    states = [s]
    for width, live_floor in ((n // 2, n // 4), (n // 4, 0)) if ladder else ():
        wide = states[-1]
        # the re-sort where the eager loop steps down (bounces remain, a lane
        # lives); the split is a copy either way, and joins back unchanged
        cap.if_(graphs.Cond(live, 0, b, max_depth),
                lambda: graphs._copy_state(wide, _sort_wavefront(tables, wide)))
        part = _split(wide, width)[0]
        head = graphs._state_like(part, trace.permute(
            graphs._leaves(part), mode="copy",
            out=[torch.empty_like(c) for c in graphs._leaves(part)]))
        states.append(head)
        phase(head, live_floor)
    for wide, head in reversed(list(zip(states, states[1:]))):
        graphs._copy_state(_split(wide, head["active"].shape[0])[0], head)
    radiance = _lane_radiance(tables, s, repack)
    _add_wave(io["sum"], io["rays"], radiance, rays, io["samples"].shape[0])
    return radiance, rays


def _lane_radiance(tables, s: dict, repack: bool):
    """:func:`_radiance` in the lanes' own order (integrator.py:1136-1137)."""
    value = _radiance(tables, s)
    if repack:
        value = torch.empty_like(value).index_copy_(0, s["slot"], value)
    return value
