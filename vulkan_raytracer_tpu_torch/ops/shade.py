"""The bounce's shading: three hand-written CUDA kernels between the
traversal launches of one bounce.

The JAX package runs its bounce body (render/integrator.py:961-1046) under
``jax.jit``, and XLA fuses the shading between the Pallas calls into a few
kernels: the hit's attributes (``eval_hit`` :450-628), the light sample
(``sample_lights`` :803-892) and the BSDF (ops/bsdf.py ``material_pdf`` :285,
``material_bsdf`` :322, ``sample_material`` :378).  Here that shading is
three kernels, hand-written for Hopper (``csrc/shade.cu``), one thread a lane:

* :func:`shade_hit` (``shade_hit_kernel``): ``eval_hit`` and the bounce's
  masks (terminal, the emissive MIS probe's mask) and its deferred sky
  weight -> a :class:`HitState`;
* :func:`shade_scatter` (``shade_scatter_kernel``): the emissive hit's MIS
  weight and value, the material sample and the next ray, then
  ``sample_lights`` up to the shadow ray -> the next state's fields and a
  :class:`LightSample`;
* :func:`shade_resolve` (``shade_resolve_kernel``): the rest of
  ``sample_lights`` (occlusion, the pdf select, MIS with ``material_pdf``,
  the contribution), the NEE term of the value, and the bounce's ray count
  added into the wave's 0-d int64 counter with integer atomics.

Between them a lane's hit goes through device memory as a struct-of-arrays
record: the :class:`HitState` fields, rows of one float32 and one bool block
(the light sample likewise).  The kernels take one pointer per column
(:data:`SLOTS`) and a few counts (:data:`INTS`), the names of the enums of
``csrc/shade.cu``; the bounce index ``b`` by a device pointer inside a
captured program, so no kernel reads it on the host.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
:data:`LAUNCHES`, and runs its plain version (``*_reference``) for CPU
tensors; on the card nothing falls back.  The plain versions are the port's
torch code regrouped, not rewritten: :func:`eval_hit`, the BSDF of
:mod:`.bsdf`, :func:`_sample_analytic`, :func:`_sample_emissive` and
:func:`_balance` keep their bodies, so the eager bounce on the CPU is
bit-equal to the unsplit one (``render/integrator.py`` keeps
``sample_lights`` as the unsplit composition, which the tests hold the
split against).  Tests and tools reach a plain version on the card by
patching this module's wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _ext, rng
from .bsdf import HitInfo, HitMaterial, material_bsdf, material_pdf, sample_material
from .instanced import apply_normal_matrix
from .math3 import BIAS, INF, V3, v3_from_tangent, v3_gather, v3_onb, v3_to_tangent
from .texture import sample_bilinear

_F32 = torch.float32

#: Kernel launches since the last reset, by kernel.  Only a launch adds one.
LAUNCHES = {"hit": 0, "scatter": 0, "resolve": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class HitState:
    """What :func:`shade_hit` hands the rest of the bounce: the hit, whether
    the path ends here (``terminal``), which lanes probe the emissive pdf
    for the hit's MIS weight (``probe_mask``), and the deferred sky weight
    after this bounce (``sky_w``)."""

    hit: HitInfo
    terminal: torch.Tensor
    probe_mask: torch.Tensor
    sky_w: V3


@dataclasses.dataclass(frozen=True)
class LightSample:
    """``sample_lights`` up to its shadow ray: the ray (``ray_o``,
    ``light_dir``, ``t_max``, traced where ``trace_mask``), the light's
    ``radiance`` and ``pdf`` (the analytic pick's; the emissive pdf comes
    from the probe), ``bsdf`` at the light, the view and light directions in
    tangent space, the strategy (``pick``: analytic, a delta light) and
    ``vis_pre``, the lanes the emissive probe takes where nothing occludes
    them."""

    ray_o: V3
    light_dir: V3
    t_max: torch.Tensor
    radiance: V3
    bsdf: V3
    pdf: torch.Tensor
    tview: V3
    tlight: V3
    trace_mask: torch.Tensor
    pick: torch.Tensor
    vis_pre: torch.Tensor


# ---------------------------------------------------------------------------
# Hit shading state (hit.rchit:31-117)
# ---------------------------------------------------------------------------


def _uv_at(uv_rows, w0, w1, w2):
    """(N, 2) texture coordinates of barycentric weights (w0, w1, w2) over
    (N, 6) [u0 v0 u1 v1 u2 v2] rows."""
    return torch.stack([
        w0 * uv_rows[:, 0] + w1 * uv_rows[:, 2] + w2 * uv_rows[:, 4],
        w0 * uv_rows[:, 1] + w1 * uv_rows[:, 3] + w2 * uv_rows[:, 5],
    ], dim=-1)


def eval_hit(tables, origin: V3, direction: V3, t, tri, u, v) -> HitInfo:
    """Build HitInfo for every lane (integrator.py:450-628): the shading
    frame, normal mapping and the six texture slots.  Miss lanes get
    t = -INF and a black emissive: the skybox is fetched once after the
    bounce loop (the JAX ``sky=False`` form).

    On an instanced scene ``tri`` is the encoded instance x prototype id:
    attributes are gathered per prototype triangle, and the object-space
    normal and tangent go to world space by the hit instance's
    inverse-transpose rotation (hit.rchit:57-60)."""
    miss = tri < 0
    ti = torch.clamp_min(tri, 0)
    inst_i = None
    if tables.inst is not None:
        ti, inst_i = tables.inst.decode(ti)
    w0 = 1.0 - u - v

    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    pos = origin + direction * t_safe

    def interp(a: V3, b: V3, c: V3) -> V3:
        return v3_gather(a, ti) * w0 + v3_gather(b, ti) * u + v3_gather(c, ti) * v

    normal = interp(tables.n0, tables.n1, tables.n2)
    if inst_i is not None:
        normal = apply_normal_matrix(tables.inst, inst_i, normal)
    normal = normal.normalized()
    mat_i = torch.index_select(tables.tri_mat, 0, ti)
    m = tables.materials

    # tangent frame (hit.rchit:61-71): built from the pre-flip normal
    tg_raw = interp(tables.tg0, tables.tg1, tables.tg2)
    if inst_i is not None:
        tg_raw = apply_normal_matrix(tables.inst, inst_i, tg_raw)
    has_tg = tg_raw.any_nonzero()
    sign = torch.index_select(tables.tg_sign, 0, ti)
    tg_n = tg_raw.normalized()

    shading_normal = normal
    if tables.has_textures:
        tex_idx = torch.index_select(m.tex_idx, 0, mat_i)  # (N, 6)
        uv = _uv_at(torch.index_select(tables.uv, 0, ti), w0, u, v)
        # normal mapping from slot 2, where a tangent exists (hit.rchit:64-66)
        has_nm = (tex_idx[:, 2] >= 0) & has_tg
        bt0 = normal.cross(tg_n) * sign
        texel = sample_bilinear(tables.tex, tex_idx[:, 2], uv)
        nmap = V3(texel[:, 0] * 2.0 - 1.0, texel[:, 1] * 2.0 - 1.0,
                  texel[:, 2] * 2.0 - 1.0).normalized()
        mapped = (tg_n * nmap.x + bt0 * nmap.y + normal * nmap.z).normalized()
        shading_normal = mapped.where(has_nm, normal)

    # the tangent re-orthogonalised against the (possibly mapped) normal
    tg_ortho = (tg_n - shading_normal * shading_normal.dot(tg_n)).normalized()
    bt_ortho = shading_normal.cross(tg_ortho) * sign
    onb_t, onb_b = v3_onb(shading_normal)
    tangent = tg_ortho.where(has_tg, onb_t)
    bitangent = bt_ortho.where(has_tg, onb_b)

    view = -direction
    front = shading_normal.dot(view) >= 0.0
    shading_normal = shading_normal.where(front, -shading_normal)

    def mcol(c):
        return torch.index_select(c, 0, mat_i)

    base = v3_gather(m.base_colour, mat_i)
    emissive = v3_gather(m.emissive_v, mat_i)
    transmission = mcol(m.transmission)
    metallic = mcol(m.metallic)
    rough = mcol(m.roughness)
    aniso_s = mcol(m.aniso_strength)
    aniso_r = mcol(m.aniso_rotation)

    if tables.has_textures:  # material slots (hit.rchit:75-108)
        def sample(slot):
            return sample_bilinear(tables.tex, tex_idx[:, slot], uv)

        tb = sample(0)
        base = (base * V3(tb[:, 0], tb[:, 1], tb[:, 2])).where(tex_idx[:, 0] >= 0, base)
        te = sample(3)
        emissive = (emissive * V3(te[:, 0], te[:, 1], te[:, 2])).where(tex_idx[:, 3] >= 0,
                                                                       emissive)
        transmission = torch.where(tex_idx[:, 4] >= 0, transmission * sample(4)[:, 0],
                                   transmission)
        has_mr = tex_idx[:, 1] >= 0  # roughness from G, metallic from B
        mr = sample(1)
        metallic = torch.where(has_mr, metallic * mr[:, 2], metallic)
        rough = torch.where(has_mr, rough * mr[:, 1], rough)
        has_an = tex_idx[:, 5] >= 0  # direction in R,G; strength in B
        an = sample(5)
        aniso_r = torch.where(has_an, aniso_r + torch.atan2(an[:, 1], an[:, 0]), aniso_r)
        aniso_s = torch.where(has_an, aniso_s * an[:, 2], aniso_s)

    alpha_c = torch.clamp_min(rough * rough, 0.001)  # hit.rchit:94-95
    alpha_x = alpha_c + (1.0 - alpha_c) * (aniso_s * aniso_s)  # mix (hit.rchit:112)

    mat = HitMaterial(
        base_colour=base,
        emissive=emissive.where(~miss, 0.0),
        metallic=metallic,
        alpha_x=alpha_x,
        alpha_y=alpha_c,
        ad_x=torch.cos(aniso_r),
        ad_y=torch.sin(aniso_r),
        transmission=transmission,
        ior=mcol(m.ior),
        thin=mcol(m.thin),
        attenuation=v3_gather(m.attenuation, mat_i),
        dispersion=mcol(m.dispersion),
    )
    return HitInfo(
        pos=pos,
        normal=shading_normal,
        tangent=tangent,
        bitangent=bitangent,
        t=torch.where(miss, -INF, t),
        front_face=front,
        mat=mat,
    )


# ---------------------------------------------------------------------------
# Next-event estimation (shaders/lightsample.glsl)
# ---------------------------------------------------------------------------


def _balance(p1, p2):
    """Balance heuristic (shaders/sampling.glsl:8-10)."""
    return p1 / torch.clamp_min(p1 + p2, 1e-30)


def _offset_origin(hit: HitInfo, light_dir: V3) -> V3:
    off = torch.where(hit.normal.dot(light_dir) >= 0.0, BIAS, -BIAS)
    return hit.pos + hit.normal * off


def _sample_analytic(tables, hit, seed, mask):
    """50/50 point-vs-directional pick (lightsample.glsl:14-52;
    integrator.py:646-713); the shadow ray is traced by the caller.

    Returns (radiance V3, light_dir V3, pdf, t_max, seed).
    """
    np_, nd = tables.num_point, tables.num_directional
    p_factor = 1.0 / ((np_ > 0) + (nd > 0))
    n = hit.t.shape[0]
    dev = hit.t.device

    pick_point = torch.zeros(n, dtype=torch.bool, device=dev)
    if np_ > 0:
        u, seed_a = rng.rnd(seed)
        seed = torch.where(mask, seed_a, seed)  # draw iff numPoint>0 (:17)
        pick_point = (u < 0.5) | (nd == 0)

    idx, seed_i = rng.rnd_int(
        seed,
        torch.where(pick_point, 0, np_),
        torch.where(pick_point, max(np_ - 1, 0), np_ + nd - 1),
    )
    seed = torch.where(mask, seed_i, seed)

    # point branch
    pi = torch.clamp(idx, 0, max(np_ - 1, 0))
    l_pos = v3_gather(tables.pl_pos, pi)
    ray = l_pos - hit.pos
    dist = torch.sqrt(torch.clamp_min(ray.length_sq(), 1e-30))
    dir_p = ray / dist
    l_range = torch.index_select(tables.pl_range, 0, pi)
    att = torch.where(
        l_range == 0.0,
        1.0,
        torch.clamp_min(1.0 - (dist / torch.clamp_min(l_range, 1e-20)) ** 4, 0.0),
    )
    att = torch.clamp_max(att / (dist * dist), 1.0)
    rad_p = v3_gather(tables.pl_colour, pi) * (
        torch.index_select(tables.pl_intensity, 0, pi) * att)
    pdf_p = torch.full((n,), p_factor / max(np_, 1), dtype=_F32, device=dev)

    # directional branch
    di = torch.clamp(idx - np_, 0, max(nd - 1, 0))
    dir_d = -v3_gather(tables.dl_dir, di)
    rad_d = v3_gather(tables.dl_colour, di) * torch.index_select(tables.dl_intensity, 0, di)
    pdf_d = torch.full((n,), p_factor / max(nd, 1), dtype=_F32, device=dev)

    light_dir = dir_p.where(pick_point, dir_d)
    radiance = rad_p.where(pick_point, rad_d)
    pdf = torch.where(pick_point, pdf_p, pdf_d)
    t_max = torch.where(pick_point, dist, INF)
    return radiance, light_dir, pdf, t_max, seed


def _sample_emissive(tables, hit, seed, mask):
    """Emissive-triangle NEE sampling (lightsample.glsl:54-141;
    integrator.py:716-800): CDF search, a uniform point on the triangle and
    the emissive-texture radiance there.  The verification trace and the pdf
    probe are the caller's.

    Returns (radiance V3, light_dir V3, t_max, seed).
    """
    u_cdf, seed_c = rng.rnd(seed)
    seed = torch.where(mask, seed_c, seed)
    tri_e = torch.clamp(
        torch.searchsorted(tables.em_cdf, u_cdf, right=False),
        0,
        tables.num_emissive_tris - 1,
    )

    (ux, uy), seed_uv = rng.rnd_square(seed)
    seed = torch.where(mask, seed_uv, seed)
    fold = ux + uy > 1.0  # parallelogram fold (lightsample.glsl:116-119)
    ux = torch.where(fold, 1.0 - ux, ux)
    uy = torch.where(fold, 1.0 - uy, uy)

    v0 = v3_gather(tables.em_v0, tri_e)
    v1 = v3_gather(tables.em_v1, tri_e)
    v2 = v3_gather(tables.em_v2, tri_e)
    point = v0 * ux + v1 * uy + v2 * (1.0 - ux - uy)

    ray = point - hit.pos
    dist = torch.sqrt(torch.clamp_min(ray.length_sq(), 1e-30))
    light_dir = ray / dist

    # Verification ray bound: "the closest hit is the sampled triangle" is
    # "no hit strictly closer than the sampled point" (integrator.py:758-767)
    t_max = dist * (1.0 - 1e-4) - 1e-5

    em_mat = torch.index_select(tables.em_mat, 0, tri_e)
    radiance = v3_gather(tables.materials.emissive_v, em_mat)
    if tables.has_textures:
        # emissive.rchit:39-41 modulates by the emissive texture at the
        # verify hit, which is the sampled point: barycentrics (ux, uy,
        # 1-ux-uy).  A black texel zeroes the radiance, so the lane is not
        # `visible` below.
        tex_e = torch.index_select(tables.materials.tex_idx[:, 3], 0, em_mat)
        uv_hit = _uv_at(torch.index_select(tables.em_uv, 0, tri_e), ux, uy, 1.0 - ux - uy)
        te = sample_bilinear(tables.tex, tex_e, uv_hit)
        radiance = (radiance * V3(te[:, 0], te[:, 1], te[:, 2])).where(tex_e >= 0, radiance)
    return radiance, light_dir, t_max, seed


def light_sample(tables, hit, wavelength, view_world: V3, seed, mask):
    """``sample_lights`` up to its shadow ray (lightsample.glsl:143-160;
    integrator.py:803-865): the strategy pick between analytic and emissive
    NEE, the sample, the BSDF at the light and the trace mask (NdotL /
    black-light pruning on alpha-free scenes).  Returns (LightSample, seed),
    (None, seed) on a scene without lights."""
    has_analytic = tables.num_point + tables.num_directional > 0
    has_emissive = tables.num_emissive_tris > 0
    if not has_analytic and not has_emissive:
        return None, seed
    n = hit.t.shape[0]
    dev = hit.t.device

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

    if has_analytic:
        rad_a, dir_a, pdf_a, tmax_a, seed = _sample_analytic(
            tables, hit, seed, mask & pick_analytic
        )
        radiance = rad_a.where(pick_analytic, radiance)
        light_dir = dir_a.where(pick_analytic, light_dir)
        pdf = torch.where(pick_analytic, pdf_a, pdf)
        t_max = torch.where(pick_analytic, tmax_a, t_max)
    if has_emissive:
        rad_e, dir_e, tmax_e, seed = _sample_emissive(tables, hit, seed, mask & ~pick_analytic)
        radiance = radiance.where(pick_analytic, rad_e)
        light_dir = light_dir.where(pick_analytic, dir_e)
        t_max = torch.where(pick_analytic, t_max, tmax_e)

    # NdotL / black-light pruning (integrator.py:848-865): a lane whose NEE
    # contribution is zero whatever the occlusion traces nothing.  Not on
    # alpha scenes: their occlusion query draws per-lane RNG (BLEND), and
    # pruning would desync the streams from the JAX run.
    tview = v3_to_tangent(view_world, hit.tangent, hit.bitangent, hit.normal)
    tlight = v3_to_tangent(light_dir, hit.tangent, hit.bitangent, hit.normal)
    bsdf_val = material_bsdf(hit, wavelength, tview, tlight)
    trace_mask = mask
    if not tables.has_alpha:
        trace_mask = mask & radiance.any_nonzero() & bsdf_val.any_nonzero()

    # ONE occlusion launch for both branches (lightsample.glsl:45, :131)
    ray_o = _offset_origin(hit, light_dir)
    # the emissive pdf probe's lanes where nothing occludes them: ``visible``
    # of sample_lights is vis_pre & ~occluded
    vis_pre = trace_mask & ~pick_analytic & radiance.any_nonzero()
    return LightSample(ray_o=ray_o, light_dir=light_dir, t_max=t_max, radiance=radiance,
                       bsdf=bsdf_val, pdf=pdf, tview=tview, tlight=tlight,
                       trace_mask=trace_mask, pick=pick_analytic, vis_pre=vis_pre), seed


def light_resolve(tables, hit, ls: LightSample, occluded, visible, pdf_e, mask) -> V3:
    """The rest of ``sample_lights`` (lightsample.glsl:161-173;
    integrator.py:866-892): occlusion, the pdf select, balance-heuristic MIS
    for area lights (delta lights exempt) and the contribution."""
    has_analytic = tables.num_point + tables.num_directional > 0
    has_emissive = tables.num_emissive_tris > 0
    radiance = ls.radiance.where(~occluded & ls.trace_mask, 0.0)
    pdf = ls.pdf
    if has_emissive:
        pdf = torch.where(ls.pick, pdf, pdf_e)
        radiance = radiance.where(ls.pick | visible, 0.0)

    got_light = radiance.any_nonzero() & mask
    pdf = pdf / float(max(1, int(has_analytic) + int(has_emissive)))  # :161
    mis = torch.where(ls.pick, 1.0, _balance(pdf, material_pdf(hit, ls.tview, ls.tlight)))
    scale = mis * torch.abs(hit.normal.dot(ls.light_dir)) / torch.clamp_min(pdf, 1e-30)
    return (radiance * ls.bsdf * scale).where(got_light & ls.bsdf.any_nonzero(), 0.0)


# ---------------------------------------------------------------------------
# The plain versions of the three kernels
# ---------------------------------------------------------------------------


def shade_hit_reference(tables, s: dict, b, max_depth: int, t, tri, u, v) -> HitState:
    """Plain version of ``shade_hit_kernel``: :func:`eval_hit` at the closest
    hit (t, tri, u, v) of the wave state ``s``, and the bounce's masks
    (raygen.rgen:58-73).  ``b`` is an int or an int32 device scalar."""
    hit = eval_hit(tables, s["origin"], s["direction"], t, tri, u, v)
    active = s["active"]
    miss = tri < 0
    is_emissive = hit.mat.emissive.any_nonzero()
    terminal = miss | is_emissive | (b == max_depth) | (s["preview"] & (b == 1))

    # deferred skybox (skybox.rmiss): record the throughput at the miss;
    # the miss direction survives in the final state
    sky_w = s["sky_w"] + s["throughput"].where(active & miss, 0.0)

    # emissive MIS probe (raygen.rgen:67-73); miss lanes keep weight 1
    probe_mask = active & terminal & is_emissive & ~miss & (b != 0)
    return HitState(hit=hit, terminal=terminal, probe_mask=probe_mask, sky_w=sky_w)


def shade_scatter_reference(tables, s: dict, hs: HitState, pdf_probe, seed):
    """Plain version of ``shade_scatter_kernel``: the emissive hit's value,
    the material sample at the hit (raygen.rgen:79-84) and the next ray, then
    :func:`light_sample` for the surviving lanes (raygen.rgen:54-56).
    ``pdf_probe`` is the emissive pdf of the hit's probe, ``seed`` the seeds
    after the closest-hit query.  Returns (the next state's fields but
    ``sky_w``, with the value before its NEE term, LightSample or None)."""
    hit = hs.hit
    active, origin, direction = s["active"], s["origin"], s["direction"]
    throughput, mat_pdf, wavelength = s["throughput"], s["mat_pdf"], s["wavelength"]

    weight = torch.where(hs.probe_mask, _balance(mat_pdf, pdf_probe), 1.0)
    value = s["value"] + (throughput * hit.mat.emissive * weight).where(active & hs.terminal,
                                                                        0.0)
    cont = active & ~hs.terminal

    view = -direction
    tview = v3_to_tangent(view, hit.tangent, hit.bitangent, hit.normal)
    d_t, est, pdf_m, _, wl_new, seed_m = sample_material(seed, hit, wavelength, tview)
    seed = torch.where(cont, seed_m, seed)
    wavelength = torch.where(cont, wl_new, wavelength)
    new_dir = v3_from_tangent(d_t, hit.tangent, hit.bitangent, hit.normal)
    throughput_next = (throughput * est).where(cont, throughput)
    alive = cont & throughput_next.any_nonzero()  # raygen.rgen:84

    off = torch.where(hit.normal.dot(new_dir) >= 0.0, BIAS, -BIAS)
    new_origin = hit.pos + hit.normal * off

    ls, seed = light_sample(tables, hit, wavelength, view, seed, alive)
    state = dict(origin=new_origin.where(cont, origin), direction=new_dir.where(cont, direction),
                 value=value, throughput=throughput_next, seed=seed, wavelength=wavelength,
                 mat_pdf=torch.where(cont, pdf_m, mat_pdf), active=alive)
    return state, ls


def shade_resolve_reference(tables, s: dict, hs: HitState, st: dict, ls, occluded, visible,
                            pdf_e, nee_weighting: str, rays):
    """Plain version of ``shade_resolve_kernel``: :func:`light_resolve` for
    the lanes ``st["active"]`` (``occluded`` by the shadow query, ``visible``
    and ``pdf_e`` from the emissive probe; None without lights or emissive
    triangles), the NEE term of the value, weighted by the throughput after
    the hit ("reference") or before it ("physical").  Adds the bounce's rays
    (material, NEE and emissive probes) into the 0-d int64 ``rays``.
    Returns the value."""
    alive = st["active"]
    n = alive.shape[0]
    nee_rays = 0
    if ls is None:
        light = V3.full((0.0, 0.0, 0.0), n, alive.device)
    else:
        light = light_resolve(tables, hs.hit, ls, occluded, visible, pdf_e, alive)
        if tables.num_point + tables.num_directional > 0:
            nee_rays = nee_rays + (alive & ls.pick).sum()
        if tables.num_emissive_tris > 0:
            nee_rays = nee_rays + (alive & ~ls.pick).sum() + visible.sum()
    nee_throughput = st["throughput"] if nee_weighting == "reference" else s["throughput"]
    rays.add_(s["active"].sum() + hs.probe_mask.sum() + nee_rays)
    return st["value"] + (nee_throughput * light).where(alive, 0.0)


# ---------------------------------------------------------------------------
# The kernels' columns
# ---------------------------------------------------------------------------


def _xyz(name: str) -> tuple:
    return tuple(name + c for c in "XYZ")


#: One pointer per column, in the order of ``enum Slot`` in csrc/shade.cu.
SLOTS = (
    # the wave state
    "S_ACTIVE", "S_PREVIEW", *_xyz("S_O"), *_xyz("S_D"), *_xyz("S_VAL"), *_xyz("S_TP"),
    *_xyz("S_SKY"), "S_WL", "S_MATPDF", "S_SEED",
    # the closest hit
    "C_T", "C_TRI", "C_U", "C_V",
    # the hit record
    *_xyz("R_POS"), *_xyz("R_N"), *_xyz("R_T"), *_xyz("R_B"), "R_T", *_xyz("R_BASE"),
    *_xyz("R_EM"), "R_METALLIC", "R_AX", "R_AY", "R_ADX", "R_ADY", "R_TRANS", "R_IOR",
    *_xyz("R_ATT"), "R_DISP", "R_FRONT", "R_THIN", "R_TERMINAL", "R_PROBE", *_xyz("R_SKY"),
    # the scatter's other inputs
    "X_PDF_PROBE", "X_SEED",
    # the next state
    *_xyz("O_O"), *_xyz("O_D"), *_xyz("O_VAL"), *_xyz("O_TP"), "O_WL", "O_MATPDF", "O_SEED",
    "O_ACTIVE",
    # the light sample
    *_xyz("L_RO"), *_xyz("L_LD"), "L_TMAX", *_xyz("L_RAD"), *_xyz("L_BSDF"), "L_PDF",
    *_xyz("L_TV"), *_xyz("L_TL"), "L_TRACE", "L_PICK", "L_VISPRE",
    # the resolve's other inputs and outputs
    "Z_OCCLUDED", "Z_VISIBLE", "Z_PDF_E", *_xyz("Z_VAL"), "Z_RAYS",
    "B_DEV",
    # the scene's tables
    *_xyz("T_N0"), *_xyz("T_N1"), *_xyz("T_N2"), *_xyz("T_TG0"), *_xyz("T_TG1"), *_xyz("T_TG2"),
    "T_TGSIGN", "T_UV", "T_TRIMAT",
    *_xyz("M_BASE"), *_xyz("M_EM"), "M_METALLIC", "M_ROUGH", "M_TRANS", "M_THIN",
    *_xyz("M_ATT"), "M_IOR", "M_ANISOS", "M_ANISOR", "M_DISP", "M_TEXIDX",
    "TEX_TEXELS", "TEX_OFF", "TEX_H", "TEX_W", "INST_NRM",
    *_xyz("PL_POS"), *_xyz("PL_COL"), "PL_INT", "PL_RANGE",
    *_xyz("DL_DIR"), *_xyz("DL_COL"), "DL_INT",
    "EM_CDF", *_xyz("EM_V0"), *_xyz("EM_V1"), *_xyz("EM_V2"), "EM_UV", "EM_MAT",
)
#: The counts and flags, in the order of ``enum Int`` in csrc/shade.cu.
INTS = ("I_N", "I_B", "I_MAX_DEPTH", "I_NUM_POINT", "I_NUM_DIR", "I_NUM_EM", "I_TEXTURES",
        "I_ALPHA", "I_PROTO_TRIS", "I_NUM_INST", "I_NEE_REFERENCE")
_SLOT = {name: k for k, name in enumerate(SLOTS)}
_INT = {name: k for k, name in enumerate(INTS)}

#: The lane columns each kernel moves (reads or writes, the scene tables'
#: gathers aside) -> the lanes it moves them on: None for every lane, else
#: the name of a mask of :func:`lane_bytes`.  tests/test_torch_shade.py
#: holds the columns against the kernels' source.
_R_MAT = ("R_METALLIC", "R_AX", "R_AY", "R_ADX", "R_ADY", "R_TRANS", "R_IOR", "R_THIN",
          "R_FRONT")
_R_ALL = SLOTS[SLOTS.index("R_POSX"):SLOTS.index("R_SKYZ") + 1]
MOVES = {
    "hit": {**dict.fromkeys(("S_ACTIVE", *_xyz("S_O"), *_xyz("S_D"), *_xyz("S_TP"),
                             *_xyz("S_SKY"), "C_T", "C_TRI", "C_U", "C_V", *_R_ALL)),
            "S_PREVIEW": "preview"},
    "scatter": {**dict.fromkeys(("S_ACTIVE", *_xyz("S_D"), *_xyz("S_VAL"), *_xyz("S_TP"),
                                 "S_WL", "S_MATPDF", *_xyz("R_POS"), *_xyz("R_N"),
                                 *_xyz("R_T"), *_xyz("R_B"), "R_T", *_xyz("R_BASE"),
                                 *_xyz("R_EM"), *_xyz("R_ATT"), "R_DISP", *_R_MAT,
                                 "R_TERMINAL", "R_PROBE", "X_SEED",
                                 *SLOTS[SLOTS.index("O_OX"):SLOTS.index("L_VISPRE") + 1])),
                "X_PDF_PROBE": "probe", **dict.fromkeys(_xyz("S_O"), "stay")},
    "resolve": {**dict.fromkeys(("S_ACTIVE", "R_PROBE", *_xyz("O_VAL"), "O_ACTIVE",
                                 *_xyz("Z_VAL"))),
                **dict.fromkeys(_xyz("O_TP"), "reference"),
                **dict.fromkeys(_xyz("S_TP"), "physical"),
                **dict.fromkeys(("L_PICK", "Z_OCCLUDED", "L_PDF", "Z_VISIBLE", *_xyz("R_N"),
                                 *_xyz("L_LD"), *_xyz("L_BSDF")), "lights"),
                "L_TRACE": "unoccluded", **dict.fromkeys(_xyz("L_RAD"), "lit"),
                **dict.fromkeys(("Z_PDF_E", *_R_MAT, *_xyz("L_TV"), *_xyz("L_TL")), "mis")},
}
#: Each kernel's last launch: (lanes, lane column -> bytes an element).
_LAST = {}


def _nonzero(v: V3) -> torch.Tensor:
    return (v.x != 0) | (v.y != 0) | (v.z != 0)


def _lanes_read(kernel: str, args: tuple, result) -> dict:
    """The masks of :data:`MOVES` for a call of ``kernel`` on ``args``
    that returned ``result``: a lane's bool, or a bool for every lane."""
    if kernel == "hit":  # preview: read unless miss, an emitter or the last bounce
        _, _, b, max_depth, _, tri, _, _ = args
        return {"preview": (tri >= 0) & ~_nonzero(result.hit.mat.emissive)
                & (int(b) != max_depth)}
    if kernel == "scatter":  # the old origin: kept where the path does not go on
        _, s, hs, _, _ = args
        return {"probe": hs.probe_mask, "stay": ~(s["active"] & ~hs.terminal)}
    _, _, _, _, ls, occluded, _, _, nee_weighting, _ = args
    reference = nee_weighting == "reference"
    if ls is None:
        return {**dict.fromkeys(("lights", "unoccluded", "lit", "mis"), False),
                "reference": reference, "physical": not reference}
    return {"reference": reference, "physical": not reference, "lights": True,
            "unoccluded": ~occluded, "lit": ~occluded & ls.trace_mask, "mis": ~ls.pick}


def lane_bytes(kernel: str, args: tuple, result) -> int:
    """The bytes the last launch of ``kernel`` had to move, for its call
    on ``args`` that returned ``result``: each lane column it reads, on the
    lanes it reads it on, and each it writes, once each (the scene tables'
    gathers aside).  Its bytes bound's numerator."""
    n, itemsize = _LAST[kernel]
    masks = _lanes_read(kernel, args, result)
    total = 0
    for slot, mask in MOVES[kernel].items():
        if slot not in itemsize:  # not passed: no lights, or no emissive triangles
            continue
        m = True if mask is None else masks[mask]
        lanes = int(m.sum()) if isinstance(m, torch.Tensor) else n * bool(m)
        total += lanes * itemsize[slot]
    return total


#: Rows of the hit record's float32 block and bool block (HitState).
_HIT_FLOATS = 33
_HIT_FLAGS = 4
#: Rows of the scatter's blocks: the next state, the light sample.
_STATE_FLOATS = 14
_LIGHT_FLOATS = 20


class _Launch(_ext.Columns):
    """A shading kernel's launch (:class:`_ext.Columns` over :data:`SLOTS`
    and :data:`INTS`), keeping each lane column's bytes an element for
    :func:`lane_bytes`."""

    def __init__(self, lanes: torch.Tensor):
        super().__init__(_SLOT, _INT, lanes.shape[0], lanes.device, "shade")
        self.itemsize = {}  # lane column -> bytes an element

    def lane(self, name: str, t, dtype=_F32) -> None:
        super().lane(name, t, dtype)
        self.itemsize[name] = t.element_size()

    def table(self, name: str, t, dtype=_F32) -> None:
        self.put(name, t, dtype)

    def table3(self, name: str, v: V3) -> None:
        for slot, c in zip(_xyz(name), v):
            self.table(slot, c)

    def run(self, kernel: str) -> None:
        self.launch(f"shade_{kernel}_launch")
        LAUNCHES[kernel] += 1
        _LAST[kernel] = (self.n, self.itemsize)


def _on_cuda(tables, lanes) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises if the tables
    lie elsewhere than the lanes."""
    if tables.device != lanes.device:
        raise ValueError(f"shade inputs span devices {tables.device} and {lanes.device}")
    if lanes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the shading runs on cpu or cuda tensors, not {lanes.device}")
    return lanes.device.type == "cuda"


def _state(k: _Launch, s: dict) -> None:
    """Pass the wave state's columns (all but the seed, which the scatter
    takes after the trace)."""
    for name, f in (("S_O", "origin"), ("S_D", "direction"), ("S_VAL", "value"),
                    ("S_TP", "throughput"), ("S_SKY", "sky_w")):
        k.lane3(name, s[f])
    k.lane("S_ACTIVE", s["active"], torch.bool)
    k.lane("S_PREVIEW", s["preview"], torch.bool)
    k.lane("S_WL", s["wavelength"])
    k.lane("S_MATPDF", s["mat_pdf"])


def _hit_record(k: _Launch, hs: HitState) -> None:
    """Pass the hit record's columns: the hit kernel's outputs, the other
    two kernels' inputs."""
    hit, m = hs.hit, hs.hit.mat
    for name, v in (("R_POS", hit.pos), ("R_N", hit.normal), ("R_T", hit.tangent),
                    ("R_B", hit.bitangent), ("R_BASE", m.base_colour), ("R_EM", m.emissive),
                    ("R_ATT", m.attenuation), ("R_SKY", hs.sky_w)):
        k.lane3(name, v)
    for name, c in (("R_T", hit.t), ("R_METALLIC", m.metallic), ("R_AX", m.alpha_x),
                    ("R_AY", m.alpha_y), ("R_ADX", m.ad_x), ("R_ADY", m.ad_y),
                    ("R_TRANS", m.transmission), ("R_IOR", m.ior), ("R_DISP", m.dispersion)):
        k.lane(name, c)
    for name, c in (("R_FRONT", hit.front_face), ("R_THIN", m.thin), ("R_TERMINAL", hs.terminal),
                    ("R_PROBE", hs.probe_mask)):
        k.lane(name, c, torch.bool)


def _light_record(k: _Launch, ls: LightSample) -> None:
    """Pass the light sample's columns: the scatter's outputs, the
    resolve's inputs."""
    for name, v in (("L_RO", ls.ray_o), ("L_LD", ls.light_dir), ("L_RAD", ls.radiance),
                    ("L_BSDF", ls.bsdf), ("L_TV", ls.tview), ("L_TL", ls.tlight)):
        k.lane3(name, v)
    k.lane("L_TMAX", ls.t_max)
    k.lane("L_PDF", ls.pdf)
    for name, c in (("L_TRACE", ls.trace_mask), ("L_PICK", ls.pick), ("L_VISPRE", ls.vis_pre)):
        k.lane(name, c, torch.bool)


def _scene_counts(k: _Launch, tables) -> None:
    k.count("I_NUM_POINT", tables.num_point)
    k.count("I_NUM_DIR", tables.num_directional)
    k.count("I_NUM_EM", tables.num_emissive_tris)
    k.count("I_TEXTURES", tables.has_textures)
    k.count("I_ALPHA", tables.has_alpha)


def _materials(k: _Launch, tables) -> None:
    m = tables.materials
    k.table3("M_BASE", m.base_colour)
    k.table3("M_EM", m.emissive_v)
    for name, c in (("M_METALLIC", m.metallic), ("M_ROUGH", m.roughness),
                    ("M_TRANS", m.transmission), ("M_IOR", m.ior),
                    ("M_ANISOS", m.aniso_strength), ("M_ANISOR", m.aniso_rotation),
                    ("M_DISP", m.dispersion)):
        k.table(name, c)
    k.table("M_THIN", m.thin, torch.bool)
    k.table3("M_ATT", m.attenuation)
    k.table("M_TEXIDX", m.tex_idx, torch.int32)
    tex = tables.tex
    k.table("TEX_TEXELS", tex.texels, torch.int32)
    for name, c in (("TEX_OFF", tex.off), ("TEX_H", tex.h), ("TEX_W", tex.w)):
        k.table(name, c, torch.int32)


def _bounce_index(k: _Launch, b) -> None:
    if isinstance(b, torch.Tensor):
        k.put("B_DEV", b, torch.int32, ())
    else:
        k.count("I_B", b)


# ---------------------------------------------------------------------------
# The wrappers: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------


def shade_hit(tables, s: dict, b, max_depth: int, t, tri, u, v) -> HitState:
    """The hit's shading state; see :func:`shade_hit_reference`."""
    if not _on_cuda(tables, t):
        return shade_hit_reference(tables, s, b, max_depth, t, tri, u, v)
    k = _Launch(t)
    _state(k, s)
    k.lane("C_T", t)
    k.lane("C_TRI", tri, torch.int32)
    k.lane("C_U", u)
    k.lane("C_V", v)
    _bounce_index(k, b)
    k.count("I_MAX_DEPTH", max_depth)
    _scene_counts(k, tables)
    for name in ("T_N0", "T_N1", "T_N2", "T_TG0", "T_TG1", "T_TG2"):
        k.table3(name, getattr(tables, name[2:].lower()))
    k.table("T_TGSIGN", tables.tg_sign)
    k.table("T_UV", tables.uv)
    k.table("T_TRIMAT", tables.tri_mat, torch.int32)
    _materials(k, tables)
    if tables.inst is not None:
        k.table("INST_NRM", tables.inst.nrm_flat)
        k.count("I_PROTO_TRIS", tables.inst.num_proto_tris)
        k.count("I_NUM_INST", tables.inst.num_instances)

    rec = torch.empty((_HIT_FLOATS, k.n), dtype=_F32, device=k.device).unbind(0)
    flags = torch.empty((_HIT_FLAGS, k.n), dtype=torch.bool, device=k.device).unbind(0)
    hit = HitInfo(
        pos=V3(*rec[0:3]), normal=V3(*rec[3:6]), tangent=V3(*rec[6:9]),
        bitangent=V3(*rec[9:12]), t=rec[12], front_face=flags[0],
        mat=HitMaterial(base_colour=V3(*rec[13:16]), emissive=V3(*rec[16:19]),
                        metallic=rec[19], alpha_x=rec[20], alpha_y=rec[21], ad_x=rec[22],
                        ad_y=rec[23], transmission=rec[24], ior=rec[25], thin=flags[1],
                        attenuation=V3(*rec[26:29]), dispersion=rec[29]))
    hs = HitState(hit=hit, terminal=flags[2], probe_mask=flags[3], sky_w=V3(*rec[30:33]))
    _hit_record(k, hs)
    k.run("hit")
    return hs


def shade_scatter(tables, s: dict, hs: HitState, pdf_probe, seed):
    """The material sample and the light sample; see
    :func:`shade_scatter_reference`."""
    if not _on_cuda(tables, seed):
        return shade_scatter_reference(tables, s, hs, pdf_probe, seed)
    k = _Launch(seed)
    _state(k, s)
    _hit_record(k, hs)
    k.lane("X_PDF_PROBE", pdf_probe)
    k.lane("X_SEED", seed, torch.int64)
    _scene_counts(k, tables)
    _materials(k, tables)

    n, dev = k.n, k.device
    rows = torch.empty((_STATE_FLOATS, n), dtype=_F32, device=dev).unbind(0)
    flags = torch.empty((4, n), dtype=torch.bool, device=dev).unbind(0)
    st = dict(origin=V3(*rows[0:3]), direction=V3(*rows[3:6]), value=V3(*rows[6:9]),
              throughput=V3(*rows[9:12]), seed=torch.empty(n, dtype=torch.int64, device=dev),
              wavelength=rows[12], mat_pdf=rows[13], active=flags[0])
    for name, f in (("O_O", "origin"), ("O_D", "direction"), ("O_VAL", "value"),
                    ("O_TP", "throughput")):
        k.lane3(name, st[f])
    k.lane("O_WL", st["wavelength"])
    k.lane("O_MATPDF", st["mat_pdf"])
    k.lane("O_SEED", st["seed"], torch.int64)
    k.lane("O_ACTIVE", st["active"], torch.bool)

    ls = None
    if tables.num_point + tables.num_directional + tables.num_emissive_tris > 0:
        lr = torch.empty((_LIGHT_FLOATS, n), dtype=_F32, device=dev).unbind(0)
        ls = LightSample(ray_o=V3(*lr[0:3]), light_dir=V3(*lr[3:6]), t_max=lr[6],
                         radiance=V3(*lr[7:10]), bsdf=V3(*lr[10:13]), pdf=lr[13],
                         tview=V3(*lr[14:17]), tlight=V3(*lr[17:20]), trace_mask=flags[1],
                         pick=flags[2], vis_pre=flags[3])
        _light_record(k, ls)
        for name, c in (("PL_INT", tables.pl_intensity), ("PL_RANGE", tables.pl_range),
                        ("DL_INT", tables.dl_intensity), ("EM_CDF", tables.em_cdf),
                        ("EM_UV", tables.em_uv)):
            k.table(name, c)
        for name, v in (("PL_POS", tables.pl_pos), ("PL_COL", tables.pl_colour),
                        ("DL_DIR", tables.dl_dir), ("DL_COL", tables.dl_colour),
                        ("EM_V0", tables.em_v0), ("EM_V1", tables.em_v1),
                        ("EM_V2", tables.em_v2)):
            k.table3(name, v)
        k.table("EM_MAT", tables.em_mat, torch.int32)
    k.run("scatter")
    return st, ls


def shade_resolve(tables, s: dict, hs: HitState, st: dict, ls, occluded, visible, pdf_e,
                  nee_weighting: str, rays):
    """The NEE term and the bounce's rays; see :func:`shade_resolve_reference`."""
    if not _on_cuda(tables, rays):
        return shade_resolve_reference(tables, s, hs, st, ls, occluded, visible, pdf_e,
                                       nee_weighting, rays)
    k = _Launch(st["active"])
    _state(k, s)
    _hit_record(k, hs)
    k.lane3("O_VAL", st["value"])
    k.lane3("O_TP", st["throughput"])
    k.lane("O_ACTIVE", st["active"], torch.bool)
    _scene_counts(k, tables)
    k.count("I_NEE_REFERENCE", nee_weighting == "reference")
    if ls is not None:
        _light_record(k, ls)
        k.lane("Z_OCCLUDED", occluded, torch.bool)
        if visible is not None:
            k.lane("Z_VISIBLE", visible, torch.bool)
            k.lane("Z_PDF_E", pdf_e)
    k.put("Z_RAYS", rays, torch.int64, ())
    value = V3(*torch.empty((3, k.n), dtype=_F32, device=k.device).unbind(0))
    k.lane3("Z_VAL", value)
    k.run("resolve")
    return value
