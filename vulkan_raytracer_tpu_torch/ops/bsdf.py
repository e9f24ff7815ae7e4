"""Cook-Torrance BSDF with bounded Smith-GGX VNDF sampling.

Port of :mod:`vulkan_raytracer_tpu.ops.bsdf` (shaders/bsdf.glsl as
branch-free tensor code over ray wavefronts).  Directions live in tangent
space with the shading normal at +z; GLSL branches become ``torch.where``
selects and every divide is guarded so masked lanes stay finite.

Branch-dependent RNG consumption in :func:`sample_material` follows the
select rule (see :mod:`vulkan_raytracer_tpu_torch.ops.rng`): each lane's
stream advances exactly as a scalar interpreter of
shaders/bsdf.glsl:312-441 would.  The deliberate deviations from the
reference are those of the JAX module (bsdf.py:18-23).
"""

from __future__ import annotations

import dataclasses

import torch

from . import rng
from .math3 import PIINV, TWOPI, V3, v3_reflect, v3_refract
from .spectral import spectral_colour_1931

_TINY = 1e-20


def _safe_div(a, b):
    return a / torch.where(torch.abs(b) < _TINY, torch.where(b < 0, -_TINY, _TINY), b)


@dataclasses.dataclass(frozen=True)
class HitMaterial:
    """Evaluated material at a hit (shaders/hit.glsl:4-14), SoA over lanes."""

    base_colour: V3  # rgb
    emissive: V3  # rgb
    metallic: torch.Tensor  # (N,)
    alpha_x: torch.Tensor  # (N,) roughness^2 (+aniso widening), >= 0.001
    alpha_y: torch.Tensor  # (N,)
    ad_x: torch.Tensor  # (N,) anisotropy direction cos(rot)
    ad_y: torch.Tensor  # (N,) sin(rot)
    transmission: torch.Tensor  # (N,)
    ior: torch.Tensor  # (N,)
    thin: torch.Tensor  # (N,) bool (thicknessFactor == 0)
    attenuation: V3  # Beer-Lambert sigma rgb
    dispersion: torch.Tensor  # (N,)


@dataclasses.dataclass(frozen=True)
class HitInfo:
    """Hit geometry + material (shaders/hit.glsl:16-20), SoA over lanes."""

    pos: V3  # world
    normal: V3  # world shading normal (front-face flipped)
    tangent: V3
    bitangent: V3
    t: torch.Tensor  # (N,) ray t; -INF encodes miss
    front_face: torch.Tensor  # (N,) bool
    mat: HitMaterial


# ---------------------------------------------------------------------------
# Microfacet pieces (shaders/bsdf.glsl:8-110)
# ---------------------------------------------------------------------------


def _aniso2(adx, ady, vx, vy):
    """mat2(anisoDir, anisoDir.yx*(1,-1)) * v (symmetric)."""
    return adx * vx + ady * vy, ady * vx - adx * vy


def diffuse_brdf(colour: V3, l: V3) -> V3:
    """Lambert, zero below the horizon (bsdf.glsl:8-10)."""
    return colour * torch.where(l.z > 0.0, PIINV, 0.0)


def d_ggx(m: HitMaterial, h: V3):
    """Anisotropic GGX NDF (bsdf.glsl:12-22)."""
    alpha_sq = m.alpha_x * m.alpha_y
    ht, hb = _aniso2(m.ad_x, m.ad_y, h.x, h.y)
    f_sq = (m.alpha_y * ht) ** 2 + (m.alpha_x * hb) ** 2 + (alpha_sq * h.z) ** 2
    w_sq = _safe_div(alpha_sq, f_sq)
    return alpha_sq * w_sq * w_sq * PIINV


def _smith_lengths(m: HitMaterial, v: V3, l: V3):
    vt, vb = _aniso2(m.ad_x, m.ad_y, v.x, v.y)
    lt, lb = _aniso2(m.ad_x, m.ad_y, l.x, l.y)
    len_l = torch.sqrt((m.alpha_x * lt) ** 2 + (m.alpha_y * lb) ** 2 + l.z * l.z)
    len_v = torch.sqrt((m.alpha_x * vt) ** 2 + (m.alpha_y * vb) ** 2 + v.z * v.z)
    return len_l, len_v


def visibility(m, v: V3, l: V3):
    """Height-correlated Smith visibility for reflection (bsdf.glsl:24-35)."""
    len_l, len_v = _smith_lengths(m, v, l)
    return _safe_div(torch.ones_like(len_l), 2.0 * (l.z * len_v + v.z * len_l))


def transmission_visibility(m, v: V3, l: V3, h: V3):
    """Thin-transmission visibility (bsdf.glsl:37-56)."""
    valid = (h.dot(v) > 0.0) & (h.dot(l) < 0.0)
    len_l, len_v = _smith_lengths(m, v, l)
    out = _safe_div(torch.ones_like(len_l), 2.0 * (-l.z * len_v + v.z * len_l))
    return torch.where(valid, out, 0.0)


def refraction_visibility(m, eta, v: V3, l: V3, h: V3):
    """Refractive visibility incl. the eta Jacobian (bsdf.glsl:58-80)."""
    hdotl = h.dot(l)
    hdotv = h.dot(v)
    valid = (hdotv > 0.0) & (hdotl < 0.0)
    len_l, len_v = _smith_lengths(m, v, l)
    denom = (eta * hdotv + hdotl) ** 2
    out = _safe_div(2.0 * -hdotl * hdotv, denom * (-l.z * len_v + v.z * len_l))
    return torch.where(valid, out, 0.0)


def specular_brdf(m, v, l, h):
    return visibility(m, v, l) * d_ggx(m, h)


def specular_btdf(m, v, l, h):
    return transmission_visibility(m, v, l, h) * d_ggx(m, h)


def refractive_btdf(m, eta, v, l, h):
    return refraction_visibility(m, eta, v, l, h) * d_ggx(m, h)


def fresnel_schlick(f0, costheta):
    """Schlick with raw costheta (bsdf.glsl:94-96)."""
    p = torch.clamp_min(1.0 - costheta, 0.0) ** 5
    return p * (1.0 - f0) + f0


def fresnel_schlick_vh(f0, v: V3, h: V3):
    """Schlick with |V.H| (bsdf.glsl:102-110); scalar f0."""
    return fresnel_schlick(f0, torch.abs(v.dot(h)))


def fresnel_schlick_vh3(f0: V3, v: V3, h: V3) -> V3:
    """Schlick with |V.H| and rgb f0 (metals, bsdf.glsl:107-110)."""
    p = torch.clamp_min(1.0 - torch.abs(v.dot(h)), 0.0) ** 5
    return V3(p * (1.0 - f0.x) + f0.x, p * (1.0 - f0.y) + f0.y, p * (1.0 - f0.z) + f0.z)


def fresnel_transmission(f0d, eta, vdoth):
    """Three-way transmission Fresnel (bsdf.glsl:358-364 et al.)."""
    sin_sq_out = eta * eta * (1.0 - vdoth * vdoth)
    f_below = fresnel_schlick(f0d, vdoth)
    f_refr = fresnel_schlick(f0d, torch.sqrt(torch.clamp_min(1.0 - sin_sq_out, 0.0)))
    return torch.where(eta <= 1.0, f_below, torch.where(sin_sq_out <= 1.0, f_refr, 1.0))


# ---------------------------------------------------------------------------
# Bounded VNDF sampling + PDFs (bsdf.glsl:112-167; Eto & Tokuyoshi)
# ---------------------------------------------------------------------------


def _bounded_k_raw(m, view: V3):
    """k with s from the RAW view.xy (bsdf.glsl:155-158, sampler variant)."""
    s = 1.0 + torch.sqrt(view.x * view.x + view.y * view.y)
    a = torch.minimum(m.alpha_x, m.alpha_y)
    a_sq, s_sq = a * a, s * s
    return (1.0 - a_sq) * s_sq / (s_sq + a_sq * view.z * view.z)


def _bounded_k_ani(m, ani_x, ani_y, view_z):
    """k with s from the aniso-space view.xy (bsdf.glsl:119-122, pdf variant)."""
    s = 1.0 + torch.sqrt(ani_x * ani_x + ani_y * ani_y)
    a = torch.minimum(m.alpha_x, m.alpha_y)
    a_sq, s_sq = a * a, s * s
    return (1.0 - a_sq) * s_sq / (s_sq + a_sq * view_z * view_z)


def ggx_vndf_reflection_pdf(m, view: V3, halfway: V3):
    """bsdf.glsl:112-124."""
    ndf = d_ggx(m, halfway)
    ax, ay = _aniso2(m.ad_x, m.ad_y, view.x, view.y)
    t = torch.sqrt((m.alpha_x * ax) ** 2 + (m.alpha_y * ay) ** 2 + view.z * view.z)
    k = _bounded_k_ani(m, ax, ay, view.z)
    return _safe_div(ndf, 2.0 * (k * view.z + t))


def ggx_vndf_refraction_pdf(m, eta, view: V3, direction: V3, halfway: V3):
    """bsdf.glsl:126-145."""
    hdotl = halfway.dot(direction)
    hdotv = halfway.dot(view)
    denom = (eta * hdotv + hdotl) ** 2
    jacobian = _safe_div(-hdotl, denom)
    ndf = d_ggx(m, halfway)
    ax, ay = _aniso2(m.ad_x, m.ad_y, view.x, view.y)
    t = torch.sqrt((m.alpha_x * ax) ** 2 + (m.alpha_y * ay) ** 2 + view.z * view.z)
    k = _bounded_k_ani(m, ax, ay, view.z)
    return _safe_div(2.0 * hdotv * ndf, k * view.z + t) * jacobian


def sample_ggx_vndf(seed, m, view: V3):
    """Bounded-VNDF halfway sample (bsdf.glsl:149-167); 2 rnd draws.

    Returns (halfway V3, seed), including the reference's final aniso-space
    map-back.
    """
    view_std = V3(m.alpha_x * view.x, m.alpha_y * view.y, view.z).normalized()
    (ux, uy), seed = rng.rnd_square(seed)
    phi = TWOPI * ux
    k = _bounded_k_raw(m, view)
    b = k * view_std.z
    z = (1.0 - uy) * (1.0 + b) - b
    sin_theta = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    hs = V3(
        view_std.x + sin_theta * torch.cos(phi),
        view_std.y + sin_theta * torch.sin(phi),
        view_std.z + z,
    )
    ani = V3(hs.x * m.alpha_x, hs.y * m.alpha_y, hs.z).normalized()
    hx, hy = _aniso2(m.ad_x, m.ad_y, ani.x, ani.y)
    return V3(hx, hy, ani.z), seed


# ---------------------------------------------------------------------------
# Dispersion (bsdf.glsl:240-246, 330-340)
# ---------------------------------------------------------------------------


def dispersed_ior(ior, dispersion, wavelength):
    """Cauchy-style ior(lambda); identity until the wavelength collapses."""
    wl_sq = torch.clamp_min(wavelength * wavelength, _TINY)
    adjusted = torch.clamp_min(
        ior + (ior - 1.0) * dispersion / 20.0 * (523655.0 / wl_sq - 1.5168), 1.0
    )
    return torch.where((dispersion != 0.0) & (wavelength > 0.0), adjusted, ior)


def _f0_dielectric(ior):
    f = (ior - 1.0) / (ior + 1.0)
    return f * f


def _thin_halfway(v: V3, l: V3) -> V3:
    return V3(v.x + l.x, v.y + l.y, v.z - l.z).normalized()


def _refr_halfway(eta, v: V3, l: V3) -> V3:
    h = (v * eta + l).normalized()
    flip = eta > 1.0
    return h.where(flip, -h)


def _absorption(hit: HitInfo, thin) -> V3:
    """Beer-Lambert interior absorption on backface transmission (:271,:304)."""
    m = hit.mat
    interior = ~thin & ~hit.front_face
    return V3(
        torch.where(interior, torch.exp(-m.attenuation.x * hit.t), 1.0),
        torch.where(interior, torch.exp(-m.attenuation.y * hit.t), 1.0),
        torch.where(interior, torch.exp(-m.attenuation.z * hit.t), 1.0),
    )


# ---------------------------------------------------------------------------
# materialPDF (bsdf.glsl:169-226) — pdf of the BSDF sampler for MIS weights
# ---------------------------------------------------------------------------


def material_pdf(hit: HitInfo, v: V3, l: V3):
    m = hit.mat
    f0d = _f0_dielectric(m.ior)
    p_trans = (1.0 - m.metallic) * m.transmission
    p_diff = 0.5 * (1.0 - m.metallic)
    ndotl = l.z
    eta = torch.where(hit.front_face, 1.0 / m.ior, m.ior)

    # --- NdotL < 0 branch (transmission through the surface) ---
    h_thin = _thin_halfway(v, l)
    f_thin = fresnel_schlick(f0d, v.dot(h_thin))
    pdf_thin = ggx_vndf_reflection_pdf(m, v, h_thin)
    h_refr = _refr_halfway(eta, v, l)
    f_refr = fresnel_transmission(f0d, eta, v.dot(h_refr))
    pdf_refr = ggx_vndf_refraction_pdf(m, eta, v, l, h_refr)
    pdf_neg = p_trans * torch.where(m.thin, (1.0 - f_thin) * pdf_thin, (1.0 - f_refr) * pdf_refr)

    # --- NdotL >= 0 branch (reflection side) ---
    h = (l + v).normalized()
    ggx_pdf = ggx_vndf_reflection_pdf(m, v, h)
    pdf_pos = (1.0 - p_diff) * (1.0 - p_trans) * ggx_pdf + p_diff * ndotl * PIINV
    vdoth = v.dot(h)
    f_t_pos = torch.where(
        m.thin, fresnel_schlick(f0d, vdoth), fresnel_transmission(f0d, eta, vdoth)
    )
    pdf_pos = pdf_pos + torch.where(p_trans > 0.0, p_trans * f_t_pos * ggx_pdf, 0.0)

    return torch.where(ndotl < 0.0, pdf_neg, pdf_pos)


# ---------------------------------------------------------------------------
# materialBSDF (bsdf.glsl:228-310) — NEE evaluation
# ---------------------------------------------------------------------------


def material_bsdf(hit: HitInfo, wavelength, v: V3, l: V3) -> V3:
    m = hit.mat
    ior = dispersed_ior(m.ior, m.dispersion, wavelength)
    f0d = _f0_dielectric(ior)
    p_trans = (1.0 - m.metallic) * m.transmission
    ndotl = l.z
    eta = torch.where(hit.front_face, 1.0 / ior, ior)
    absorb = _absorption(hit, m.thin)

    # --- NdotL < 0: transmission lobe only ---
    h_thin = _thin_halfway(v, l)
    f_thin = fresnel_schlick_vh(f0d, v, h_thin)
    btdf_thin = specular_btdf(m, v, l, h_thin)
    h_refr = _refr_halfway(eta, v, l)
    f_refr = fresnel_transmission(f0d, eta, v.dot(h_refr))
    btdf_refr = refractive_btdf(m, eta, v, l, h_refr)
    f_t_neg = torch.where(m.thin, f_thin, f_refr)
    lobe_neg = torch.where(m.thin, btdf_thin, btdf_refr)
    bsdf_neg = m.base_colour * (p_trans * (1.0 - f_t_neg) * lobe_neg) * absorb

    # --- NdotL > 0: diffuse + specular + transmissive-specular ---
    h = (v + l).normalized()
    f_diel = fresnel_schlick_vh(f0d, v, h)
    f_metal = fresnel_schlick_vh3(m.base_colour, v, h)
    spec = specular_brdf(m, v, l, h)
    diffuse = diffuse_brdf(m.base_colour, l) * (1.0 - m.transmission)
    dielectric = diffuse * (1.0 - f_diel) + spec * f_diel
    metallic_lobe = f_metal * spec
    base = dielectric * (1.0 - m.metallic) + metallic_lobe * m.metallic
    gate_nontrans = torch.where(p_trans < 1.0, 1.0, 0.0)
    vdoth = v.dot(h)
    f_t_pos = torch.where(
        m.thin, fresnel_schlick(f0d, vdoth), fresnel_transmission(f0d, eta, vdoth)
    )
    gate_trans = torch.where(p_trans > 0.0, 1.0, 0.0)
    trans_pos = m.base_colour * (p_trans * f_t_pos * spec * gate_trans) * absorb
    bsdf_pos = base * gate_nontrans + trans_pos

    neg = ndotl < 0.0
    pos = ndotl > 0.0
    out = bsdf_neg.where(neg, bsdf_pos)
    # select (not multiply) so inf/NaN in the untaken branch cannot leak
    return out.where(neg | pos, 0.0)


# ---------------------------------------------------------------------------
# sampleMaterial (bsdf.glsl:312-441) — the lobe-selection importance sampler
# ---------------------------------------------------------------------------


def sample_material(seed, hit: HitInfo, wavelength, view: V3):
    """Sample an outgoing direction + estimator (bsdf/pdf * |NdotL|).

    Returns (direction V3, estimator V3, pdf, base_colour_used V3,
    wavelength, seed); direction/estimator/pdf are zero on rejected lanes
    (the reference's early returns, bsdf.glsl:347,370,375,391).
    """
    m = hit.mat

    # ---- dispersion: collapse wavelength on first dispersive hit ----
    needs_collapse = (m.dispersion != 0.0) & (wavelength == 0.0)
    wl_new, seed_c = rng.rnd_range(seed, 400.0, 700.0)
    wavelength = torch.where(needs_collapse, wl_new, wavelength)
    seed = torch.where(needs_collapse, seed_c, seed)
    tint = V3.from_array(spectral_colour_1931(wavelength))
    base_colour = (m.base_colour * tint).where(needs_collapse, m.base_colour)
    ior = dispersed_ior(m.ior, m.dispersion, wavelength)

    f0d = _f0_dielectric(ior)
    p_trans = (1.0 - m.metallic) * m.transmission
    p_diff = 0.5 * (1.0 - m.metallic)
    eta = torch.where(hit.front_face, 1.0 / ior, ior)

    # ---- lobe selection draw (always consumed, bsdf.glsl:342) ----
    u_lobe, seed = rng.rnd(seed)
    take_trans = u_lobe < p_trans

    # ======== transmission branch (bsdf.glsl:343-380) ========
    h_t, seed_t = sample_ggx_vndf(seed, m, view)

    # thin: reflect, maybe flip z (bsdf.glsl:344-352)
    f_thin = fresnel_schlick_vh(f0d, view, h_t)
    dir_thin_refl = v3_reflect(-view, h_t)
    thin_fail = dir_thin_refl.z < 0.0
    pdf_thin = ggx_vndf_reflection_pdf(m, view, h_t)
    u_flip, seed_t_flip = rng.rnd(seed_t)
    flip = u_flip > f_thin
    dir_thin = V3(
        dir_thin_refl.x, dir_thin_refl.y, torch.where(flip, -dir_thin_refl.z, dir_thin_refl.z)
    )
    seed_thin = torch.where(thin_fail, seed_t, seed_t_flip)

    # volumetric: Fresnel-split reflect/refract (bsdf.glsl:353-377)
    vdoth_t = view.dot(h_t)
    f_vol = fresnel_transmission(f0d, eta, vdoth_t)
    u_frn, seed_vol = rng.rnd(seed_t)
    vol_reflect = u_frn < f_vol
    dir_vol_refl = v3_reflect(-view, h_t)
    dir_vol_refr = v3_refract(-view, h_t, eta)
    dir_vol = dir_vol_refl.where(vol_reflect, dir_vol_refr)
    pdf_vol = torch.where(
        vol_reflect,
        ggx_vndf_reflection_pdf(m, view, h_t),
        ggx_vndf_refraction_pdf(m, eta, view, dir_vol_refr, h_t),
    )
    vol_fail = torch.where(vol_reflect, dir_vol.z < 0.0, dir_vol.z > 0.0)

    thin = m.thin
    dir_trans = dir_thin.where(thin, dir_vol)
    pdf_ggx_trans = torch.where(thin, pdf_thin, pdf_vol)
    fail_trans = torch.where(thin, thin_fail, vol_fail)
    seed_trans = torch.where(thin, seed_thin, seed_vol)
    f_trans_trans = torch.where(thin, f_thin, f_vol)

    # ======== reflection/diffuse branch (bsdf.glsl:381-408) ========
    u_diff, seed_r = rng.rnd(seed)
    is_diff = u_diff < p_diff
    (cx, cy, cz), seed_cos = rng.sample_cosine_hemisphere(seed_r)
    dir_cos = V3(cx, cy, cz)
    h_cos = (view + dir_cos).normalized()
    h_v, seed_vndf = sample_ggx_vndf(seed_r, m, view)
    dir_vndf = v3_reflect(-view, h_v)
    dir_refl = dir_cos.where(is_diff, dir_vndf)
    h_refl = h_cos.where(is_diff, h_v)
    seed_refl = torch.where(is_diff, seed_cos, seed_vndf)
    fail_refl = dir_refl.z < 0.0
    pdf_ggx_refl = ggx_vndf_reflection_pdf(m, view, h_refl)
    vdoth_r = view.dot(h_refl)
    f_trans_refl = torch.where(
        thin | (eta <= 1.0),
        fresnel_schlick(f0d, vdoth_r),
        fresnel_transmission(f0d, eta, vdoth_r),
    )

    # ======== merge branches ========
    direction = dir_trans.where(take_trans, dir_refl)
    halfway = h_t.where(take_trans, h_refl)
    pdf_ggx = torch.where(take_trans, pdf_ggx_trans, pdf_ggx_refl)
    fail = torch.where(take_trans, fail_trans, fail_refl)
    seed = torch.where(take_trans, seed_trans, seed_refl)
    f_trans = torch.where(take_trans, f_trans_trans, f_trans_refl)
    ndotl = direction.z

    f_diel = fresnel_schlick_vh(f0d, view, halfway)
    f_metal = fresnel_schlick_vh3(base_colour, view, halfway)
    absorb = _absorption(hit, thin)

    # ---- NdotL < 0 tail: transmission bsdf/pdf (bsdf.glsl:410-418) ----
    lobe_neg = torch.where(
        thin,
        specular_btdf(m, view, direction, halfway),
        refractive_btdf(m, eta, view, direction, halfway),
    )
    bsdf_neg = base_colour * (p_trans * (1.0 - f_trans) * lobe_neg) * absorb
    pdf_neg = p_trans * (1.0 - f_trans) * pdf_ggx

    # ---- NdotL >= 0 tail (bsdf.glsl:419-437) ----
    spec = specular_brdf(m, view, direction, halfway)
    diffuse = diffuse_brdf(base_colour, direction) * (1.0 - m.transmission)
    dielectric = diffuse * (1.0 - f_diel) + spec * f_diel
    base = dielectric * (1.0 - m.metallic) + f_metal * (spec * m.metallic)
    gate_nt = torch.where(p_trans < 1.0, 1.0, 0.0)
    gate_t = torch.where(p_trans > 0.0, 1.0, 0.0)
    bsdf_pos = base * gate_nt + base_colour * (p_trans * f_trans * spec * gate_t) * absorb
    pdf_pos = (
        ((1.0 - p_diff) * (1.0 - p_trans) * pdf_ggx + p_diff * ndotl * PIINV) * gate_nt
        + p_trans * f_trans * pdf_ggx * gate_t
    )

    neg = ndotl < 0.0
    bsdf = bsdf_neg.where(neg, bsdf_pos)
    pdf = torch.where(neg, pdf_neg, pdf_pos)

    # rejected lanes: direction/estimator/pdf zero (early returns :347,370,375,391)
    ok = ~fail
    direction = direction.where(ok, 0.0)
    zero_bsdf = ~bsdf.any_nonzero() | (pdf <= 0.0)
    est = (bsdf * (_safe_div(torch.ones_like(pdf), pdf) * torch.abs(ndotl))).where(
        ok & ~zero_bsdf, 0.0
    )
    pdf = torch.where(ok, pdf, 0.0)
    return direction, est, pdf, base_colour, wavelength, seed
