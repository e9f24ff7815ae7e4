"""Parity of the torch port's elementwise ops with the JAX package.

Every input is made once with numpy from a fixed seed and fed to both
packages.  Integers and RNG state must be bit-equal; floats agree within the
tolerance stated at each test (float32 transcendentals of XLA and PyTorch
differ in the last ulp or two).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_raytracer_tpu.ops import bsdf as jbsdf
from vulkan_raytracer_tpu.ops import math3 as jm3
from vulkan_raytracer_tpu.ops import rng as jrng
from vulkan_raytracer_tpu.ops import spectral as jspec
from vulkan_raytracer_tpu.ops import texture as jtex
from vulkan_raytracer_tpu.ops import tonemap as jtone
from vulkan_raytracer_tpu_torch.ops import bsdf as tbsdf
from vulkan_raytracer_tpu_torch.ops import math3 as tm3
from vulkan_raytracer_tpu_torch.ops import rng as trng
from vulkan_raytracer_tpu_torch.ops import spectral as tspec
from vulkan_raytracer_tpu_torch.ops import texture as ttex
from vulkan_raytracer_tpu_torch.ops import tonemap as ttone

N = 4096
RTOL_ELEMWISE = 1e-6


def _u32(seed=0, n=N):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _bits(x):
    """uint32 values from either package as int64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.uint32).astype(np.int64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(a):
    """The same numpy array as a jax array and a torch tensor."""
    return jnp.asarray(a), torch.as_tensor(np.array(a))


def _v3pair(a):
    """(N, 3) numpy -> (jax V3, torch V3)."""
    j = jm3.V3(*(jnp.asarray(a[:, k]) for k in range(3)))
    t = tm3.V3(*(torch.as_tensor(a[:, k].copy()) for k in range(3)))
    return j, t


def _close_v3(jv, tv, rtol, atol=0.0):
    for jc, tc in zip(jv, tv):
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=rtol, atol=atol)


def _unit(rng, n=N, upper=False):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if upper:
        d[:, 2] = np.abs(d[:, 2]) + 1e-3
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# rng: bit-equal on 4096 random uint32 pairs
# ---------------------------------------------------------------------------


def test_rng_tea_bit_equal():
    a, b = _u32(1), _u32(2)
    np.testing.assert_array_equal(
        _bits(trng.tea(torch.as_tensor(a.astype(np.int64)), torch.as_tensor(b.astype(np.int64)))),
        _bits(jrng.tea(a, b)),
    )
    # scalar second operand (the per-sample count) as the renderer passes it
    np.testing.assert_array_equal(
        _bits(trng.tea(torch.as_tensor(a.astype(np.int64)), 7)), _bits(jrng.tea(a, 7))
    )


@pytest.mark.parametrize("draw", ["lcg", "rnd", "rnd_square", "rnd_cube"])
def test_rng_draws_bit_equal(draw):
    s = _u32(3)
    got = getattr(trng, draw)(torch.as_tensor(s.astype(np.int64)))
    want = getattr(jrng, draw)(jnp.asarray(s))
    np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))
    gv, wv = got[0], want[0]
    if draw == "lcg":
        np.testing.assert_array_equal(_bits(gv), _bits(wv))
        return
    gv = gv if isinstance(gv, tuple) else (gv,)
    wv = wv if isinstance(wv, tuple) else (wv,)
    for g, w in zip(gv, wv):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_rng_int_bit_equal():
    r = np.random.default_rng(4)
    s = _u32(5)
    lo = r.integers(0, 50, N).astype(np.int32)
    hi = lo + r.integers(-1, 40, N).astype(np.int32)  # includes empty ranges
    got_v, got_s = trng.rnd_int(torch.as_tensor(s.astype(np.int64)), torch.as_tensor(lo),
                                torch.as_tensor(hi))
    want_v, want_s = jrng.rnd_int(jnp.asarray(s), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(_bits(got_s), _bits(want_s))


@pytest.mark.parametrize("sampler", ["sample_uniform_hemisphere", "sample_cosine_hemisphere"])
def test_rng_hemisphere_samplers(sampler):
    s = _u32(6)
    (gx, gy, gz), gs = getattr(trng, sampler)(torch.as_tensor(s.astype(np.int64)))
    (wx, wy, wz), ws = getattr(jrng, sampler)(jnp.asarray(s))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    for g, w in ((gx, wx), (gy, wy), (gz, wz)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# math3, spectral, tonemap, sample_equirect: rtol 1e-6
# ---------------------------------------------------------------------------


def test_math3_vector_ops():
    r = np.random.default_rng(7)
    a = r.normal(size=(N, 3)).astype(np.float32)
    b = r.normal(size=(N, 3)).astype(np.float32)
    ja, ta = _v3pair(a)
    jb, tb = _v3pair(b)
    _close_v3(ja.cross(jb), ta.cross(tb), RTOL_ELEMWISE, 1e-7)
    np.testing.assert_allclose(_np(ta.dot(tb)), np.asarray(ja.dot(jb)), rtol=RTOL_ELEMWISE,
                               atol=1e-6)
    _close_v3(ja.normalized(), ta.normalized(), RTOL_ELEMWISE)
    _close_v3(ja * 2.5 - jb / 3.0, ta * 2.5 - tb / 3.0, RTOL_ELEMWISE, 1e-7)
    n = _unit(r)
    jn, tn = _v3pair(n)
    for jx, tx in zip(jm3.v3_onb(jn), tm3.v3_onb(tn)):
        _close_v3(jx, tx, RTOL_ELEMWISE, 1e-7)
    jt, jbt = jm3.v3_onb(jn)
    tt, tbt = tm3.v3_onb(tn)
    _close_v3(jm3.v3_to_tangent(ja, jt, jbt, jn), tm3.v3_to_tangent(ta, tt, tbt, tn),
              RTOL_ELEMWISE, 1e-6)
    _close_v3(jm3.v3_from_tangent(ja, jt, jbt, jn), tm3.v3_from_tangent(ta, tt, tbt, tn),
              RTOL_ELEMWISE, 1e-6)
    _close_v3(jm3.v3_reflect(ja, jn), tm3.v3_reflect(ta, tn), RTOL_ELEMWISE, 1e-6)
    eta = r.uniform(0.4, 2.0, N).astype(np.float32)
    je, te = _pair(eta)
    _close_v3(jm3.v3_refract(jn, jb.normalized(), je), tm3.v3_refract(tn, tb.normalized(), te),
              1e-5, 1e-6)


def test_math3_gather():
    r = np.random.default_rng(8)
    a = r.normal(size=(50, 3)).astype(np.float32)
    idx = r.integers(0, 50, N).astype(np.int32)
    ja, ta = _v3pair(a)
    _close_v3(jm3.v3_gather(ja, jnp.asarray(idx)), tm3.v3_gather(ta, torch.as_tensor(idx)), 0.0)


def test_spectral_1931():
    wl = np.random.default_rng(9).uniform(380.0, 720.0, N).astype(np.float32)
    jw, tw = _pair(wl)
    np.testing.assert_allclose(tspec.spectral_colour_1931(tw).numpy(),
                               np.asarray(jspec.spectral_colour_1931(jw)),
                               rtol=RTOL_ELEMWISE, atol=1e-6)


def test_tonemap():
    v = np.random.default_rng(10).exponential(1.0, (N, 3)).astype(np.float32)
    jv, tv = _pair(v)
    np.testing.assert_allclose(ttone.reinhard_jodie(tv).numpy(),
                               np.asarray(jtone.reinhard_jodie(jv)), rtol=RTOL_ELEMWISE)
    np.testing.assert_allclose(ttone.luminance(tv).numpy(), np.asarray(jtone.luminance(jv)),
                               rtol=RTOL_ELEMWISE)


def test_hable():
    """Hable's filmic curve on 4,096 values in [0, 16]: rtol 1e-6, and atol
    1e-7 near x = 0, where the curve is a difference of two ~0.067 terms.  XLA
    may contract the polynomials into FMAs where PyTorch rounds each op, so
    bit-equality is not assumed (it held on torch 2.13 CPU / XLA CPU)."""
    x = np.random.default_rng(40).uniform(0.0, 16.0, N).astype(np.float32)
    jx, tx = _pair(x)
    got = ttone.hable(tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jtone.hable(jx)), rtol=RTOL_ELEMWISE,
                               atol=1e-7)


def test_sample_equirect():
    """Bilinear equirect lookup.  atan2/asin of the two frameworks differ in
    the last ulp, which moves the texel coordinate x = u*w - 0.5 by ~1e-6
    texels; on this smooth map that changes the result by < 2e-7 relative
    (a map with random texel jumps of ~4 would see ~2e-6)."""
    r = np.random.default_rng(11)
    h, w = 8, 16
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    env = np.stack([1.0 + 0.5 * xx, 2.0 + 0.3 * yy, 1.5 + 0.2 * xx * yy], -1).astype(np.float32)
    d = _unit(r)
    got = ttex.sample_equirect(ttex.pack_envmap(env, "cpu"), torch.as_tensor(d))
    want = jtex.sample_equirect(jtex.pack_envmap(env), jnp.asarray(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_ELEMWISE)


# ---------------------------------------------------------------------------
# bsdf: seeds bit-equal, floats rtol 1e-5 / atol 1e-6
# ---------------------------------------------------------------------------

#: Lanes allowed outside rtol 1e-5 / atol 1e-6.  XLA's and PyTorch's float32
#: sqrt/rsqrt/sin/cos differ in the last ulp on 1-30% of inputs, and the
#: refraction Jacobian (eta*H.V + H.L)^2 and refract's sqrt(k) near the
#: critical angle amplify that ulp to ~3e-5 on a handful of the 4096 lanes
#: (at most 5 seen).  Those lanes are still held to 10x the tolerance.
BSDF_RTOL, BSDF_ATOL, BSDF_MAX_LOOSE_LANES = 1e-5, 1e-6, 8


def _close_bsdf(got, want):
    got, want = _np(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=10 * BSDF_RTOL, atol=10 * BSDF_ATOL)
    loose = np.abs(got - want) > BSDF_ATOL + BSDF_RTOL * np.abs(want)
    assert loose.sum() <= BSDF_MAX_LOOSE_LANES, f"{loose.sum()} lanes outside rtol 1e-5"


def _random_hits(seed=12, n=N):
    """Random HitInfo (both packages) spanning metallic, rough, transmissive,
    thin, dispersive and anisotropic materials."""
    r = np.random.default_rng(seed)
    f = np.float32

    def pick(*choices):
        k = r.integers(0, len(choices), n)
        return np.select([k == i for i in range(len(choices))], choices).astype(f)

    rough = pick(r.uniform(0.0, 1.0, n), np.full(n, 0.05), np.full(n, 1.0))
    aniso_s = pick(np.zeros(n), r.uniform(0.0, 1.0, n))
    aniso_r = r.uniform(-np.pi, np.pi, n).astype(f)
    alpha_c = np.maximum(rough * rough, f(0.001))
    cols = dict(
        metallic=pick(np.zeros(n), np.ones(n), r.uniform(0, 1, n)),
        alpha_x=(alpha_c + (1 - alpha_c) * aniso_s * aniso_s).astype(f),
        alpha_y=alpha_c,
        ad_x=np.cos(aniso_r).astype(f),
        ad_y=np.sin(aniso_r).astype(f),
        transmission=pick(np.zeros(n), np.ones(n), r.uniform(0, 1, n)),
        ior=r.uniform(1.0, 2.4, n).astype(f),
        dispersion=pick(np.zeros(n), np.full(n, 0.2)),
    )
    thin = r.random(n) < 0.5
    front = r.random(n) < 0.7
    t = r.uniform(0.01, 3.0, n).astype(f)
    base = r.uniform(0, 1, (n, 3)).astype(f)
    atten = r.uniform(0, 2, (n, 3)).astype(f)
    zeros = np.zeros((n, 3), f)

    def build(m3, mod, to):
        V = m3.V3
        vec = lambda a: V(*(to(a[:, k].copy()) for k in range(3)))  # noqa: E731
        mat = mod.HitMaterial(
            base_colour=vec(base), emissive=vec(zeros), attenuation=vec(atten),
            thin=to(thin), **{k: to(v) for k, v in cols.items()},
        )
        return mod.HitInfo(pos=vec(zeros), normal=vec(zeros), tangent=vec(zeros),
                           bitangent=vec(zeros), t=to(t), front_face=to(front), mat=mat)

    wl = pick(np.zeros(n), r.uniform(400, 700, n))
    jhit = build(jm3, jbsdf, jnp.asarray)
    thit = build(tm3, tbsdf, lambda a: torch.as_tensor(np.array(a)))
    return jhit, thit, _pair(wl)


def test_bsdf_material_pdf_and_bsdf():
    jhit, thit, (jwl, twl) = _random_hits()
    r = np.random.default_rng(13)
    jv, tv = _v3pair(_unit(r, upper=True))
    jl, tl = _v3pair(_unit(r))
    _close_bsdf(tbsdf.material_pdf(thit, tv, tl), jbsdf.material_pdf(jhit, jv, jl))
    for g, w in zip(tbsdf.material_bsdf(thit, twl, tv, tl), jbsdf.material_bsdf(jhit, jwl, jv, jl)):
        _close_bsdf(g, w)


def test_bsdf_sample_material():
    jhit, thit, (jwl, twl) = _random_hits(14)
    r = np.random.default_rng(15)
    jv, tv = _v3pair(_unit(r, upper=True))
    s = _u32(16)
    got = tbsdf.sample_material(torch.as_tensor(s.astype(np.int64)), thit, twl, tv)
    want = jbsdf.sample_material(jnp.asarray(s), jhit, jwl, jv)
    np.testing.assert_array_equal(_bits(got[5]), _bits(want[5]))  # seeds
    for k in (0, 1, 3):  # direction, estimator, base colour
        for g, w in zip(got[k], want[k]):
            _close_bsdf(g, w)
    _close_bsdf(got[2], want[2])  # pdf
    _close_bsdf(got[4], want[4])  # wavelength
    # the sampler really exercised every lobe
    d = got[0]
    assert bool((d.z < 0).any()) and bool((d.z > 0).any()) and bool((got[2] == 0).any())
