"""Texture sampling and the textured shading path of the torch port against
the JAX package.

* ``pack_textures`` / ``unpack_rgba8``: bit-equal, texels with alpha 255
  included (the sign bit of the int32 the port keeps each texel in).
* ``sample_bilinear`` on 4,096 lanes, uv in [-3, 3] (repeat addressing wraps
  both ways), textures of several sizes, lanes with texture -1: bit-equal
  (the test allows atol 1e-6).
* ``eval_hit`` with textures (JAX ``sky=False``) on the camera hits of the
  generated textured .glb, with every texture slot wired: tri ids bit-equal,
  floats within rtol 1e-5 / atol 1e-6 (atan2 and rsqrt of the two frameworks
  differ in the last ulp).
* ``_sample_emissive`` with the emissive texture: seeds bit-equal, floats
  within rtol 1e-5 / atol 1e-6.
* The textured .glb rendered on the dense path and on the BVH path against
  the JAX render and the NumPy oracle: RMSE < 2e-3 (measured ~2e-8), ray
  counts within 0.1%.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_raytracer_tpu.ops import texture as jtex
from vulkan_raytracer_tpu.ops.dense import dense_closest as jdense_closest
from vulkan_raytracer_tpu.render import integrator as jint
from vulkan_raytracer_tpu.render import oracle
from vulkan_raytracer_tpu.render.renderer import camera_uniforms as jcamera_uniforms
from vulkan_raytracer_tpu.render.renderer import render_image as jrender_image
from vulkan_raytracer_tpu.scene import scenegraph as jsg
from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
from vulkan_raytracer_tpu_torch.ops import texture as ttex
from vulkan_raytracer_tpu_torch.ops.dense import dense_closest
from vulkan_raytracer_tpu_torch.render import integrator as tint
from vulkan_raytracer_tpu_torch.render.renderer import camera_uniforms, render_image
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
from vulkan_raytracer_tpu_torch.scene.camera import Camera

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import torch_glb_assets  # noqa: E402

RMSE_BAR = 2e-3
RTOL, ATOL = 1e-5, 1e-6
CAM = ([0.0, 0.0, 2.8], [0.0, 0.0, -1.0])  # tests/test_textured_glb.py:245


def _cam(cls):
    return cls(position=np.array(CAM[0]), direction=np.array(CAM[1]))


def _textures(seed=0):
    """Four RGBA textures of different sizes, channel values on the UNORM8
    grid and alpha 1.0 (255) on a third of the texels."""
    r = np.random.default_rng(seed)
    out = []
    for h, w in ((4, 4), (8, 3), (1, 5), (16, 16)):
        t = r.integers(0, 256, (h, w, 4)).astype(np.float32) / 255.0
        t[..., 3] = np.where(r.random((h, w)) < 1 / 3, 1.0, t[..., 3])
        out.append(t)
    return out


def test_pack_and_unpack_rgba8_bit_equal():
    texs = _textures()
    ja, ta = jtex.pack_textures(texs), ttex.pack_textures(texs, "cpu")
    assert ta.texels.dtype == torch.int32 and ta.texels.element_size() == 4
    want = np.asarray(ja.texels)
    np.testing.assert_array_equal(ta.texels.numpy(), want.view(np.int32))
    assert (want >> 31).any(), "no texel with alpha >= 128 (the int32 sign bit)"
    for name in ("off", "h", "w"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(), np.asarray(getattr(ja, name)))
    # every packed pattern, alpha 255 ones included, unpacks bit for bit
    r = np.random.default_rng(1)
    p = r.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    p[::3] |= np.uint32(0xFF000000)
    for got, w in zip(ttex.unpack_rgba8(torch.as_tensor(p.view(np.int32))),
                      jtex.unpack_rgba8(jnp.asarray(p))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert got.max() == 1.0  # alpha 255 -> 1.0


def test_sample_bilinear_matches_jax():
    """4,096 lanes, uv in [-3, 3], texture ids -1..3: bit-equal measured;
    the bound stated is atol 1e-6."""
    texs = _textures(2)
    ja, ta = jtex.pack_textures(texs), ttex.pack_textures(texs, "cpu")
    r = np.random.default_rng(3)
    n = 4096
    uv = r.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 16) / 16  # on texel edges and centres
    idx = r.integers(-1, len(texs), n).astype(np.int32)
    got = ttex.sample_bilinear(ta, torch.as_tensor(idx), torch.as_tensor(uv)).numpy()
    want = np.asarray(jtex.sample_bilinear(ja, jnp.asarray(idx), jnp.asarray(uv)))
    assert got.shape == (n, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    """(JAX tables, port tables) of the textured glb with every texture slot
    wired: the metallic-roughness, transmission and anisotropy slots the
    container leaves empty are pointed at its textures on two materials."""
    path = torch_glb_assets.write_textured_glb(tmp_path_factory.mktemp("textured"))
    out = []
    for sg in (jsg, tsg):
        s = sg.Scene()
        s.load_model(path)
        for m in (s.materials[0], s.materials[5]):
            m.metallic_roughness_tex, m.transmission_tex, m.anisotropy_tex = 5, 3, 0
            m.anisotropy_strength = 0.5
        out.append(s)
    return out[0].upload(), out[1].upload("cpu")


def _primary_hits(jt, tt, w=48, h=48):
    jcam, cam = _cam(JCamera), _cam(Camera)
    jcam.aspect = cam.aspect = w / h
    jo, jd, js = jint.generate_primary_rays(*jcamera_uniforms(jcam), w, h, 1)
    to, td, ts = tint.generate_primary_rays(*camera_uniforms(cam), w, h, 1, device="cpu")
    jraw = jdense_closest(jt, jo, jd, t_min=1e-7, t_max=1e32, active=jnp.ones(w * h, bool))
    traw = dense_closest(tt, to, td, t_min=1e-7, t_max=1e32,
                         active=torch.ones(w * h, dtype=torch.bool))
    np.testing.assert_array_equal(traw[1].numpy(), np.asarray(jraw[1]))
    return (jo, jd, js, jraw), (to, td, ts, traw)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def test_textured_eval_hit_matches_jax(textured):
    jt, tt = textured
    assert tt.has_textures and tt.num_triangles == 12
    (jo, jd, _, jraw), (to, td, _, traw) = _primary_hits(jt, tt)
    jhit = jint.eval_hit(jt, jo, jd, *jraw, sky=False)
    thit = tint.eval_hit(tt, to, td, *traw)
    hit = traw[1].numpy() >= 0
    mat_i = tt.tri_mat.numpy()[np.maximum(traw[1].numpy(), 0)]
    # every material but the off-screen light is hit
    assert hit.sum() > 1000 and set(mat_i[hit]) == {0, 1, 2, 3, 5}
    for name in ("pos", "normal", "tangent", "bitangent"):
        for k, (g, w) in enumerate(zip(getattr(thit, name), getattr(jhit, name))):
            _close(g.numpy(), w, f"{name}[{k}]")
    _close(thit.t.numpy(), jhit.t, "t")
    np.testing.assert_array_equal(thit.front_face.numpy(), np.asarray(jhit.front_face))
    for name in ("base_colour", "emissive", "attenuation"):
        for k, (g, w) in enumerate(zip(getattr(thit.mat, name), getattr(jhit.mat, name))):
            _close(g.numpy(), w, f"mat.{name}[{k}]")
    for name in ("metallic", "alpha_x", "alpha_y", "ad_x", "ad_y", "transmission", "ior",
                 "thin", "dispersion"):
        _close(getattr(thit.mat, name).numpy(), getattr(jhit.mat, name), f"mat.{name}")
    # the texture slots really moved the material: textured base colours vary
    assert np.unique(thit.mat.base_colour.x.numpy()[hit & (mat_i == 0)]).size > 2
    assert np.unique(thit.mat.ad_x.numpy()[hit & (mat_i == 0)]).size > 2


def test_sample_emissive_textured_matches_jax(textured):
    """NEE sampling of the emissive triangles (the light and the BLEND quad
    whose emissive texture modulates the radiance at the sampled point)."""
    jt, tt = textured
    (jo, jd, js, jraw), (to, td, ts, traw) = _primary_hits(jt, tt)
    jhit = jint.eval_hit(jt, jo, jd, *jraw, sky=False)
    thit = tint.eval_hit(tt, to, td, *traw)
    mask = (traw[1] >= 0) & ~thit.mat.emissive.any_nonzero()
    jrad, jdir, jtmax, jseed = jint._sample_emissive(jt, jhit, js, jnp.asarray(mask.numpy()))
    trad, tdir, ttmax, tseed = tint._sample_emissive(tt, thit, ts, mask)
    np.testing.assert_array_equal(tseed.numpy(), np.asarray(jseed).astype(np.int64))
    for k in range(3):
        _close(trad[k].numpy(), jrad[k], f"radiance[{k}]")
        _close(tdir[k].numpy(), jdir[k], f"light_dir[{k}]")
    _close(ttmax.numpy(), jtmax, "t_max")
    # some lanes sampled the textured BLEND quad: radiance not the flat factor
    assert np.unique(trad.x.numpy()[mask.numpy()]).size > 3


@pytest.mark.parametrize("traversal", ["auto", "bvh"])
def test_textured_glb_render_matches_jax_and_oracle(traversal, textured, tmp_path):
    """The unmodified textured glb, dense and forced onto the BVH path (one
    treelet: the whole-stream walk), against one JAX render and the oracle."""
    path = torch_glb_assets.write_textured_glb(tmp_path)
    s = tsg.Scene()
    s.load_model(path)
    tt = s.upload("cpu", traversal=traversal)
    assert (tt.pbvh is not None) == (traversal == "bvh")
    w = h = 24
    img_t, rays_t = render_image(tt, _cam(Camera), w, h, spp=2, max_depth=3, tonemap=False)
    js = jsg.Scene()
    js.load_model(path)
    img_j, rays_j = jrender_image(js.upload(), _cam(JCamera), w, h, spp=2, max_depth=3,
                                  tonemap=False)
    img_o = oracle.render_image(tt, _cam(Camera), w, h, spp=2, max_depth=3)
    for ref, name in ((img_j, "JAX"), (img_o, "oracle")):
        rmse = float(np.sqrt(np.mean((img_t - np.asarray(ref)) ** 2)))
        assert rmse < RMSE_BAR, f"port vs {name} RMSE {rmse}"
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)
    assert np.isfinite(img_t).all() and img_t.mean() > 1e-3
