"""The alpha resample loop of the torch port against the JAX package.

The scene is ``tests/test_alpha.py``'s stack (a BLEND quad, a MASK quad with
a checker alpha texture, an opaque backdrop), built in both packages from
the same numpy arrays.

* ``_alpha_test``: keep flags and seeds bit-equal (one rnd per BLEND
  candidate; the seed advances on BLEND lanes only).
* ``_closest`` and the alpha branch of ``_shadow_unsorted`` against the JAX
  ``_closest`` / ``_shadow`` on the dense path, and with ``traversal="bvh"``
  against JAX under ``VKRT_FORCE_PACKET=1`` (its Pallas packet kernel in
  interpret mode): triangle ids, occlusion flags and seeds bit-equal, t
  within rtol 1e-6; and against test_alpha.py's scalar t-order oracle
  (ids and seeds bit-equal, t within rtol 1e-4, as that file holds JAX).
* ``sample_lights`` on the alpha scene, with shadow rays that cross the
  BLEND quad from lanes whose light is below their horizon: the NEE prune
  is off on alpha scenes, so the seeds stay bit-equal to JAX's.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_alpha import _np_tables, _oracle
from vulkan_raytracer_tpu.ops.math3 import V3 as JV3
from vulkan_raytracer_tpu.render import integrator as jint
from vulkan_raytracer_tpu_torch.ops.math3 import V3 as TV3
from vulkan_raytracer_tpu_torch.render import integrator as tint

T_RTOL = 1e-6


def _alpha_scene(pkg, with_texture=True, with_blend=True, light=False):
    """test_alpha.py:38's stack in package ``pkg``: BLEND quad (z=0.5, alpha
    0.4), MASK quad (z=0) with a 4x4 checker alpha texture (1.0 / 0.1),
    opaque backdrop (z=-0.5); optionally a point light at z=1."""
    sg = importlib.import_module(f"{pkg}.scene.scenegraph")
    s = sg.Scene()
    blend = sg.Material()
    blend.base_colour_factor = np.array([1, 1, 1, 0.4], np.float32)
    blend.alpha_mode = 2 if with_blend else 0
    blend.metallic_factor = 0.0
    mask = sg.Material()
    mask.alpha_mode = 1
    mask.alpha_cutoff = 0.5
    mask.metallic_factor = 0.0
    if with_texture:
        tex = np.ones((4, 4, 4), np.float32)
        xx, yy = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
        tex[..., 3] = np.where((xx + yy) % 2 == 0, 1.0, 0.1)
        mask.base_colour_tex = len(s.textures)
        s.textures.append(tex)
    back = sg.Material()
    back.base_colour_factor = np.array([0.8, 0.8, 0.8, 1.0], np.float32)
    back.metallic_factor = 0.0
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    for z, m in ((0.5, blend), (0.0, mask), (-0.5, back)):
        pos = np.array([[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]], np.float32)
        s.add_raw_mesh(pos, np.tile(np.float32([0, 0, 1]), (4, 1)),
                       np.array([0, 1, 2, 0, 2, 3], np.uint32), m, uvs=uv)
    if light:
        s.point_lights.append(sg.PointLight(np.float32([0.2, -0.1, 1.0]),
                                            np.float32([1.0, 0.9, 0.8]), 5.0, 0.0))
    return s


def _tables(traversal="auto", **kw):
    """(JAX scene, JAX tables, port scene, port tables)."""
    js, ts = _alpha_scene("vulkan_raytracer_tpu", **kw), _alpha_scene(
        "vulkan_raytracer_tpu_torch", **kw)
    return js, js.upload(), ts, ts.upload("cpu", traversal=traversal)


def _rays(n, seed, both_sides=False):
    """test_alpha.py's rays: origins over the quads at z=2 heading -z, half
    of them tilted; with ``both_sides`` every other ray starts at z=-2
    heading +z.  Returns numpy (o, d) and both packages' V3s."""
    r = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = r.uniform(-0.9, 0.9, n)
    o[:, 1] = r.uniform(-0.9, 0.9, n)
    o[:, 2] = 2.0
    d = np.tile(np.array([0, 0, -1.0], np.float32), (n, 1))
    d[: n // 2, 0] = r.uniform(-0.2, 0.2, n // 2)
    if both_sides:
        o[1::2, 2] = -2.0
        d[1::2, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jv = tuple(JV3(*(jnp.asarray(a[:, k]) for k in range(3))) for a in (o, d))
    tv = tuple(TV3(*(torch.as_tensor(a[:, k].copy()) for k in range(3))) for a in (o, d))
    return (o, d), jv, tv


def _seeds(n, mul, add):
    return (np.arange(n, dtype=np.uint64) * mul + add).astype(np.uint32)


@pytest.fixture
def force_packet():
    """JAX's packet (BVH) path for every scene, its kernel in interpret mode."""
    os.environ["VKRT_PALLAS_INTERPRET"] = "1"
    os.environ["VKRT_FORCE_PACKET"] = "1"
    yield
    os.environ.pop("VKRT_PALLAS_INTERPRET", None)
    os.environ.pop("VKRT_FORCE_PACKET", None)


@pytest.mark.parametrize("with_texture", [True, False])
def test_alpha_test_bit_equal(with_texture):
    _, jt, _, tt = _tables(with_texture=with_texture)
    assert tt.has_alpha and tt.has_blend and tt.has_textures == with_texture
    r = np.random.default_rng(1)
    n = 4096
    tri = r.integers(-1, tt.num_triangles, n).astype(np.int32)
    u = r.random(n).astype(np.float32)
    v = (r.random(n) * (1 - u)).astype(np.float32)
    seed = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    cand = (tri >= 0) & (r.random(n) < 0.9)
    jk, js = jint._alpha_test(jt, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(seed), jnp.asarray(cand))
    tk, ts = tint._alpha_test(tt, torch.as_tensor(tri), torch.as_tensor(u), torch.as_tensor(v),
                              torch.as_tensor(seed.astype(np.int64)), torch.as_tensor(cand))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    blend = cand & (np.asarray(jt.alpha.mode)[np.maximum(tri, 0)] == 2)
    assert (ts.numpy() != seed)[blend].all() and (ts.numpy() == seed)[~blend].all()
    assert 0 < tk.numpy().sum() < cand.sum()  # some candidates ignored, some kept


def _check_closest(jt, tt, scene, n):
    (o, d), (jo, jd), (to, td) = _rays(n, seed=3)
    seeds = _seeds(n, 2654435761, 12345)
    tint.reset_alpha_loop()
    (t, tri, u, v), seed_out = tint._closest(
        tt, to, td, t_min=1e-6, t_max=1e32, active=torch.ones(n, dtype=torch.bool),
        seed=torch.as_tensor(seeds.astype(np.int64)))
    (jtt, jtri, ju, jv), jseed = jint._closest(
        jt, jo, jd, t_min=1e-6, t_max=1e32, active=jnp.ones(n, bool), seed=jnp.asarray(seeds))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    np.testing.assert_array_equal(seed_out.numpy(), np.asarray(jseed).astype(np.int64))
    hit = tri.numpy() >= 0
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jtt)[hit], rtol=T_RTOL)
    assert np.isinf(t.numpy()[~hit]).all()
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)
    # the loop ran more than once, and the counter saw it
    assert tint.ALPHA_LOOP["calls"] == 1 and tint.ALPHA_LOOP["max"] >= 2
    assert tint.ALPHA_LOOP["iterations"] == tint.ALPHA_LOOP["max"]
    tn = _np_tables(scene, tt)
    for i in range(n):
        te, ke, se = _oracle(tn, o[i].astype(np.float64), d[i].astype(np.float64), seeds[i],
                             1e-6, 1e32)
        assert tri[i] == ke, f"lane {i}: tri {int(tri[i])} != oracle {ke}"
        if ke >= 0:
            np.testing.assert_allclose(float(t[i]), te, rtol=1e-4)
        assert int(seed_out[i]) == se, f"lane {i}: seed stream diverged"


def test_closest_matches_jax_and_oracle_dense():
    _, jt, ts, tt = _tables()
    assert tt.pbvh is None
    _check_closest(jt, tt, ts, n=128)


def test_closest_matches_jax_and_oracle_bvh(force_packet):
    """Port on its BVH path (one treelet: the whole-stream walk, K4's plain
    version) against JAX's packet kernel (K4) in interpret mode."""
    _, jt, ts, tt = _tables(traversal="bvh")
    assert tt.pbvh is not None and tt.pbvh.n_treelets == 1
    assert jint._packet_preferred(jt)
    _check_closest(jt, tt, ts, n=64)


def _check_shadow(jt, tt, scene, n):
    (o, d), (jo, jd), (to, td) = _rays(n, seed=9)
    seeds = _seeds(n, 747796405, 1)
    t_max = np.full(n, 2.6, np.float32)  # past the backdrop
    t_max[::4] = 1.75  # between the MASK quad and the backdrop
    active = np.arange(n) % 7 != 3
    occ, seed_out = tint._shadow_unsorted(
        tt, to, td, t_max=torch.as_tensor(t_max), active=torch.as_tensor(active),
        seed=torch.as_tensor(seeds.astype(np.int64)))
    jocc, jseed = jint._shadow(jt, jo, jd, t_max=jnp.asarray(t_max), active=jnp.asarray(active),
                               seed=jnp.asarray(seeds))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(seed_out.numpy(), np.asarray(jseed).astype(np.int64))
    assert not occ.numpy()[~active].any() and (seed_out.numpy() == seeds)[~active].all()
    assert 0 < occ.numpy().sum() < active.sum()
    tn = _np_tables(scene, tt)
    for i in np.flatnonzero(active):
        _, ke, se = _oracle(tn, o[i].astype(np.float64), d[i].astype(np.float64), seeds[i],
                            0.0, float(t_max[i]))
        assert bool(occ[i]) == (ke >= 0), f"lane {i}"
        assert int(seed_out[i]) == se, f"lane {i}: seed stream diverged"


def test_shadow_matches_jax_and_oracle_dense():
    _, jt, ts, tt = _tables()
    _check_shadow(jt, tt, ts, n=96)


def test_shadow_matches_jax_and_oracle_bvh(force_packet):
    _, jt, ts, tt = _tables(traversal="bvh")
    _check_shadow(jt, tt, ts, n=64)


def test_mask_only_scene_draws_no_rng():
    """MASK alpha is deterministic: no seed moves, repeated calls agree.  The
    rays start past the front quad (opaque here), at t_min 1.6."""
    _, _, _, tt = _tables(with_blend=False)
    assert tt.has_alpha and not tt.has_blend
    n = 64
    _, _, (to, td) = _rays(n, seed=5)
    seeds = torch.arange(n, dtype=torch.int64)
    kw = dict(t_min=1.6, t_max=1e32, active=torch.ones(n, dtype=torch.bool), seed=seeds)
    (t1, tri1, _, _), s1 = tint._closest(tt, to, td, **kw)
    (t2, tri2, _, _), _ = tint._closest(tt, to, td, **kw)
    assert torch.equal(s1, seeds) and torch.equal(tri1, tri2) and torch.equal(t1, t2)
    mask_tri = (tt.alpha.mode == 1).nonzero().flatten()
    assert bool(torch.isin(tri1, mask_tri).any())  # opaque checker texels stop rays
    assert bool((tri1 >= 4).any())  # the others pass on to the backdrop


def test_sample_lights_without_prune_matches_jax():
    """Hits lit from both sides by a point light at z=1: lanes on the far
    side have the light below their horizon (BSDF 0, pruned on alpha-free
    scenes), and their shadow rays cross the BLEND quad, drawing RNG."""
    _, jt, _, tt = _tables(light=True)
    n = 256
    _, (jo, jd), (to, td) = _rays(n, seed=11, both_sides=True)
    seeds = _seeds(n, 2891336453, 7)
    active = torch.ones(n, dtype=torch.bool)
    (t, tri, u, v), seed = tint._closest(tt, to, td, t_min=1e-6, t_max=1e32, active=active,
                                        seed=torch.as_tensor(seeds.astype(np.int64)))
    jraw, jseed = jint._closest(jt, jo, jd, t_min=1e-6, t_max=1e32, active=jnp.ones(n, bool),
                                seed=jnp.asarray(seeds))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jraw[1]))
    thit = tint.eval_hit(tt, to, td, t, tri, u, v)
    jhit = jint.eval_hit(jt, jo, jd, *jraw, sky=False)
    mask = tri >= 0
    wl = np.zeros(n, np.float32)
    tc, tseed, trays = tint.sample_lights(tt, thit, torch.as_tensor(wl), -td, seed, mask)
    jc, jseed2, jrays = jint.sample_lights(jt, jhit, jnp.asarray(wl), -jd, jseed,
                                           jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(tseed.numpy(), np.asarray(jseed2).astype(np.int64))
    assert int(trays) == int(jrays) > 0
    for g, w in zip(tc, jc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # the lanes behind the backdrop drew for the BLEND quad on their shadow ray
    back = mask.numpy() & (np.arange(n) % 2 == 1) & (tri.numpy() >= 4)
    assert back.any() and (tseed.numpy() != seed.numpy())[back].any()
    assert float(tc.x.sum()) > 0
