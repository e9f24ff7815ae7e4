"""Instanced scenes in the torch port against the JAX package.

The instanced upload (``Scene._upload_instanced``) must give the JAX
package's tables bit for bit; the two-level traversal
(``ops/instanced.py``) must find the JAX functions' hits: encoded ids and
occlusion flags bit-equal (an id may differ only at an exact-t tie), t within
rtol 5e-6 (the object-space round trip, see the test), (u, v) within atol 1e-5.  Renders: RMSE < 1e-5 against the JAX
instanced render, < 2e-3 (the BASELINE bar) against the port's own flattened
render.  The scenes are those of tests/test_instancing.py, built on either
package's ``Scene``.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:  # the card's machine has no jax; only the cuda-marked tests run there
    import jax
    import jax.numpy as jnp

    from vulkan_raytracer_tpu.ops import instanced as jinst
    from vulkan_raytracer_tpu.ops.math3 import V3 as JV3
    from vulkan_raytracer_tpu.render.renderer import render_image as jrender_image
    from vulkan_raytracer_tpu.scene import scenegraph as jsg
    from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
except ImportError:
    jax = None
from vulkan_raytracer_tpu_torch.ops import dense as tdense
from vulkan_raytracer_tpu_torch.ops import instanced as tinst
from vulkan_raytracer_tpu_torch.ops.math3 import V3
from vulkan_raytracer_tpu_torch.render.renderer import render_image
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

RMSE_BAR = 2e-3
T_RTOL = 5e-6


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _trs(t=(0, 0, 0), ry=0.0, s=(1, 1, 1)):
    """T * R_y * S, the CLI / glTF composition order (main.cpp:159-165)."""
    c, sn = np.cos(ry), np.sin(ry)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
                 @ np.diag(np.asarray(s, np.float32)))
    m[:3, 3] = t
    return m


def soup_prim(sg, n_tris, material, seed=0, extent=0.35):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.5, 0.5, (n_tris, 1, 3))
    verts = (centers + rng.uniform(-extent, extent, (n_tris, 3, 3))).astype(np.float32)
    pos = verts.reshape(-1, 3)
    n = np.cross(pos[1::3] - pos[0::3], pos[2::3] - pos[0::3])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    nv = pos.shape[0]
    return sg.Primitive(
        positions=pos, normals=np.repeat(n, 3, axis=0).astype(np.float32),
        tangents=np.zeros((nv, 4), np.float32), uvs=np.zeros((nv, 2), np.float32),
        indices=np.arange(nv, dtype=np.uint32), material=material)


def quad_prim(sg, material, half=0.5):
    pos = np.array([[-half, 0, -half], [half, 0, -half], [half, 0, half], [-half, 0, half]],
                   np.float32)
    return sg.Primitive(
        positions=pos, normals=np.tile(np.array([0, -1, 0], np.float32), (4, 1)),
        tangents=np.zeros((4, 4), np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        indices=np.array([0, 2, 1, 0, 3, 2], np.uint32), material=material)


def instanced_scene(sg, n_soup_instances=5, soup_tris=120):
    """A shared soup prototype x N instances, a floor and two emissive panel
    instances (tests/test_instancing.py:73-103)."""
    s = sg.Scene()
    grey = sg.Material()
    grey.metallic_factor = 0.0
    grey.roughness_factor = 0.8
    red = sg.Material()
    red.base_colour_factor = np.array([0.8, 0.25, 0.2, 1.0], np.float32)
    red.metallic_factor = 0.0
    light = sg.Material()
    light.emissive_factor = np.array([12.0, 11.0, 10.0], np.float32)
    light.metallic_factor = 0.0
    s.materials += [grey, red, light]

    s.mesh_pool.append([soup_prim(sg, soup_tris, material=1, seed=3)])
    s.mesh_pool.append([quad_prim(sg, material=2)])  # emissive panel, faces -y
    floor = quad_prim(sg, material=0, half=6.0)  # faces +y at y = -1
    floor.normals = -floor.normals
    floor.indices = floor.indices[::-1].copy()
    s.mesh_pool.append([floor])

    rng = np.random.default_rng(9)
    for i in range(n_soup_instances):
        t = (float(2.2 * (i % 3) - 2.2), 0.0, float(-1.5 * (i // 3)))
        sc = float(rng.uniform(0.6, 1.5))
        s.add_node(s.root, _trs(t, ry=float(rng.uniform(0, 6.28)), s=(sc, sc * 0.7, sc)), mesh=0)
    s.add_node(s.root, _trs((0.0, 2.5, 0.0), s=(2.0, 1.0, 2.0)), mesh=1)
    s.add_node(s.root, _trs((-2.0, 3.0, -1.0), ry=0.7), mesh=1)
    s.add_node(s.root, _trs((0.0, -1.0, 0.0)), mesh=2)
    return s


def _cam(cls=Camera):
    return cls(position=np.array([0.0, 1.2, 5.0]), direction=np.array([0.0, -0.25, -1.0]))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _eq(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


def _eq_v3(got, want):
    for g, w in zip(got, want):
        _eq(g, w)


# ---------------------------------------------------------------------------
# Upload
# ---------------------------------------------------------------------------


def test_instanced_upload_matches_jax():
    """Every field of the port's own instanced upload equals the JAX
    upload's, bit for bit: the instance tables, the prototype columns, the
    emissive CDF rows and their encoded ids, and the emissive BVH."""
    jt = instanced_scene(jsg).upload(instancing=True)
    tt = instanced_scene(tsg).upload("cpu", instancing=True)
    assert tt.inst is not None and tt.bvh is None and tt.pbvh is None
    assert tt.num_triangles == 120 + 2 + 2 and tt.inst.num_instances == 8
    assert (tt.inst.num_instances, tt.inst.num_proto_tris) == (
        jt.inst.num_instances, jt.inst.num_proto_tris)
    assert len(tt.inst.groups) == len(jt.inst.groups) == 3
    for g, jg in zip(tt.inst.groups, jt.inst.groups):
        assert (g.tri_off, g.tri_cnt) == (jg.tri_off, jg.tri_cnt)
        assert g.blas is None and g.pblas is None and jg.blas is None
        assert g.table.shape == (9, g.tri_cnt) and g.table.is_contiguous()
        for name in ("inv", "aabb_min", "aabb_max", "inst_id"):
            _eq(getattr(g, name), getattr(jg, name))
    _eq(tt.inst.inv_flat, jt.inst.inv_flat)
    _eq(tt.inst.nrm_flat, jt.inst.nrm_flat)
    for name in ("v0", "v1", "v2", "n0", "n1", "n2", "tg0", "tg1", "tg2",
                 "em_v0", "em_v1", "em_v2"):
        _eq_v3(getattr(tt, name), getattr(jt, name))
    for name in ("tg_sign", "uv", "tri_mat", "em_cdf", "em_tri", "em_uv", "em_mat"):
        _eq(getattr(tt, name), getattr(jt, name))
    for name in ("p_delta", "area", "n0", "n1", "n2"):
        _eq(getattr(tt.em_tables, name), getattr(jt.em_tables, name))
    for name in ("aabb_min", "aabb_max", "first_tri", "miss", "tri_v0", "tri_e1", "tri_e2",
                 "tri_id"):
        _eq(getattr(tt.ebvh, name), getattr(jt.ebvh, name))
    for name in ("mode", "value", "cutoff"):
        _eq(getattr(tt.alpha, name), getattr(jt.alpha, name))
    assert tt.num_emissive_tris == jt.num_emissive_tris == 4
    # em_tri holds encoded ids: instance * num_proto_tris + prototype triangle
    p = tt.inst.num_proto_tris
    assert tt.em_tri.tolist() == [5 * p + 120, 5 * p + 121, 6 * p + 120, 6 * p + 121]
    # the panel scaled 2x in x and z carries 4x the area share of the other
    share = np.diff(np.concatenate([[0.0], tt.em_cdf.numpy()]))
    assert share[:2].sum() > 2.5 * share[2:].sum()
    # the tables move as a whole
    moved = tt.to("cpu")
    assert moved.inst.groups[0].table.shape == (9, 120)


def test_upload_without_emissive_keeps_the_jax_placeholder_rows():
    """No emissive triangle: both uploads carry the JAX package's single
    placeholder row (triangle 0 when flattened, zeros when instanced)."""
    def scene(sg):
        s = sg.Scene()
        s.materials.append(sg.Material())
        s.mesh_pool.append([soup_prim(sg, 20, material=0, seed=1)])
        for k in range(3):
            s.add_node(s.root, _trs((k, 0.5, 0.0), ry=0.3 * k), mesh=0)
        return s

    for instancing in (False, True):
        jt = scene(jsg).upload(instancing=instancing)
        tt = scene(tsg).upload("cpu", instancing=instancing)
        assert tt.num_emissive_tris == jt.num_emissive_tris == 0
        for name in ("em_v0", "em_v1", "em_v2"):
            _eq_v3(getattr(tt, name), getattr(jt, name))
        for name in ("em_cdf", "em_tri", "em_uv", "em_mat"):
            _eq(getattr(tt, name), getattr(jt, name))
        _eq(tt.ebvh.aabb_min, jt.ebvh.aabb_min)


def test_converted_tables_match_own_upload():
    """``tables_from_numpy`` carries ``inst`` over: the same tables as the
    port's own upload, with each dense prototype's sweep table."""
    jt = _np_tree(instanced_scene(jsg).upload(instancing=True))
    ct = tables_from_numpy(jt, "cpu")
    tt = instanced_scene(tsg).upload("cpu", instancing=True)
    assert ct.bvh is None and ct.pbvh is None
    for g, w in zip(ct.inst.groups, tt.inst.groups):
        assert (g.tri_off, g.tri_cnt) == (w.tri_off, w.tri_cnt)
        for name in ("inv", "aabb_min", "aabb_max", "inst_id", "table"):
            assert torch.equal(getattr(g, name), getattr(w, name))
    assert torch.equal(ct.inst.inv_flat, tt.inst.inv_flat)
    assert torch.equal(ct.inst.nrm_flat, tt.inst.nrm_flat)


def test_instanced_upload_is_o_tris_plus_instances():
    """100 instances of a 2,000-triangle prototype keep 2,000 triangle rows."""
    s = tsg.Scene()
    m = tsg.Material()
    m.metallic_factor = 0.0
    s.materials.append(m)
    s.mesh_pool.append([soup_prim(tsg, 2000, material=0)])
    for i in range(100):
        s.add_node(s.root, _trs((i % 10, 0, i // 10)), mesh=0)
    t = s.upload("cpu", instancing=True)
    assert t.inst is not None
    assert t.num_triangles == 2000  # prototype columns, not 200,000
    assert t.inst.num_instances == 100
    assert len(t.inst.groups) == 1
    assert t.inst.groups[0].inst_id.shape[0] == 100
    assert t.inst.groups[0].table.shape == (9, 2000)
    assert s.upload("cpu", instancing=False).num_triangles == 200_000


def test_auto_policy(monkeypatch):
    """'auto' flattens small scenes; instanced when large AND duplicated;
    VKRT_INSTANCING overrides (tests/test_instancing.py:231-242)."""
    s = instanced_scene(tsg)
    assert not s._should_instance("auto")  # small scene: flatten
    assert s.upload("cpu").inst is None
    monkeypatch.setattr(tsg, "INSTANCE_AUTO_MIN_FLATTENED", 500)
    assert s._should_instance("auto")  # duplication dominates
    assert s.upload("cpu").inst is not None
    monkeypatch.setenv("VKRT_INSTANCING", "0")
    assert not s._should_instance("auto")
    monkeypatch.setenv("VKRT_INSTANCING", "1")
    assert s._should_instance("auto")


def test_instanced_id_overflow_raises():
    """instances x prototype triangles must fit int32."""
    s = tsg.Scene()
    s.materials.append(tsg.Material())
    s.mesh_pool.append([soup_prim(tsg, 40_000, material=0)])
    eye = np.eye(4, dtype=np.float32)
    for _ in range(2**31 // 40_000 + 1):
        s.add_node(s.root, eye, mesh=0)
    with pytest.raises(ValueError, match="overflows int32"):
        s.upload("cpu", instancing=True)


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------


def _shell_rays(n, seed):
    """Rays from a shell around the instance field, aimed inward with jitter
    (tests/test_instancing.py:307-320), with inactive lanes, per-lane t_min
    and finite shadow bounds."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([4.5 * np.cos(ang), rng.uniform(-0.5, 2.5, n), 4.5 * np.sin(ang) - 0.7],
                 axis=1).astype(np.float32)
    d = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.where(rng.random(n) < 0.3, rng.uniform(0.0, 4.0, n), 1e-3).astype(np.float32)
    t_sh = rng.uniform(1.0, 8.0, n).astype(np.float32)
    return o, d, t_min, t_sh, np.arange(n) % 5 != 0


def _both(fn_j, fn_t, jt, tt, o, d, **kw):
    """Call the JAX function and the port's on the same rays; keyword
    arrays go to each as its own array type."""
    jo, jd = (JV3(*(jnp.asarray(a[:, k]) for k in range(3))) for a in (o, d))
    to, td = (V3(*(torch.as_tensor(a[:, k].copy()) for k in range(3))) for a in (o, d))
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return fn_j(jt, jo, jd, **jkw), fn_t(tt, to, td, **tkw)


@pytest.mark.parametrize("kind, n", [("dense", 1024), ("blas", 512), ("treelets", 256)])
def test_instanced_traversal_matches_jax(kind, n, monkeypatch):
    """``instanced_closest`` / ``instanced_shadow`` against the JAX
    functions: dense groups only; the BLAS branch forced by shrinking
    DENSE_MAX_TRIS to 50 (one treelet: the whole-stream walk); the same BLAS
    cut into several treelets (the treelet walk)."""
    if kind != "dense":
        monkeypatch.setattr(jsg, "DENSE_MAX_TRIS", 50)  # the soup prototype has 120
        monkeypatch.setattr(tdense, "DENSE_MAX_TRIS", 50)
        # the JAX side walks its BLAS with the Pallas kernels in interpret
        # mode (the kernels K4'/K5' replace; their Moeller-Trumbore order is
        # the port's), cut into the same treelets
        monkeypatch.setenv("VKRT_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("VKRT_TREELET_TRIS", "32" if kind == "treelets" else "2048")
    jt = instanced_scene(jsg, n_soup_instances=4).upload(instancing=True)
    if kind != "dense":
        assert (jt.inst.groups[0].pblas.n_treelets > 1) == (kind == "treelets")
    tt = tables_from_numpy(_np_tree(jt), "cpu", max_tris=32 if kind == "treelets" else 2048)
    soup = tt.inst.groups[0]
    if kind == "dense":
        assert all(g.pblas is None for g in tt.inst.groups)
    else:
        assert soup.pblas is not None and soup.table is None
        assert (soup.pblas.n_treelets > 1) == (kind == "treelets")
        assert tt.inst.groups[1].pblas is None and tt.inst.groups[1].table is not None
        # the port's own upload builds the same BLAS
        own = instanced_scene(tsg, n_soup_instances=4).upload("cpu", instancing=True)
        assert torch.equal(own.inst.groups[0].blas.tri_id, soup.blas.tri_id)
        assert torch.equal(own.inst.groups[0].blas.aabb_min, soup.blas.aabb_min)

    o, d, t_min, t_sh, act = _shell_rays(n, seed=11)
    tinst.reset_stats()
    (jt_, je, ju, jv), (t_, e, u, v) = _both(
        jinst.instanced_closest, tinst.instanced_closest, jt, tt, o, d,
        t_min=t_min, t_max=1e32, active=act)
    assert tinst.STATS["closest_calls"] == 1 and tinst.STATS["steps"] == 7
    je, e = np.asarray(je), e.numpy()
    hit = je >= 0
    assert hit.any() and (~hit).any() and not hit[~act].any()
    np.testing.assert_array_equal(e >= 0, hit)
    # XLA contracts the affine map into FMAs, so the object-space ray differs
    # in its last ulp and t by a few ulp of |o| (1.6e-6 relative measured)
    np.testing.assert_allclose(t_.numpy()[hit], np.asarray(jt_)[hit], rtol=T_RTOL)
    assert np.isinf(t_.numpy()[~hit]).all() and (e[~hit] == -1).all()
    same = e == je  # an exact-t tie may pick either triangle
    assert same[hit].mean() > 0.999, same[hit].mean()
    np.testing.assert_allclose(u.numpy()[hit & same], np.asarray(ju)[hit & same], atol=1e-5)
    np.testing.assert_allclose(v.numpy()[hit & same], np.asarray(jv)[hit & same], atol=1e-5)
    assert (u.numpy()[~hit] == 0).all() and (v.numpy()[~hit] == 0).all()
    # several instances and several prototypes are hit
    pti, ii = tt.inst.decode(torch.as_tensor(e[hit]))
    assert len(set(ii.tolist())) >= 4 and int(pti.max()) >= 120

    jocc, occ = _both(jinst.instanced_shadow, tinst.instanced_shadow, jt, tt, o, d,
                      t_max=t_sh, active=act)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert occ.any() and not occ[torch.as_tensor(~act)].any()


def test_first_instance_wins_an_exact_tie():
    """Two coincident instances of one quad: every hit reports the first in
    DFS order (the update is ``t_n < t_c``, strict), as in JAX."""
    def scene(sg):
        s = sg.Scene()
        s.materials.append(sg.Material())
        s.mesh_pool.append([quad_prim(sg, material=0, half=2.0)])
        for _ in range(2):
            s.add_node(s.root, _trs((0.1, 0.0, -0.2), ry=0.4), mesh=0)
        return s

    jt = scene(jsg).upload(instancing=True)
    tt = scene(tsg).upload("cpu", instancing=True)
    rng = np.random.default_rng(5)
    n = 256
    o = np.concatenate([rng.uniform(-2.5, 2.5, (n, 1)), np.full((n, 1), 3.0),
                        rng.uniform(-2.5, 2.5, (n, 1))], axis=1).astype(np.float32)
    d = np.tile(np.float32([0.0, -1.0, 0.0]), (n, 1))
    (_, je, _, _), (_, e, _, _) = _both(
        jinst.instanced_closest, tinst.instanced_closest, jt, tt, o, d,
        t_min=1e-4, t_max=1e32, active=np.ones(n, bool))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    hit = e >= 0
    assert hit.sum() > 50
    _, ii = tt.inst.decode(e[hit])
    assert (ii == 0).all()


def test_apply_normal_matrix_matches_jax():
    jt = instanced_scene(jsg).upload(instancing=True)
    tt = instanced_scene(tsg).upload("cpu", instancing=True)
    rng = np.random.default_rng(2)
    ii = rng.integers(0, 8, 500).astype(np.int32)
    vec = rng.normal(size=(500, 3)).astype(np.float32)
    want = jinst.apply_normal_matrix(jt.inst, jnp.asarray(ii),
                                     JV3(*(jnp.asarray(vec[:, k]) for k in range(3))))
    got = tinst.apply_normal_matrix(tt.inst, torch.as_tensor(ii),
                                    V3(*(torch.as_tensor(vec[:, k].copy()) for k in range(3))))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------


def test_instanced_render_matches_flattened_and_jax():
    """32x32, 2 spp, depth 3: the port's instanced render against its own
    flattened render (RMSE < 2e-3: the hit points differ by the object-space
    round trip) and against the JAX instanced render (RMSE < 1e-5)."""
    s = instanced_scene(tsg)
    tf = s.upload("cpu", instancing=False)
    ti = s.upload("cpu", instancing=True)
    assert tf.num_triangles == 5 * 120 + 2 * 2 + 2 and tf.inst is None
    a, rays_a = render_image(tf, _cam(), 32, 32, spp=2, max_depth=3, tonemap=False)
    b, rays_b = render_image(ti, _cam(), 32, 32, spp=2, max_depth=3, tonemap=False)
    assert a.mean() > 1e-3  # lit
    assert _rmse(a, b) < RMSE_BAR, f"instanced vs flattened RMSE {_rmse(a, b)}"
    assert abs(rays_a - rays_b) <= 1e-2 * rays_a
    jt = instanced_scene(jsg).upload(instancing=True)
    c, rays_c = jrender_image(jt, _cam(JCamera), 32, 32, spp=2, max_depth=3, tonemap=False)
    assert _rmse(b, c) < 1e-5, f"port vs JAX instanced RMSE {_rmse(b, c)}"
    assert abs(rays_b - rays_c) <= 1e-3 * rays_c


def test_instanced_blas_render_matches_flattened(monkeypatch):
    """The BLAS branch inside a render (the soup prototype forced onto its
    own BVH streams), against the flattened render."""
    s = instanced_scene(tsg, n_soup_instances=4)
    tf = s.upload("cpu", instancing=False)
    monkeypatch.setattr(tdense, "DENSE_MAX_TRIS", 50)
    ti = s.upload("cpu", instancing=True)
    assert ti.inst.groups[0].pblas is not None and ti.inst.groups[1].pblas is None
    a, _ = render_image(tf, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    b, _ = render_image(ti, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    assert a.mean() > 1e-3
    assert _rmse(a, b) < RMSE_BAR


def alpha_instanced_scene():
    """Two instances of a MASK-textured quad over an instanced backdrop, lit
    by an instanced emissive quad (tests/test_instancing.py:187-228).
    Returns (scene, camera)."""
    s = tsg.Scene()
    back = tsg.Material()
    back.metallic_factor = 0.0
    mask = tsg.Material()
    mask.metallic_factor = 0.0
    mask.alpha_mode = 1
    mask.alpha_cutoff = 0.5
    mask.base_colour_tex = 0
    light = tsg.Material()
    light.emissive_factor = np.array([8.0, 8.0, 8.0], np.float32)
    s.materials += [back, mask, light]
    tex = np.ones((4, 4, 4), np.float32)
    xx, yy = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    tex[..., 3] = np.where((xx + yy) % 2 == 0, 1.0, 0.1)
    s.textures.append(tex)

    def vquad(mat):  # vertical quad facing +z
        p = quad_prim(tsg, mat)
        pos = p.positions.copy()
        pos[:, [1, 2]] = pos[:, [2, 1]]
        p.positions = pos
        p.normals = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
        return p

    s.mesh_pool.append([vquad(1)])  # masked quad prototype
    s.mesh_pool.append([vquad(0)])  # backdrop
    s.mesh_pool.append([quad_prim(tsg, 2)])  # light
    s.add_node(s.root, _trs((0, 0, 0.5)), mesh=0)
    s.add_node(s.root, _trs((0.3, 0, 0.2), s=(1.2, 1.2, 1.0)), mesh=0)
    s.add_node(s.root, _trs((0, 0, -0.5), s=(4, 4, 1)), mesh=1)
    s.add_node(s.root, _trs((0, 2.0, 0.5)), mesh=2)
    return s, Camera(position=np.array([0.0, 0.0, 3.0]), direction=np.array([0.0, 0.0, -1.0]))


def test_instanced_alpha_mask_texture():
    """MASK alpha with a texture through the encoded-id resample loop
    (tests/test_instancing.py:187-228).  The port leaves out the JAX fold's
    MASK prefilter; the alpha loop gives the same image."""
    s, cam = alpha_instanced_scene()
    tf = s.upload("cpu", instancing=False)
    ti = s.upload("cpu", instancing=True)
    assert ti.has_alpha and ti.has_textures and ti.inst is not None
    a, _ = render_image(tf, cam, 32, 32, spp=2, max_depth=3, tonemap=False)
    b, _ = render_image(ti, cam, 32, 32, spp=2, max_depth=3, tonemap=False)
    assert a.mean() > 1e-4
    assert _rmse(a, b) < RMSE_BAR


def host_instances(g):
    """``instanced._instances`` with the transforms and ids as Python numbers,
    read from the device once per group: the path before they were read on
    the device."""
    return zip(g.inv.tolist(), g.inst_id.tolist(), g.aabb_min.unbind(0), g.aabb_max.unbind(0))


def instanced_calls(tables, n=1024, seed=11):
    """``instanced_closest`` and ``instanced_shadow`` on :func:`_shell_rays`
    with per-lane bounds and dead lanes: their five outputs."""
    o, d, t_min, t_sh, act = _shell_rays(n, seed)
    ov, dv = (V3(*(torch.as_tensor(a[:, k].copy()) for k in range(3))) for a in (o, d))
    active = torch.as_tensor(act)
    c = tinst.instanced_closest(tables, ov, dv, t_min=torch.as_tensor(t_min), t_max=1e32,
                                active=active)
    return (*c, tinst.instanced_shadow(tables, ov, dv, t_max=torch.as_tensor(t_sh),
                                       active=active))


@pytest.mark.parametrize("kind", ["dense", "blas", "treelets"])
def test_instance_transforms_on_the_device_bit_equal_to_host_floats(kind, monkeypatch):
    """Each instance step reads its 12 transform values and its id as 0-d
    tensors on the tables' device (so a captured step replays with moved
    instances); float32 products either way, so the hits are those of the
    Python-number path bit for bit: ids, t, (u, v) and occlusion flags."""
    if kind != "dense":
        monkeypatch.setattr(tdense, "DENSE_MAX_TRIS", 50)
    tables = instanced_scene(tsg, n_soup_instances=4).upload("cpu", instancing=True)
    if kind == "treelets":
        from vulkan_raytracer_tpu_torch.ops import traverse as ttr

        soup = tables.inst.groups[0]
        soup = dataclasses.replace(soup, pblas=ttr.build_streams(soup.blas, max_tris=32))
        tables = dataclasses.replace(tables, inst=dataclasses.replace(
            tables.inst, groups=(soup, *tables.inst.groups[1:])))
    assert all((g.pblas is None) == (kind == "dense" or g.tri_cnt <= 50)
               for g in tables.inst.groups)
    got = instanced_calls(tables)
    monkeypatch.setattr(tinst, "_instances", host_instances)
    want = instanced_calls(tables)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] >= 0).sum() > 100 and got[4].any()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "blas", "treelets"])
def test_instanced_traversal_on_the_card(kind, monkeypatch):
    """``instanced_closest`` / ``instanced_shadow`` on ``cuda`` (the kernels)
    against the same calls on ``cpu`` (their plain versions): ids and flags
    bit-equal, t bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from vulkan_raytracer_tpu_torch.ops import traverse as ttr

    if kind != "dense":
        monkeypatch.setattr(tdense, "DENSE_MAX_TRIS", 50)
    cpu = instanced_scene(tsg, n_soup_instances=4).upload("cpu", instancing=True)
    if kind == "treelets":  # cut the soup's BLAS into several treelets
        soup = cpu.inst.groups[0]
        soup = dataclasses.replace(soup, pblas=ttr.build_streams(soup.blas, max_tris=32))
        cpu = dataclasses.replace(cpu, inst=dataclasses.replace(
            cpu.inst, groups=(soup, *cpu.inst.groups[1:])))
    if kind != "dense":
        assert (cpu.inst.groups[0].pblas.n_treelets > 1) == (kind == "treelets")
    gpu = cpu.to("cuda")
    o, d, t_min, t_sh, act = _shell_rays(4096, seed=13)

    def call(tables, dev):
        ov, dv = (V3(*(torch.as_tensor(a[:, k].copy(), device=dev) for k in range(3)))
                  for a in (o, d))
        kw = dict(active=torch.as_tensor(act, device=dev))
        c = tinst.instanced_closest(tables, ov, dv, t_min=torch.as_tensor(t_min, device=dev),
                                    t_max=1e32, **kw)
        s = tinst.instanced_shadow(tables, ov, dv, t_max=torch.as_tensor(t_sh, device=dev), **kw)
        return [x.cpu() for x in (*c, s)]

    before = dict(tdense.LAUNCHES), dict(ttr.LAUNCHES)
    got, want = call(gpu, "cuda"), call(cpu, "cpu")
    assert tdense.LAUNCHES["closest"] > before[0]["closest"]
    assert tdense.LAUNCHES["shadow"] > before[0]["shadow"]
    if kind != "dense":
        key = "treelet" if kind == "treelets" else "bvh"
        assert ttr.LAUNCHES[f"{key}_closest"] > before[1][f"{key}_closest"]
        assert ttr.LAUNCHES[f"{key}_shadow"] > before[1][f"{key}_shadow"]
    assert torch.equal(got[1], want[1]) and torch.equal(got[4], want[4])
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-6)
    assert (got[1] >= 0).any() and got[4].any()
