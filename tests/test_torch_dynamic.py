"""Dynamic scenes in the torch port: ``refit_bvh`` and ``Scene.refit``.

``refit_bvh`` is NumPy in both packages and must be bit-equal.  A refitted
scene must trace and render like a freshly uploaded one (same triangle ids,
t within rtol 1e-6, images within atol 1e-5: only the boxes differ), and no
kernel table cached on the old tables may survive into the new ones.  The
port's twins of tests/test_dynamic.py and of the refit test of
tests/test_instancing.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_instancing import _cam as _inst_cam
from test_torch_instancing import _rmse, _trs, host_instances, instanced_calls, instanced_scene
from vulkan_raytracer_tpu.accel.bvh import refit_bvh as jrefit_bvh
from vulkan_raytracer_tpu.scene import scenegraph as jsg
from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
from vulkan_raytracer_tpu_torch.accel.bvh import refit_bvh
from vulkan_raytracer_tpu_torch.ops import instanced as tinst
from vulkan_raytracer_tpu_torch.ops import traverse as ttr
from vulkan_raytracer_tpu_torch.ops.math3 import V3
from vulkan_raytracer_tpu_torch.render.renderer import render_image
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.scene.convert import _bvh_from_numpy

BVH_FIELDS = ("aabb_min", "aabb_max", "first_tri", "miss", "tri_v0", "tri_e1", "tri_e2",
              "tri_id")


def _cam():
    return Camera(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))


def _move_node(s, node, dx):
    node.local_transform = node.local_transform.copy()
    node.local_transform[0, 3] += dx
    for n in s.iter_depth_first():
        if n.parent is not None:
            n.world_transform = (n.parent.world_transform @ n.local_transform).astype(np.float32)


def _soup(sg, n_tris, seed):
    """Two soups under the root, so that one can move against the other."""
    r = np.random.default_rng(seed)
    s = sg.Scene()
    for k, n in enumerate((n_tris, n_tris // 3)):
        base = r.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
        offs = r.normal(0.0, 0.1, (n, 2, 3)).astype(np.float32)
        pos = np.concatenate([base, base + offs[:, 0], base + offs[:, 1]], 1).reshape(-1, 3)
        nrm = np.cross(offs[:, 0], offs[:, 1])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        m = sg.Material()
        if k:
            m.emissive_factor = np.full(3, 3.0, np.float32)
        s.add_raw_mesh(pos, np.repeat(nrm, 3, axis=0).astype(np.float32),
                       np.arange(3 * n, dtype=np.uint32), m)
    return s


def _world_tris(tables):
    return tuple(np.stack([c.cpu().numpy() for c in v], 1)
                 for v in (tables.v0, tables.v1, tables.v2))


@pytest.mark.parametrize("scene", ["cornell", "soup"])
def test_refit_bvh_bit_equal_to_jax(scene):
    """The same tree and the same moved vertices through both packages'
    ``refit_bvh``: every field bit-equal; topology and slots untouched."""
    if scene == "cornell":
        js, ts, node = jcornell(), cornell_box_scene(), 5
    else:
        js, ts, node = _soup(jsg, 900, seed=4), _soup(tsg, 900, seed=4), 1
    jt = js.upload()
    bvh = _bvh_from_numpy(jax.tree_util.tree_map(np.asarray, jt.bvh))
    _move_node(ts, ts.root.children[node], 0.4)
    v0, v1, v2 = _world_tris(ts.upload("cpu"))
    assert np.abs(v0 - np.stack([np.asarray(c) for c in jt.v0], 1)).max() > 0.3  # it moved
    want = jrefit_bvh(jt.bvh, v0, v1, v2)
    got = refit_bvh(bvh, v0, v1, v2)
    for name in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.leaf_size == want.leaf_size
    assert not torch.equal(got.tri_v0, bvh.tri_v0)  # the leaf rows are the moved ones
    assert torch.equal(got.tri_id, bvh.tri_id) and torch.equal(got.miss, bvh.miss)
    # every box still holds its subtree's triangles
    slots = got.tri_id.numpy()
    real = slots >= 0
    lo = np.minimum(np.minimum(v0, v1), v2)[slots[real]].min(0)
    np.testing.assert_array_equal(got.aabb_min[0].numpy(), lo)


def _trace(tables, n=256, seed=7):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.8, 0.8, (n, 3)) + [0, 1, 0]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ov, dv = (V3(*(torch.as_tensor(a[:, k].copy()) for k in range(3))) for a in (o, d))
    return ttr.bvh_closest(tables, ov, dv, t_min=1e-4, t_max=1e32,
                           active=torch.ones(n, dtype=torch.bool))


def test_refit_matches_rebuild_traversal_level():
    """Refit and rebuild agree at the traversal level: same hits over a set
    of rays (the twin of tests/test_dynamic.py:94-120), through the BVH
    walks.  The refitted streams equal streams built from the refitted tree
    with the upload's cut, and the JAX refit gives the same tree."""
    s = cornell_box_scene()
    t0 = s.upload("cpu", traversal="bvh")
    _move_node(s, s.root.children[5], 0.4)
    refit = s.refit(t0)
    rebuilt = s.upload("cpu", traversal="bvh")
    assert refit is not t0 and refit.pbvh is not t0.pbvh
    t_r, tri_r, _, _ = _trace(refit)
    t_b, tri_b, _, _ = _trace(rebuilt)
    assert (tri_r >= 0).sum() > 200
    assert torch.equal(tri_r, tri_b)
    np.testing.assert_allclose(t_r.numpy(), t_b.numpy(), rtol=1e-6)
    assert not torch.equal(tri_r, _trace(t0)[1])  # the move shows

    js = jcornell()
    jt0 = js.upload()
    _move_node(js, js.root.children[5], 0.4)
    jrefit = js.refit(jt0)
    for name in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(refit.bvh, name).numpy(),
                                      np.asarray(getattr(jrefit.bvh, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(refit.ebvh, name).numpy(),
                                      np.asarray(getattr(jrefit.ebvh, name)), err_msg=name)
    for name in ("v0", "n1", "tg2", "em_v1"):
        for g, w in zip(getattr(refit, name), getattr(jrefit, name)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_refit_rebuilds_the_streams_with_the_uploads_cut():
    """A multi-treelet scene: the streams after a refit are those built from
    the refitted tree with the same treelet cut, not the old ones."""
    s = _soup(tsg, 3000, seed=8)
    t0 = s.upload("cpu", traversal="bvh")
    t0 = dataclasses.replace(t0, pbvh=ttr.build_streams(t0.bvh, max_tris=256))
    assert t0.pbvh.n_treelets > 8 and t0.pbvh.cut_tris == 256
    _move_node(s, s.root.children[1], 0.5)
    refit = s.refit(t0)
    want = ttr.build_streams(refit.bvh, max_tris=256)
    assert refit.pbvh.n_treelets == t0.pbvh.n_treelets == want.n_treelets
    assert refit.pbvh.cut_tris == 256
    for name in ("nodes", "tris", "tri_id", "tl_box", "tl_group", "tl_lim"):
        got = getattr(refit.pbvh, name)  # by bit pattern: node words hold ints, -1 is a NaN
        assert torch.equal(got.view(torch.int32), getattr(want, name).view(torch.int32)), name
    assert torch.equal(refit.pbvh.tl_lim, t0.pbvh.tl_lim)  # the same treelets
    assert not torch.equal(refit.pbvh.tris, t0.pbvh.tris)
    assert not torch.equal(refit.pbvh.tl_box, t0.pbvh.tl_box)
    # and they trace like a rebuild
    rebuilt = s.upload("cpu", traversal="bvh")
    t_r, tri_r, _, _ = _trace(refit, seed=9)
    t_b, tri_b, _, _ = _trace(rebuilt, seed=9)
    assert torch.equal(tri_r >= 0, tri_b >= 0) and (tri_r >= 0).any()
    np.testing.assert_allclose(t_r.numpy(), t_b.numpy(), rtol=1e-6)


@pytest.mark.parametrize("traversal", ["auto", "bvh"])
def test_refit_image_matches_rebuild_and_drops_the_caches(traversal):
    """Same image as a full rebuild after a transform change (atol 1e-5), on
    the dense sweeps and on the BVH walks; the kernel tables cached on the
    old tables are not carried over, so the image differs from before."""
    s = cornell_box_scene()
    t0 = s.upload("cpu", traversal=traversal)
    before, _ = render_image(t0, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    old = t0.tri_table, t0.em_table, t0.em_stream  # now cached on t0
    _move_node(s, s.root.children[5], 0.4)
    refit = s.refit(t0)
    for name in ("tri_table", "em_table", "em_stream"):
        assert name in vars(t0) and name not in vars(refit)
    assert not torch.equal(refit.tri_table, old[0])
    assert torch.equal(t0.tri_table, old[0])  # the old tables are untouched
    rebuilt = s.upload("cpu", traversal=traversal)
    assert torch.equal(refit.tri_table, rebuilt.tri_table)
    assert torch.equal(refit.em_table, rebuilt.em_table)
    img_r, rays_r = render_image(refit, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    img_b, rays_b = render_image(rebuilt, _cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    np.testing.assert_allclose(img_r, img_b, atol=1e-5)
    assert rays_r == rays_b
    assert np.abs(img_r - before).max() > 1e-4


def test_refit_moves_the_emissive_stream():
    """A moved emitter: the emissive BVH is refitted and ``em_stream`` is
    packed anew from it."""
    s = _soup(tsg, 600, seed=12)
    t0 = s.upload("cpu")
    stream0 = t0.em_stream
    _move_node(s, s.root.children[1], 0.5)
    refit = s.refit(t0)
    fresh = s.upload("cpu")
    assert not torch.equal(refit.em_stream.rows, stream0.rows)
    np.testing.assert_array_equal(refit.em_stream.rows[:, :9].numpy().sum(),
                                  ttr.build_emissive_stream(refit.ebvh, refit.em_tables)
                                  .rows[:, :9].numpy().sum())
    # the same emissive triangles as a fresh upload's (slot order may differ)
    np.testing.assert_allclose(np.sort(refit.em_stream.rows[:, 0].numpy()),
                               np.sort(fresh.em_stream.rows[:, 0].numpy()), atol=1e-6)
    assert torch.equal(refit.em_cdf, t0.em_cdf)  # not recomputed (update() parity)


def test_instanced_refit_matches_fresh_upload_and_jax():
    """``_refit_instanced``: one soup instance moved freely and one emissive
    panel moved rigidly (the CDF and areas are kept, so an emissive move
    must preserve area to compare with a fresh upload;
    tests/test_instancing.py:163-183).  The refitted tables render like a
    fresh instanced upload (RMSE < 2e-3), differ from before, reuse the
    prototypes' tables, and equal the JAX refit bit for bit."""
    def moved(sg):
        s = instanced_scene(sg, n_soup_instances=3)
        t0 = s.upload(instancing=True) if sg is jsg else s.upload("cpu", instancing=True)
        nodes = [n for n in s.iter_depth_first() if n.mesh >= 0]
        nodes[0].world_transform = _trs((0.5, 0.4, -0.3), ry=0.5)
        panel = nodes[-2]
        assert s.materials[s.mesh_pool[panel.mesh][0].material].is_emissive
        panel.world_transform = _trs((1.0, 2.8, 0.5), ry=0.9) @ panel.world_transform
        return s, t0, s.refit(t0)

    s, t0, refit = moved(tsg)
    _, _, jrefit = moved(jsg)
    for g, g0, jg in zip(refit.inst.groups, t0.inst.groups, jrefit.inst.groups):
        assert g.table is g0.table and g.pblas is g0.pblas  # reused, not rebuilt
        for name in ("inv", "aabb_min", "aabb_max", "inst_id"):
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jg, name)))
    np.testing.assert_array_equal(refit.inst.inv_flat.numpy(), np.asarray(jrefit.inst.inv_flat))
    np.testing.assert_array_equal(refit.inst.nrm_flat.numpy(), np.asarray(jrefit.inst.nrm_flat))
    for name in ("em_v0", "em_v1", "em_v2"):
        for g, w in zip(getattr(refit, name), getattr(jrefit, name)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in ("n0", "n1", "n2", "area", "p_delta"):
        np.testing.assert_array_equal(getattr(refit.em_tables, name).numpy(),
                                      np.asarray(getattr(jrefit.em_tables, name)))
    for name in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(refit.ebvh, name).numpy(),
                                      np.asarray(getattr(jrefit.ebvh, name)), err_msg=name)
    assert not torch.equal(refit.inst.groups[0].inv, t0.inst.groups[0].inv)

    fresh = s.upload("cpu", instancing=True)
    a, _ = render_image(refit, _inst_cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    b, _ = render_image(fresh, _inst_cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    c, _ = render_image(t0, _inst_cam(), 24, 24, spp=2, max_depth=2, tonemap=False)
    assert _rmse(a, b) < 2e-3
    assert _rmse(a, c) > 1e-4  # the move changed the image


def test_instanced_refit_steps_read_the_moved_transforms(monkeypatch):
    """After an instanced refit each instance step reads the new transforms
    where they lie on the tables' device: the refit tables' hits are the
    Python-number path's on the same tables bit for bit, and not the old
    tables'."""
    s = instanced_scene(tsg, n_soup_instances=3)
    t0 = s.upload("cpu", instancing=True)
    node = next(n for n in s.iter_depth_first() if n.mesh == 0)
    node.world_transform = _trs((0.5, 0.4, -0.3), ry=0.5)
    refit = s.refit(t0)
    got, old = instanced_calls(refit), instanced_calls(t0)
    monkeypatch.setattr(tinst, "_instances", host_instances)
    want = instanced_calls(refit)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[1], old[1])


@pytest.mark.parametrize("instancing", [False, True])
def test_refit_refuses_a_topology_change(instancing):
    s = instanced_scene(tsg, n_soup_instances=2)
    t0 = s.upload("cpu", instancing=instancing)
    s.add_node(s.root, _trs((0.0, 1.0, 0.0)), mesh=0)
    with pytest.raises(ValueError, match="unchanged topology"):
        s.refit(t0)
