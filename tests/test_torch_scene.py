"""The port's scene upload against the JAX package's, column for column."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vulkan_raytracer_tpu.scene import builtin as jbuiltin
from vulkan_raytracer_tpu.scene import scenegraph as jsg
from vulkan_raytracer_tpu_torch.ops.math3 import V3
from vulkan_raytracer_tpu_torch.scene import builtin as tbuiltin
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy


def _leaves(x, prefix=""):
    """(name, value) for every array or scalar leaf of a port table tree."""
    if isinstance(x, V3):
        for k, c in zip("xyz", x):
            yield f"{prefix}.{k}", c
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{prefix}.{f.name}" if prefix else f.name)
    else:
        yield prefix, x


def _get(tables, path):
    for part in path.split("."):
        tables = getattr(tables, part)
    return tables


def _assert_same_tables(port, ref):
    """Every leaf of the port tables bit-equal to the same-named leaf of
    ``ref``.  The port builds a BVH only for scenes on the BVH path (None
    otherwise), and its streams have their own layout (held against the JAX
    PacketBVH in tests/test_torch_bvh.py), so those are skipped here."""
    n = 0
    for name, val in _leaves(port):
        if (name in ("bvh", "pbvh") and val is None) or name.startswith("pbvh."):
            continue
        want = _get(ref, name)
        if isinstance(val, torch.Tensor):
            got = val.cpu().numpy()
            want = np.asarray(want)
            if want.dtype == np.uint32:  # packed texels: the port keeps the bits in int32
                want = want.view(np.int32)
            assert got.shape == want.shape, name
            assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert val == want, name
        n += 1
    return n


def _with_lights(mod, scene):
    scene.point_lights.append(mod.PointLight(np.array([0.3, 1.5, 0.2], np.float32),
                                             np.array([1.0, 0.8, 0.6], np.float32), 4.0, 3.0))
    scene.directional_lights.append(mod.DirectionalLight(
        np.array([0.2, -1.0, -0.3], np.float32), np.array([0.5, 0.5, 0.7], np.float32), 1.5))
    return scene


@pytest.mark.parametrize("lights", [False, True])
def test_cornell_upload_matches_jax(lights):
    js, ts = jbuiltin.cornell_box_scene(), tbuiltin.cornell_box_scene()
    if lights:
        js, ts = _with_lights(jsg, js), _with_lights(tsg, ts)
    jt = js.upload()
    tt = ts.upload("cpu")
    assert tt.num_triangles == 36 and tt.num_emissive_tris == 2
    assert not tt.has_alpha and not tt.has_textures
    assert (tt.num_point, tt.num_directional) == ((1, 1) if lights else (0, 0))
    n = _assert_same_tables(tt, jax.tree_util.tree_map(np.asarray, jt))
    assert n > 60  # every column, incl. em_cdf, em_tables and the material table


def test_cornell_bvh_upload_matches_jax():
    """With ``traversal="bvh"`` the port also builds the threaded BVH, bit-equal
    to the one the JAX upload always builds."""
    jt = jax.tree_util.tree_map(np.asarray, jbuiltin.cornell_box_scene().upload())
    tt = tbuiltin.cornell_box_scene().upload("cpu", traversal="bvh")
    assert tt.bvh is not None and tt.pbvh is not None
    n = _assert_same_tables(tt, jt)
    assert n > 70  # the columns above and the nine BVH leaves
    _assert_same_tables(tables_from_numpy(jt, "cpu", traversal="bvh"), jt)


def test_tables_from_numpy_round_trip():
    jt = jax.tree_util.tree_map(np.asarray, jbuiltin.cornell_box_scene().upload())
    conv = tables_from_numpy(jt, "cpu")
    _assert_same_tables(conv, jt)
    _assert_same_tables(conv.to("cpu"), jt)
    # the port's own upload and the converted JAX upload are the same tables
    _assert_same_tables(tbuiltin.cornell_box_scene().upload("cpu"), jt)
    assert conv.skybox.h == 1 and conv.skybox_strength.shape == ()


def test_scene_graph_world_transforms():
    s = tsg.Scene()
    a = s.add_node(s.root, np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [1.0, 0.0, 0.0]
    b = s.add_node(a, t)
    np.testing.assert_array_equal(b.world_transform[:3, 3], [2.0, 0.0, 0.0])
    assert [n.depth for n in s.iter_depth_first()] == [0, 1, 2]
    with pytest.raises(FileNotFoundError):  # CornellBox.gltf is not in the repository
        s.load_model("CornellBox.gltf")


def test_sweep_tables_built_once_per_tables():
    """The sweeps' (9, T) and (20, Te) tables are built on first use, kept on
    the SceneTables, and rebuilt for a copy on another device."""
    from vulkan_raytracer_tpu_torch.ops import dense

    tt = tbuiltin.cornell_box_scene().upload("cpu")
    assert tt.tri_table is tt.tri_table and tt.em_table is tt.em_table
    assert tt.tri_table.shape == (9, 36) and tt.em_table.shape == (20, 2)
    assert tt.tri_table.is_contiguous() and tt.em_table.is_contiguous()
    assert torch.equal(tt.tri_table, dense.closest_table(tt))
    assert torch.equal(tt.em_table, dense.pdf_table(tt))
    moved = tt.to("cpu")
    assert moved.tri_table is not tt.tri_table
    assert torch.equal(moved.tri_table, tt.tri_table)
