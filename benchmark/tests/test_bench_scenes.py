"""The frozen scenes are the port's generators at the benchmark's commit,
and the port uploads them through ``Scene.add_raw_mesh`` as it uploads its
own builders' scenes."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import port_scene
from benchmark.scenes import cornell, hall
from benchmark.spec import Spec
from vulkan_raytracer_tpu_torch.scene import builtin, procedural
from vulkan_raytracer_tpu_torch.scene.scenegraph import Material, SceneTables


def _port_meshes(scene):
    """(positions, normals, indices, material, world transform) of each
    node's primitive, in order."""
    out = []
    for node in scene.iter_depth_first():
        if node.mesh < 0:
            continue
        for prim in scene.mesh_pool[node.mesh]:
            out.append((prim.positions, prim.normals, prim.indices,
                        scene.materials[prim.material], node.world_transform))
    return out


def _same_material(ours, theirs: Material):
    for f in dataclasses.fields(type(ours)):
        assert np.array_equal(np.asarray(getattr(ours, f.name)),
                              np.asarray(getattr(theirs, f.name))), f.name


@pytest.mark.parametrize("name", ["cornell", "hall"])
def test_frozen_arrays_equal_the_ports(name):
    args = Spec().config(name)["scene_args"]  # the sizes the cell runs at
    ours = cornell.build(**args) if name == "cornell" else hall.build(**args)
    theirs = builtin.cornell_box_scene() if name == "cornell" else procedural.hall_scene(80)
    port = _port_meshes(theirs)
    assert len(ours.meshes) == len(port)
    for mesh, (pos, nrm, idx, mat, world) in zip(ours.meshes, port):
        assert np.array_equal(mesh.positions, pos)
        assert np.array_equal(mesh.normals, nrm)
        assert np.array_equal(mesh.indices, idx)
        _same_material(mesh.material, mat)
        transform = np.eye(4, dtype=np.float32) if mesh.transform is None else mesh.transform
        assert np.array_equal(transform, world)
    if name == "hall":
        assert (args["sky_h"], args["sky_w"]) == (2048, 4096)  # hilly_terrain_01_4k.hdr's
        assert np.array_equal(ours.skybox, procedural.sky_hdr(args["sky_h"], args["sky_w"]))
        assert ours.skybox_strength == 1.0
        assert sum(m.indices.shape[0] // 3 for m in ours.meshes) == 256_032


def _tensors(x, path="tables"):
    """Every tensor, array and number under ``x``, by path."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, (int, float, bool, np.ndarray)):
        yield path, x


@pytest.mark.parametrize("name", ["cornell", "hall"])
def test_raw_mesh_upload_equals_the_builders(name):
    if name == "cornell":
        ours, theirs = cornell.build(), builtin.cornell_box_scene()
    else:
        ours, theirs = hall.build(), procedural.hall_scene(80)
        theirs.skybox, theirs.skybox_strength = procedural.sky_hdr(), 1.0
    a = dict(_tensors(port_scene(ours).upload("cpu")))
    b = dict(_tensors(theirs.upload("cpu")))
    assert a.keys() == b.keys()
    assert any(k.startswith("tables.em_cdf") for k in a)
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, torch.Tensor):  # bit for bit: the streams hold ints in floats
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert torch.equal(x.reshape(-1).contiguous().view(torch.uint8),
                               y.reshape(-1).contiguous().view(torch.uint8)), key
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), key
    assert isinstance(port_scene(ours).upload("cpu"), SceneTables)
