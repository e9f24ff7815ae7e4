"""The port's procedural and built-in scenes, and the bench gate frames.

* Every generator of ``scene/procedural.py`` (and the two built-in scenes
  that came with it) makes the same scene as the JAX package's at a small
  detail: positions, normals, indices, node transforms and every material
  field bit-equal.
* The bench's quality-gate frames of cfg2-cfg5 (``bench.py:132-148``: the
  crop, spp and depth of each configuration, at its camera) rendered by the
  port on the CPU, where it runs the plain versions of the BVH kernels,
  against the committed NumPy-oracle goldens in ``bench_goldens.npz``:
  per-pixel RMSE < 2e-3 (the bench's bar), and the ray count within 0.1% of
  the JAX package's CPU render of the same frame.
"""

import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest

from vulkan_raytracer_tpu_torch.render.renderer import render_image
from vulkan_raytracer_tpu_torch.scene import procedural as tproc
from vulkan_raytracer_tpu_torch.scene.camera import Camera

ROOT = Path(__file__).resolve().parent.parent
RMSE_BAR = 2e-3


def _scene_arrays(scene):
    """Every primitive's arrays and node transform, in DFS order, and the
    material fields."""
    prims = []
    for node in scene.iter_depth_first():
        if node.mesh < 0:
            continue
        for p in scene.mesh_pool[node.mesh]:
            prims.append((node.world_transform, p.positions, p.normals, p.tangents, p.uvs,
                          p.indices, p.material))
    mats = [{f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
            for m in scene.materials]
    return prims, mats


GENERATORS = [
    ("procedural", "hall_scene", dict(detail=8)),
    ("procedural", "hall_scene", dict(detail=8, with_emissive=False)),
    ("procedural", "dragon_scene", dict(detail=12)),
    ("procedural", "multi_scene", dict(detail=8)),
    ("procedural", "chess_scene", dict(detail=4)),
    ("builtin", "triangle_soup_scene", dict(n_tris=500, seed=2, emissive_every=1)),
    ("builtin", "glass_sphere_scene", dict(subdiv=1, dispersion=0.02)),
]


@pytest.mark.parametrize("module,name,kwargs", GENERATORS,
                         ids=[f"{g[1]}-{i}" for i, g in enumerate(GENERATORS)])
def test_generator_bit_equal_to_jax(module, name, kwargs):
    jmod = importlib.import_module(f"vulkan_raytracer_tpu.scene.{module}")
    tmod = importlib.import_module(f"vulkan_raytracer_tpu_torch.scene.{module}")
    jprims, jmats = _scene_arrays(getattr(jmod, name)(**kwargs))
    tprims, tmats = _scene_arrays(getattr(tmod, name)(**kwargs))
    assert len(tprims) == len(jprims) > 0 and len(tmats) == len(jmats)
    for tp, jp in zip(tprims, jprims):
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype
    for tm, jm in zip(tmats, jmats):
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jm[k]), err_msg=k)


def test_sky_hdr_bit_equal_to_jax():
    from vulkan_raytracer_tpu.scene.procedural import sky_hdr

    for shape in ((16, 32), (64, 128)):
        got, want = tproc.sky_hdr(*shape), sky_hdr(*shape)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_cli_knows_the_jax_cli_scenes():
    from vulkan_raytracer_tpu import cli as jcli

    from vulkan_raytracer_tpu_torch import cli

    assert cli.BUILTIN_SCENES.keys() == jcli.BUILTIN_SCENES.keys()


def _hall_sky():
    s = tproc.hall_scene()
    s.skybox = tproc.sky_hdr()
    s.skybox_strength = 1.0
    return s


#: bench.py:132-148: (golden key, scene, camera, (crop, spp, depth), the JAX
#: package's ray count for the same frame on the CPU)
GATES = {
    "cfg2": ("cfg2_dragon_substitute_262k_512x512_d4", tproc.dragon_scene,
             ([0.0, 2.2, 4.5], [0.0, -0.25, -1.0]), (16, 2, 3), 888),
    "cfg3": ("cfg3_chess_substitute_98k_512x512_d6", tproc.chess_scene,
             ([0.0, 4.0, 7.0], [0.0, -0.5, -1.0]), (16, 2, 4), 1021),
    "cfg4": ("cfg4_sponza_substitute_256k_hdrsky_960x540_d4_8spp", _hall_sky,
             ([-9.0, 1.8, 0.0], [1.0, 0.0, 0.0]), (16, 2, 3), 2803),
    "cfg5": ("cfg5_multimodel_1920x1080_d8_8spp", tproc.multi_scene,
             ([-9.0, 2.0, 1.5], [1.0, -0.1, -0.15]), (12, 1, 4), 850),
}


@pytest.mark.parametrize("cfg", sorted(GATES))
def test_bench_gate_matches_golden(cfg):
    """The full-size scene (98k-262k triangles, so the BVH path with the
    default treelet cut: the treelet walk) on the CPU; RMSE measured 3e-8
    (cfg2) to 2e-6 (cfg4)."""
    key, build, (pos, direction), (crop, spp, depth), jax_rays = GATES[cfg]
    tables = build().upload("cpu")
    assert tables.pbvh is not None and tables.pbvh.n_treelets > 1
    cam = Camera(position=np.array(pos), direction=np.array(direction))
    img, rays = render_image(tables, cam, crop, crop, spp=spp, max_depth=depth, tonemap=False)
    golden = np.load(ROOT / "bench_goldens.npz")[f"golden_{key}"]
    assert img.shape == golden.shape and np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
    assert rmse < RMSE_BAR, f"{cfg}: port vs golden RMSE {rmse}"
    assert abs(rays - jax_rays) <= 1e-3 * jax_rays, (rays, jax_rays)
