"""The port's pixel sharding (``parallel/sharding.py``) against the JAX
package's sharded render and against the port's own unsharded render.

The CPU mesh is ``["cpu"] * 8``, the counterpart of the 8 virtual CPU devices
tests/conftest.py gives JAX.  Tolerances: a shard computes each lane as the
unsharded render does, but a pixel's samples may be summed in another
grouping (``s_batch`` comes from the shard's lane count), so sharded against
unsharded is held to rtol 1e-5 / atol 1e-6, the bound of
tests/test_parallel.py; against JAX the same bound holds (measured 6e-8), with
JAX's ray count, padding lanes included, exactly.  A mesh of one renders the
same waves as ``render_image`` and must give its image bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from vulkan_raytracer_tpu.parallel.sharding import make_mesh as jmake_mesh
from vulkan_raytracer_tpu.parallel.sharding import render_image_sharded as jrender_image_sharded
from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
from vulkan_raytracer_tpu_torch.parallel.sharding import (
    make_mesh,
    render_image_sharded,
    render_sample_sharded,
)
from vulkan_raytracer_tpu_torch.render import renderer as trnd
from vulkan_raytracer_tpu_torch.render.integrator import render_sample
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

CPU8 = ["cpu"] * 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _cam(cls=Camera):
    return cls(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))


@pytest.fixture(scope="module")
def tables():
    return cornell_box_scene().upload("cpu")


def test_make_mesh():
    assert make_mesh(CPU8) == [torch.device("cpu")] * 8
    with pytest.raises(ValueError):
        make_mesh([])
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(["cuda", "cuda"])


def test_padded_frame_matches_jax_sharded():
    """25x5 = 125 pixels on 8 shards of 16 lanes: three padding lanes repeat
    the last pixel of the block order.  The image is JAX's sharded image, and
    the ray count JAX's ``psum``, which counts the padding lanes too."""
    jt = jcornell().upload()
    tt = tables_from_numpy(jax.tree_util.tree_map(np.asarray, jt), "cpu")
    assert len(jax.devices()) == 8
    img_j, rays_j = jrender_image_sharded(jt, _cam(JCamera), 25, 5, spp=2, max_depth=2,
                                          mesh=jmake_mesh(), tonemap=False)
    img_t, rays_t = render_image_sharded(tt, _cam(), 25, 5, spp=2, max_depth=2, mesh=CPU8,
                                         tonemap=False)
    assert img_t.shape == (5, 25, 3) and img_t.dtype == np.float32
    np.testing.assert_allclose(img_t, np.asarray(img_j), **TOL)
    assert rays_t == int(rays_j)
    _, rays_1 = trnd.render_image(tt, _cam(), 25, 5, spp=2, max_depth=2, tonemap=False)
    assert rays_t > rays_1  # the padding lanes' rays
    assert img_t.mean() > 1e-3


@pytest.mark.parametrize("frame, cap", [((25, 5, 2), None), ((32, 8, 2), None),
                                        ((25, 5, 2), 64)],
                         ids=["padded", "whole", "banded"])
@pytest.mark.parametrize("tonemap", [False, True])
def test_mesh_of_one_is_render_image(frame, cap, tonemap, tables, monkeypatch):
    """One shard traces the waves of ``render_image`` in the same order (the
    banded case with the renderer's cap shrunk, so that both trace 4 bands of
    32 pixels x 2 samples, the last of 29)."""
    w, h, spp = frame
    if cap:
        monkeypatch.setattr(trnd, "MAX_LANES_PER_PASS", cap)
    img_1, rays_1 = trnd.render_image(tables, _cam(), w, h, spp=spp, max_depth=2,
                                      tonemap=tonemap)
    img_s, rays_s = render_image_sharded(tables, _cam(), w, h, spp=spp, max_depth=2,
                                         mesh=["cpu"], tonemap=tonemap)
    np.testing.assert_array_equal(img_s, img_1)
    assert rays_s == rays_1


@pytest.mark.parametrize("frame, shards, cap, waves", [
    ((32, 8, 2), 8, None, 8 * 1), ((40, 16, 6), 8, 64, 8 * 8), ((16, 8, 10), 2, 56, 2 * 10 * 2)],
    ids=["whole", "banded", "banded_two_chunks"])
def test_sharded_matches_render_image(frame, shards, cap, waves, tables, monkeypatch):
    """32x8 on 8 shards renders whole (32 lanes a shard).  A small
    ``max_lanes_per_pass`` bands each shard: 40x16 at 6 spp on 8 shards of 80
    lanes under a cap of 64 in one chunk of 6 over 8 bands of 10 lanes; 16x8
    at 10 spp on 2 shards of 64 lanes under 56 in chunks of 8 + 2 over 10
    bands of 7 lanes, the last of 1."""
    w, h, spp = frame
    img_1, rays_1 = trnd.render_image(tables, _cam(), w, h, spp=spp, max_depth=2, tonemap=False)
    calls, run = [], trnd.Waves.run

    def wave(waves, first, k, **kw):  # one wave: k samples of the band's lanes
        calls.append(k * waves.lanes.shape[0])
        return run(waves, first, k, **kw)

    monkeypatch.setattr(trnd.Waves, "run", wave)
    img_s, rays_s = render_image_sharded(tables, _cam(), w, h, spp=spp, max_depth=2,
                                         mesh=["cpu"] * shards, tonemap=False,
                                         max_lanes_per_pass=cap)
    assert len(calls) == waves and sum(calls) == w * h * spp
    assert max(calls) <= (cap or trnd.MAX_LANES_PER_PASS)
    np.testing.assert_allclose(img_s, img_1, **TOL)
    assert rays_s == rays_1
    assert img_s.mean() > 1e-3


def test_sharded_instanced_tables():
    """Instanced tables (the scene of tests/test_torch_instancing.py) render
    on 4 shards as unsharded."""
    from test_torch_instancing import _cam as icam
    from test_torch_instancing import instanced_scene
    from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg

    ti = instanced_scene(tsg, n_soup_instances=3).upload("cpu", instancing=True)
    assert ti.inst is not None
    img_1, rays_1 = trnd.render_image(ti, icam(), 32, 16, spp=2, max_depth=2, tonemap=False)
    img_s, rays_s = render_image_sharded(ti, icam(), 32, 16, spp=2, max_depth=2,
                                         mesh=["cpu"] * 4, tonemap=False)
    np.testing.assert_allclose(img_s, img_1, **TOL)
    assert rays_s == rays_1
    assert img_s.mean() > 1e-3


def test_render_sample_sharded(tables):
    """One sample on 8 shards against ``render_sample`` over the same padded
    lanes: radiance sliced to the frame, rays of the padded lanes."""
    w, h = 25, 5
    cam = _cam()
    cam.aspect = w / h
    vi, pi = trnd.camera_uniforms(cam)
    rad_s, rays_s = render_sample_sharded(tables, vi, pi, w, h, 3, 2, mesh=CPU8)
    padded = torch.clamp(torch.arange(8 * 16, dtype=torch.int32), max=w * h - 1)
    rad_1, rays_1 = render_sample(tables, vi, pi, w, h, 3, 2, lane_idx=padded)
    assert rad_s.shape == (w * h, 3)
    np.testing.assert_allclose(rad_s.numpy(), rad_1[:w * h].numpy(), **TOL)
    assert int(rays_s) == int(rays_1)
    rad_u, _ = render_sample(tables, vi, pi, w, h, 3, 2)
    np.testing.assert_allclose(rad_s.numpy(), rad_u.numpy(), **TOL)
