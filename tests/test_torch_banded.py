"""The port's banded renderer against its own single-wave render and against
the JAX package's banded render.

Frames above ``MAX_LANES_PER_PASS`` pixels render in bands of the block
order, ``SPP_CHUNK`` samples to a wave.  The tests shrink the cap in both
packages (as tests/test_renderer_batching.py does) so that a tiny frame
splits into bands, the last of them ragged.

Tolerance of banded against single-wave: both add the same per-lane radiance,
but a pixel's samples are summed in another grouping (``s_batch`` to a wave
there, ``SPP_CHUNK`` here), so the float32 sums may differ in the last bits:
atol 1e-5 on the mean, the bound tests/test_renderer_batching.py uses.
Against JAX the bar is the render's own (RMSE < 2e-3; measured ~1e-7) with
ray counts within 0.1% (ROADMAP.md Queue 3: a lane's hit may flip on a
last-ulp difference between the frameworks).
"""

import numpy as np
import pytest

from vulkan_raytracer_tpu_torch.render import renderer as trnd
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
from vulkan_raytracer_tpu_torch.scene.camera import Camera

RMSE_BAR = 2e-3
DEPTH = 3
#: (width, height, spp, lane cap) -> (samples per wave, pixels per band, bands)
CASES = {
    "ragged_one_chunk": ((23, 17, 3, 300), (3, 98, 4)),
    "ragged_two_chunks": ((17, 11, 10, 150), (8, 19, 10)),
    "even_bands": ((24, 20, 4, 400), (4, 96, 5)),
}


def _cam(cls=Camera):
    return cls(position=np.array([0.0, 1.0, 3.0]), direction=np.array([0.0, 0.0, -1.0]))


@pytest.fixture(scope="module")
def tables():
    return cornell_box_scene().upload("cpu")


@pytest.mark.parametrize("frame, plan", [
    ((1920, 1080, 8, 1 << 19), (8, 64800, 32)),  # bench cfg5: 32 waves of 518,400 lanes
    ((1920, 1080, 1, 1 << 19), (1, 518400, 4)),
    ((1024, 513, 1, 1 << 19), (1, 262656, 2)),
    *CASES.values(),
], ids=["cfg5", "cfg5_1spp", "just_over_cap", *CASES])
def test_band_plan_is_the_jax_arithmetic(frame, plan, monkeypatch):
    """vulkan_raytracer_tpu/render/renderer.py:145-154, by hand."""
    w, h, spp, cap = frame
    monkeypatch.setattr(trnd, "MAX_LANES_PER_PASS", cap)
    assert trnd.band_plan(w, h, spp) == plan
    spp_chunk, per, bands = plan
    assert (per - 1) * spp_chunk < cap and per * (bands - 1) < w * h <= per * bands


@pytest.mark.parametrize("case", CASES)
def test_banded_matches_single_wave(case, tables, monkeypatch):
    (w, h, spp, cap), (_, per, bands) = CASES[case]
    whole, rays_whole = trnd.render_image(tables, _cam(), w, h, spp=spp, max_depth=DEPTH,
                                          tonemap=False)
    assert trnd.LAST_RENDER["bands"] == 0
    monkeypatch.setattr(trnd, "MAX_LANES_PER_PASS", cap)
    banded, rays_banded = trnd.render_image(tables, _cam(), w, h, spp=spp, max_depth=DEPTH,
                                            tonemap=False)
    chunks = -(-spp // trnd.SPP_CHUNK)
    assert trnd.LAST_RENDER == {"bands": bands, "waves": bands * chunks}
    assert (w * h % per != 0) == case.startswith("ragged")
    assert rays_banded == rays_whole
    np.testing.assert_allclose(banded, whole, atol=1e-5, rtol=0)
    assert banded.mean() > 1e-3


@pytest.mark.parametrize("case", ["ragged_one_chunk", "ragged_two_chunks"])
def test_banded_matches_jax_banded(case, tables, monkeypatch):
    import jax
    from vulkan_raytracer_tpu.render import renderer as jrnd
    from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
    from vulkan_raytracer_tpu.scene.camera import Camera as JCamera

    from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

    (w, h, spp, cap), _ = CASES[case]
    jt = jcornell().upload()
    tt = tables_from_numpy(jax.tree_util.tree_map(np.asarray, jt), "cpu")
    monkeypatch.setattr(jrnd, "MAX_LANES_PER_PASS", cap)
    monkeypatch.setattr(trnd, "MAX_LANES_PER_PASS", cap)
    monkeypatch.delenv("VKRT_SPP_CHUNK", raising=False)
    img_j, rays_j = jrnd.render_image(jt, _cam(JCamera), w, h, spp=spp, max_depth=DEPTH,
                                      tonemap=False)
    img_t, rays_t = trnd.render_image(tt, _cam(), w, h, spp=spp, max_depth=DEPTH, tonemap=False)
    assert trnd.LAST_RENDER["bands"] == CASES[case][1][2]
    rmse = float(np.sqrt(np.mean((img_t - np.asarray(img_j)) ** 2)))
    assert rmse < RMSE_BAR, f"port vs JAX banded RMSE {rmse}"
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)


def test_frame_above_the_cap_renders(tables):
    """A frame just above 524,288 pixels at the real cap, 1 spp, depth 1: two
    bands, a finite and lit image, at least one ray per pixel."""
    w, h = 1024, 513
    img, rays = trnd.render_image(tables, _cam(), w, h, spp=1, max_depth=1, tonemap=False)
    assert trnd.LAST_RENDER == {"bands": 2, "waves": 2}
    assert img.shape == (h, w, 3) and np.isfinite(img).all() and img.mean() > 1e-3
    assert rays >= w * h
    assert img[: h // 2].mean() > 0 and img[h // 2:].mean() > 0  # both bands wrote pixels
