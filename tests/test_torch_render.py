"""End-to-end parity of the torch port's render with the JAX package's.

The BASELINE bar is per-pixel RMSE < 2e-3 at equal spp; the two packages
share RNG streams, so they agree to float32 rounding (~1e-7).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkan_raytracer_tpu.ops.dense import dense_closest as jdense_closest
from vulkan_raytracer_tpu.render import integrator as jint
from vulkan_raytracer_tpu.render import oracle
from vulkan_raytracer_tpu.render.renderer import camera_uniforms as jcamera_uniforms
from vulkan_raytracer_tpu.render.renderer import render_image as jrender_image
from vulkan_raytracer_tpu.scene import scenegraph as jsg
from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
from vulkan_raytracer_tpu_torch.ops import dense as tdense
from vulkan_raytracer_tpu_torch.ops.dense import dense_closest
from vulkan_raytracer_tpu_torch.render import integrator as tint
from vulkan_raytracer_tpu_torch.render.renderer import camera_uniforms, render_image
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

RMSE_BAR = 2e-3
ROOT = Path(__file__).resolve().parent.parent
W = H = 32
SPP, DEPTH = 2, 3


def _cam(cls=Camera):
    """bench cfg1's camera (bench.py:149-151): the port's, or the JAX
    package's with ``cls=JCamera``."""
    return cls(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _jax_and_port(scene):
    jt = scene.upload()
    return jt, tables_from_numpy(jax.tree_util.tree_map(np.asarray, jt), "cpu")


@pytest.mark.parametrize("nee", ["reference", "physical"])
def test_render_matches_jax(nee):
    """Port (fed the converted JAX tables) vs the JAX renderer: RMSE 5e-8
    measured for "reference" on the CPU, far inside the 2e-3 bar; ray
    counts within 0.1% (a lane whose hit flips on a last-ulp difference
    traces a different number of rays)."""
    jt, tt = _jax_and_port(jcornell())
    img_j, rays_j = jrender_image(jt, _cam(JCamera), W, H, spp=SPP, max_depth=DEPTH,
                                  tonemap=False, nee_weighting=nee)
    img_t, rays_t = render_image(tt, _cam(), W, H, spp=SPP, max_depth=DEPTH, tonemap=False,
                                 nee_weighting=nee)
    assert img_t.shape == (H, W, 3) and img_t.dtype == np.float32
    r = _rmse(img_t, img_j)
    assert r < RMSE_BAR, f"port vs JAX RMSE {r}"
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)
    assert img_t.mean() > 1e-3


def test_render_matches_oracle():
    tt = cornell_box_scene().upload("cpu")
    img_t, _ = render_image(tt, _cam(), W, H, spp=SPP, max_depth=DEPTH, tonemap=False)
    img_o = oracle.render_image(tt.to("cpu"), _cam(), W, H, spp=SPP, max_depth=DEPTH)
    r = _rmse(img_t, img_o)
    assert r < RMSE_BAR, f"port vs oracle RMSE {r}"


def test_render_tonemapped_uint8():
    tt = cornell_box_scene().upload("cpu")
    img, _ = render_image(tt, _cam(), 8, 8, spp=1, max_depth=2, as_uint8=True)
    assert img.dtype == np.uint8 and img.shape == (8, 8, 3) and img.max() > 0


def test_generate_primary_rays_matches_jax():
    """Seeds bit-equal, directions within rtol 1e-6, on a lane subset with
    per-lane sample counts (including the preview sample 0)."""
    jcam, cam = _cam(JCamera), _cam()
    jcam.aspect = cam.aspect = 1.5
    vi, pi = jcamera_uniforms(jcam)
    tvi, tpi = camera_uniforms(cam)
    lanes = np.random.default_rng(0).permutation(48 * 32)[:700].astype(np.int32)
    counts = np.random.default_rng(1).integers(0, 5, 700).astype(np.uint32)
    jo, jd, js = jint.generate_primary_rays(vi, pi, 48, 32, jnp.asarray(counts),
                                            jnp.asarray(lanes))
    to, td, ts = tint.generate_primary_rays(tvi, tpi, 48, 32,
                                            torch.as_tensor(counts.astype(np.int64)),
                                            torch.as_tensor(lanes), device="cpu")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for g, w in zip(td, jd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    for g, w in zip(to, jo):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # all pixels, one scalar sample count
    _, jd1, js1 = jint.generate_primary_rays(vi, pi, 48, 32, 3)
    _, td1, ts1 = tint.generate_primary_rays(tvi, tpi, 48, 32, 3, device="cpu")
    np.testing.assert_array_equal(ts1.numpy(), np.asarray(js1).astype(np.int64))
    np.testing.assert_allclose(td1.x.numpy(), np.asarray(jd1.x), rtol=1e-6, atol=1e-7)


def _with_point_light(scene):
    scene.point_lights.append(jsg.PointLight(np.array([0.4, 1.6, 0.3], np.float32),
                                             np.array([1.0, 0.9, 0.7], np.float32), 3.0, 0.0))
    return scene


def test_sample_lights_matches_jax_with_point_light():
    """NEE on Cornell plus one point light: the 50/50 analytic/emissive pick,
    _sample_analytic, _sample_emissive, the merged occlusion ray and the pdf
    probe.  Seeds and ray counts exact; contributions within rtol 1e-4
    (hit points differ in the last ulp between the two packages)."""
    jt, tt = _jax_and_port(_with_point_light(jcornell()))
    assert tt.num_point == 1
    vi, pi = jcamera_uniforms(_cam(JCamera))
    jo, jd, js = jint.generate_primary_rays(vi, pi, W, H, 1)
    to, td, ts = tint.generate_primary_rays(*camera_uniforms(_cam()), W, H, 1, device="cpu")
    jhit_raw = jdense_closest(jt, jo, jd, t_min=1e-7, t_max=1e32,
                              active=jnp.ones(W * H, bool))
    thit_raw = dense_closest(tt, to, td, t_min=1e-7, t_max=1e32,
                             active=torch.ones(W * H, dtype=torch.bool))
    np.testing.assert_array_equal(thit_raw[1].numpy(), np.asarray(jhit_raw[1]))
    jhit = jint.eval_hit(jt, jo, jd, *jhit_raw, sky=False)
    thit = tint.eval_hit(tt, to, td, *thit_raw)
    mask = (thit_raw[1] >= 0) & ~thit.mat.emissive.any_nonzero()
    wl = np.zeros(W * H, np.float32)
    jc, jseed, jrays = jint.sample_lights(jt, jhit, jnp.asarray(wl), -jd, js,
                                          jnp.asarray(mask.numpy()))
    tc, tseed, trays = tint.sample_lights(tt, thit, torch.as_tensor(wl), -td, ts, mask)
    np.testing.assert_array_equal(tseed.numpy(), np.asarray(jseed).astype(np.int64))
    assert int(trays) == int(jrays) > 0
    for g, w in zip(tc, jc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert float(tc.x.sum()) > 0


def test_unported_features_raise():
    """What the headless render used to refuse now renders: alpha and
    textures (tests/test_torch_alpha.py), more than EMISSIVE_MAX_TRIS
    emissive triangles (the emissive-BVH probe, tests/test_torch_emissive.py)
    and frames above one wave (the banded renderer,
    tests/test_torch_banded.py); the progressive renderer's CLI flags run
    (tests/test_torch_progressive.py).  Only ``--shard`` still raises."""
    from vulkan_raytracer_tpu_torch import cli

    s = cornell_box_scene()
    s.materials[0].alpha_mode = 1
    img, _ = render_image(s.upload("cpu"), _cam(), 4, 4, spp=1, max_depth=1)
    assert np.isfinite(img).all()
    m = tsg.Material()
    m.emissive_factor = np.ones(3, np.float32)
    n = tdense.EMISSIVE_MAX_TRIS + 1
    pos = np.random.default_rng(0).uniform(-1, 1, (3 * n, 3)).astype(np.float32)
    s.add_raw_mesh(pos, np.tile(np.float32([0, 0, 1]), (3 * n, 1)),
                   np.arange(3 * n, dtype=np.uint32), m)
    tt = s.upload("cpu")
    assert tt.num_emissive_tris > tdense.EMISSIVE_MAX_TRIS
    img, rays = render_image(tt, _cam(), 4, 4, spp=1, max_depth=2)
    assert np.isfinite(img).all() and rays >= 16
    tt = cornell_box_scene().upload("cpu")
    img, rays = render_image(tt, _cam(), 1024, 513, spp=1, max_depth=0)
    assert img.shape == (513, 1024, 3) and np.isfinite(img).all() and rays == 1024 * 513
    assert set(cli._NOT_PORTED) == {"shard"}
    with pytest.raises(NotImplementedError, match="--shard.*sharding and multihost"):
        cli.main(["--shard", "--device", "cpu"])
    if not sys.stdin.isatty():  # the viewer is reached, and asks for a terminal
        with pytest.raises(RuntimeError, match="needs a tty"):
            cli.main(["--interactive", "-r", "8,8", "--device", "cpu"])


def test_cli_refuses_missing_cuda():
    from vulkan_raytracer_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-r", "4,4", "--spp", "1", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--progressive", "-r", "4,4", "--spp", "1"])


def test_cli_renders_without_jax(tmp_path):
    """A 16x16 render through the CLI in a fresh interpreter that never
    imports jax or the JAX package (the card's machine has no jax)."""
    out = tmp_path / "cli.png"
    code = (
        "import sys\n"
        "from vulkan_raytracer_tpu_torch import cli\n"
        f"assert cli.main(['-r', '16,16', '--spp', '2', '-b', '2', '--device', 'cpu',"
        f" '--output', {str(out)!r}]) == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'vulkan_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX" in proc.stdout and "Mrays/s" in proc.stdout
    assert out.stat().st_size > 0
