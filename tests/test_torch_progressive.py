"""The progressive ``Renderer`` and the CLI flags around it, against the JAX
package: frame k's accumulator within rtol 1e-5 of the JAX ``Renderer``'s and
its uint8 display image within one level (path flips apart); N progressive frames equal
``render_image(spp=N)``; checkpoint + resume equals one uninterrupted render
(atol 1e-6 on the linear sum); the render fingerprint equals the JAX digest.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vulkan_raytracer_tpu import cli as jcli
from vulkan_raytracer_tpu.render.renderer import Renderer as JRenderer
from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
from vulkan_raytracer_tpu_torch import cli
from vulkan_raytracer_tpu_torch.render.renderer import Renderer, render_image
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.utils.image import read_png

ROOT = Path(__file__).resolve().parent.parent
W = H = 24
DEPTH = 2
FRAMES = 4  # the preview frame and three samples


def _cam(cls=Camera):
    return cls(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))


@pytest.fixture(scope="module")
def tables():
    return cornell_box_scene().upload("cpu")


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX Renderer's frames on Cornell 24x24: per frame its uint8 image
    and a copy of the accumulator; then the total ray count."""
    r = JRenderer(jcornell().upload(), _cam(JCamera), W, H, max_depth=DEPTH)
    frames = []
    for _ in range(FRAMES):
        img = r.draw_frame()
        frames.append((np.asarray(img), np.asarray(r.accum).copy()))
    return frames, r.rays_traced


def test_frames_match_jax_renderer(tables, jax_frames):
    frames, jrays = jax_frames
    r = Renderer(tables, _cam(), W, H, max_depth=DEPTH)
    for k, (jimg, jacc) in enumerate(frames):
        accum = r.accum  # accumulated in place: the same buffer every frame
        img = r.draw_frame()
        assert r.accum is accum and r.sample_count == k + 1
        assert img.shape == (H, W, 3) and img.dtype == np.uint8
        np.testing.assert_allclose(r.accum.numpy(), jacc, rtol=1e-5, atol=1e-7)
        # within one level; a path may flip on a last-ulp difference (the jitted
        # JAX frame differs so from JAX's own eager sample): 1 of 1,728 values
        # of the preview frame, measured
        off = np.abs(img.astype(int) - jimg.astype(int)) > 1
        assert off.sum() <= 2, (k, int(off.sum()))
        if k == 0:
            assert not r.accum.any() and img.max() > 0  # the preview is shown, not kept
    assert abs(r.rays_traced - jrays) <= 1e-3 * jrays
    assert r.rays_traced == r.total_rays and not r._rays_pending


def test_progressive_frames_equal_render_image(tables):
    """N progressive samples sum to ``render_image(spp=N)``: the preview
    frame is excluded, sample k is frame k."""
    n = 3
    r = Renderer(tables, _cam(), W, H, max_depth=DEPTH)
    for _ in range(n + 1):
        r.draw_frame()
    want, rays = render_image(tables, _cam(), W, H, spp=n, max_depth=DEPTH, tonemap=False)
    got = (r.accum / n).numpy().reshape(H, W, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert rays < r.rays_traced <= rays + 6 * W * H  # plus the preview frame's rays


def test_camera_move_and_resize_reset(tables):
    cam = _cam()
    r = Renderer(tables, cam, W, H, max_depth=DEPTH)
    for _ in range(3):
        r.draw_frame()
    assert r.sample_count == 3
    cam.process_key_input({"w"}, 0.1)
    assert cam.position_changed
    r.draw_frame()  # renders the preview sample again
    assert r.sample_count == 1 and not cam.position_changed and not r.accum.any()
    r.draw_frame()
    cam.cursor_moved(10.0, 0.0, left=True)
    r.draw_frame()
    assert r.sample_count == 1 and not cam.direction_changed
    r.draw_frame()
    assert r.accum.any()
    r.reset_accumulation()
    assert r.sample_count == 0
    r.draw_frame(pipeline=True)
    r.handle_resize(16, 12)
    assert (r.width, r.height, r.sample_count) == (16, 12, 0)
    assert r.accum.shape == (16 * 12, 3) and not r.accum.any() and r._inflight is None
    assert cam.aspect == 16 / 12
    assert r.draw_frame().shape == (12, 16, 3)


def test_display_size_pools_on_the_device(tables):
    """``display_size`` mean-pools the uint8 image: each cell is the floor of
    the mean of its block of the full frame."""
    full = Renderer(tables, _cam(), W, H, max_depth=DEPTH)
    pooled = Renderer(tables, _cam(), W, H, max_depth=DEPTH)
    for _ in range(2):
        a = full.draw_frame()
        b = pooled.draw_frame(display_size=(8, 6))
    assert b.shape == (8, 6, 3) and b.dtype == np.uint8
    want = a.reshape(8, 3, 6, 4, 3).astype(np.int64).sum(axis=(1, 3)) // 12
    np.testing.assert_array_equal(b, want)
    # a display that does not divide the frame drops the remainder rows
    c = Renderer(tables, _cam(), W, H, max_depth=DEPTH).draw_frame(display_size=(5, 7))
    assert c.shape == (5, 7, 3)


def test_pipeline_returns_the_previous_frame(tables):
    plain = Renderer(tables, _cam(), W, H, max_depth=DEPTH)
    piped = Renderer(tables, _cam(), W, H, max_depth=DEPTH)
    want = [plain.draw_frame() for _ in range(3)]
    got = [piped.draw_frame(pipeline=True) for _ in range(4)]
    assert got[0] is None
    for k in range(3):
        np.testing.assert_array_equal(got[k + 1], want[k])


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

BASE = ["-r", f"{W},{H}", "-b", str(DEPTH), "-c", "0,1,2.4", "-d", "0,0,-1", "--device", "cpu"]


def test_cli_progressive(tmp_path, tables):
    out = tmp_path / "p.png"
    stats = cli.run([*BASE, "--spp", "3", "--progressive", "--output", str(out)])
    assert stats["frames"] == 4 and len(stats["frame_ms"]) == 4
    want, rays = render_image(tables, _cam(), W, H, spp=3, max_depth=DEPTH, tonemap=False)
    np.testing.assert_allclose(stats["image"], want, atol=1e-6)
    assert stats["rays"] > rays
    r = Renderer(tables, _cam(), W, H, max_depth=DEPTH)
    for _ in range(4):
        img = r.draw_frame()
    np.testing.assert_array_equal(read_png(out.read_bytes())[..., :3], img)


def test_cli_checkpoint_resume_equals_one_render(tmp_path):
    """2 + 2 samples through --checkpoint / --resume equal 4 samples at once,
    in the linear sum and in the checkpoint's keys."""
    ck1, ck2 = tmp_path / "a.npz", tmp_path / "b.npz"
    png = str(tmp_path / "o.png")
    cli.run([*BASE, "--spp", "2", "--checkpoint", str(ck1), "--output", png])
    part = cli.run([*BASE, "--spp", "2", "--resume", str(ck1), "--checkpoint", str(ck2),
                    "--output", png])
    whole = cli.run([*BASE, "--spp", "4", "--output", png])
    np.testing.assert_allclose(part["image"] * 4, whole["image"] * 4, atol=1e-6)
    ck = np.load(ck2)
    assert sorted(ck.files) == ["acc", "depth", "fingerprint", "next_sample", "shape"]
    assert int(ck["next_sample"]) == 5 and tuple(ck["shape"]) == (H, W)
    assert int(ck["depth"]) == DEPTH and ck["acc"].dtype == np.float32
    np.testing.assert_allclose(ck["acc"], whole["image"] * 4, atol=1e-6)
    # a checkpoint of another camera, depth or resolution is refused
    with pytest.raises(SystemExit, match="fingerprint"):
        cli.run([*BASE[:5], "0,1,2.5", *BASE[6:], "--spp", "1", "--resume", str(ck1),
                 "--output", png])
    with pytest.raises(SystemExit, match="does not match"):
        cli.run(["-r", f"{W},{H}", "-b", "3", *BASE[4:], "--spp", "1", "--resume", str(ck1),
                 "--output", png])


def test_fingerprint_equals_the_jax_digest(tables):
    """Same scene, camera and settings -> the same digest in both packages,
    so a checkpoint of one resumes in the other."""
    jt = jcornell().upload()
    for nee, depth in (("reference", 2), ("physical", 5)):
        want = jcli._render_fingerprint(jt, _cam(JCamera), W, H, depth, nee)
        assert cli._render_fingerprint(tables, _cam(), W, H, depth, nee) == want
    moved = _cam()
    moved.process_key_input({"d"}, 0.25)
    assert cli._render_fingerprint(tables, moved, W, H, 2, "reference") != want


def test_cli_trace_writes_a_chrome_trace(tmp_path):
    cli.run(["-r", "8,8", "-b", "1", "--spp", "1", "--device", "cpu", "--trace",
             str(tmp_path / "tr"), "--output", str(tmp_path / "t.png")])
    trace = tmp_path / "tr" / "trace.json"
    assert trace.stat().st_size > 1000 and b"traceEvents" in trace.read_bytes()[:4096]


def test_cli_progressive_without_jax(tmp_path):
    """A --progressive run and a --checkpoint run in a fresh interpreter
    import neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "from vulkan_raytracer_tpu_torch import cli, viewer\n"
        "base = ['-r', '12,12', '--spp', '2', '-b', '2', '--device', 'cpu']\n"
        f"assert cli.main(base + ['--progressive', '--output', {str(tmp_path / 'p.png')!r}]) == 0\n"
        f"assert cli.main(base + ['--checkpoint', {str(tmp_path / 'c.npz')!r},"
        f" '--output', {str(tmp_path / 'c.png')!r}]) == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'vulkan_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX" in proc.stdout and "frame 2" in proc.stdout
    assert (tmp_path / "p.png").stat().st_size > 0 and (tmp_path / "c.npz").stat().st_size > 0


def test_frame_time_tool_needs_a_card():
    """tools/bench_torch_progressive.py measures on a card only: without one
    it exits 2 and prints no result."""
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "bench_torch_progressive.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 2 and not proc.stdout, proc.stdout + proc.stderr
    assert "needs an NVIDIA card" in proc.stderr
