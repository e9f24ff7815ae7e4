"""A whole frame as one program of the torch port (``render/renderer.py``,
``integrator.Waves.frame``, ``renderer._frame_program``).

On CUDA tables ``render_image`` runs a frame that it does not band as one
program, as the JAX package compiles ``_render_batch`` into one ``jit``:
``WHILE (w < waves) { wave; samples += k }`` and the frame's image; and a
progressive ``Renderer`` frame is one program too, as JAX compiles
``_frame_step``: the one-sample wave with its radiance, then the
accumulation, tonemap, quantisation and decimation.  Held here on the CPU
with the stand-in graphs of ``tests/test_torch_graphs.py`` (the host-read
replay of the same program tree), on a 32x32 frame at depth 3 of the
Cornell box and of the textured glb (MASK and BLEND alpha: its resample
loops nest three deep, frame, bounce, resample):

* the frame program's replay bit-equal to the per-wave path
  (``render_lanes`` then ``wave.frame_image``, a program a wave), 4 spp in
  2 waves (the cap lowered): images, rays, launches and the waves counted
  from the frame loop's row; the program's tree;
* the replay against the JAX ``render_image`` (``_render_batch`` +
  ``_postprocess``) within ``tests/test_torch_render.py``'s bar, RMSE <
  2e-3, rays within 0.1%;
* the progressive program's replay bit-equal to ``_frame_step`` (the
  preview and 2 frames, at the frame's size and on a decimated display),
  and at ``tests/test_torch_progressive.py``'s frame within its
  tolerances of the JAX ``Renderer`` (the accumulation within rtol 1e-5,
  the image within one level);
* two ``Renderer``s on one scene keeping their own accumulations, and no
  tensor of host data in a frame whose camera did not move;
* a second ``render_image`` with another start sample launching the same
  program (0 captures), another spp capturing one more.

Marked ``cuda`` (they skip without a card): every instance of
``frame_post_kernel`` bit-equal to its plain version at ragged and full
frame sizes, and the frame programs through the device loops bit-equal to
the host-read replay and to the per-wave path, one program launch a frame.
"""

import gc
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the card's machine has no jax; only the cuda-marked tests run there
    import jax  # noqa: F401

    from vulkan_raytracer_tpu.render.renderer import Renderer as JRenderer
    from vulkan_raytracer_tpu.render.renderer import render_image as jrender_image
    from vulkan_raytracer_tpu.scene import scenegraph as jsg
    from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
    from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
except ImportError:
    jax = None

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import test_torch_graphs as tg  # noqa: E402
import torch_glb_assets  # noqa: E402
from vulkan_raytracer_tpu_torch.ops import wave  # noqa: E402
from vulkan_raytracer_tpu_torch.render import graphs, integrator, renderer  # noqa: E402
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.camera import Camera  # noqa: E402

W = H = 32
DEPTH = 3
SPP = 4
RMSE_BAR = 2e-3  # tests/test_torch_render.py
CAMS = {"cornell": ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0]),  # bench cfg1
        "textured_glb": tg.TEXTURED, "gallery_instanced": ([0.0, 1.2, 5.0], [0.0, -0.25, -1.0])}


def _scene(name: str, sg=tsg):
    """The Cornell box or the textured glb (tools/torch_glb_assets.py), as
    a scene of ``sg``'s package."""
    if name == "cornell":
        return cornell_box_scene() if sg is tsg else jcornell()
    s = sg.Scene()
    with tempfile.TemporaryDirectory() as tmp:
        s.load_model(torch_glb_assets.write_textured_glb(tmp))
    return s


def _tables(name: str, device="cpu"):
    tables = _scene(name).upload(device)
    assert tables.has_alpha == (name == "textured_glb")
    return tables


def _cam(name: str, cls=Camera):
    pos, direction = CAMS[name]
    return cls(position=np.array(pos), direction=np.array(direction))


def _two_waves(monkeypatch) -> None:
    """4 spp of a 32x32 frame in 2 waves of 2 samples: the cap lowered."""
    monkeypatch.setattr(renderer, "MAX_LANES_PER_PASS", 2 * W * H)
    assert renderer.samples_per_wave(W * H, SPP) == 2


def _per_wave(tables, name: str, tonemap=False, as_uint8=False):
    """The frame as ``render_image`` ran it before: ``render_lanes`` (a
    program a wave), then ``wave.frame_image``: (image, rays)."""
    cam = _cam(name)
    cam.aspect = W / H
    vi, pi = renderer.camera_uniforms(cam)
    with torch.inference_mode():
        lanes = integrator.block_lanes(W, H, tables.device)
        acc, rays, bands, waves = renderer.render_lanes(tables, vi, pi, W, H, DEPTH, SPP, 1,
                                                        lanes)
        img = wave.frame_image(acc, lanes, SPP, tonemap, as_uint8)
        rays, = graphs.settle(rays)
    assert bands == 0 and waves == SPP // renderer.samples_per_wave(W * H, SPP)
    return img.cpu().numpy().reshape(H, W, 3), rays


def _counts():
    return (integrator.launch_counts(loops=False, skipped=True), dict(integrator.BOUNCE_WIDTHS),
            dict(integrator.ALPHA_LOOP))


@pytest.mark.parametrize("name", ["cornell", "textured_glb"])
def test_frame_program_bit_equal_to_per_wave(name, monkeypatch):
    """``render_image`` as one stand-in program, replayed, against the
    per-wave path: images and rays bit-equal, equal launches, bounce widths
    and alpha loop; one program launch and capture for the frame, its waves
    counted from its loop's row; the tree ``zero; WHILE frame { wave; step
    samples }; image``."""
    gc.collect()
    tables = _tables(name)
    _two_waves(monkeypatch)
    tg._plain_calls(monkeypatch)
    captures = tg._stand_in_programs(monkeypatch)
    integrator.reset_counters()
    want, want_rays = _per_wave(tables, name)
    want_counts = _counts()
    assert len(captures) == 1  # one program a wave shape
    integrator.reset_counters()
    graphs.reset_stats()
    got, rays = renderer.render_image(tables, _cam(name), W, H, SPP, max_depth=DEPTH,
                                      tonemap=False)
    assert np.array_equal(got, want) and rays == want_rays and _counts() == want_counts
    assert graphs.STATS["launches"] == graphs.STATS["captured"] == 1
    assert renderer.LAST_RENDER["waves"] == 2 and renderer.LAST_RENDER["bands"] == 0
    (_, cap), = captures[1:]
    frame, = [n for n in cap.nodes if isinstance(n, graphs._Node)]
    assert frame.role == "frame" and frame.kind == "while"
    assert tg._shape(cap.nodes) == f"p while:frame({tg._want_shape(tables, W * H * 2)}) p"
    ops, found = tg._host_reads(cap.nodes)
    assert ops > 100 and not found, found
    key, = [k for k in graphs.cache(tables).graphs if k[0] == "frame"]
    assert key[1:4] == (W * H, 2, 2)  # pixels, samples a wave, waves


@pytest.mark.skipif(jax is None, reason="needs jax")
@pytest.mark.parametrize("name", ["cornell", "textured_glb"])
def test_frame_program_matches_jax(name, monkeypatch):
    """The frame program's replay against the JAX ``render_image`` (its
    ``_render_batch`` and ``_postprocess``) on the same scene: RMSE within
    the 2e-3 bar, rays within 0.1% (a lane whose hit flips on a last-ulp
    difference traces other rays)."""
    tables = _tables(name)
    tg._plain_calls(monkeypatch)
    tg._stand_in_programs(monkeypatch)
    got, rays = renderer.render_image(tables, _cam(name), W, H, SPP, max_depth=DEPTH,
                                      tonemap=False)
    assert graphs.STATS["launches"] >= 1 and renderer.LAST_RENDER["waves"] == 1
    want, jrays = jrender_image(_scene(name, jsg).upload(), _cam(name, JCamera), W, H,
                                spp=SPP, max_depth=DEPTH, tonemap=False)
    rmse = float(np.sqrt(np.mean((got - np.asarray(want)) ** 2)))
    assert rmse < RMSE_BAR and abs(rays - jrays) <= 1e-3 * jrays, (rmse, rays, jrays)
    assert got.mean() > 1e-3


def _frames(tables, name: str, disp, n=3, renderer_=None):
    """The preview and ``n - 1`` samples of a ``Renderer``: (images, its
    accumulation, rays)."""
    r = renderer_ or renderer.Renderer(tables, _cam(name), W, H, DEPTH)
    imgs = [r.draw_frame(display_size=disp) for _ in range(n)]
    return imgs, r.accum.clone(), r.rays_traced


@pytest.mark.parametrize("name, disp", [("cornell", None), ("cornell", (10, 12)),
                                        ("textured_glb", None)])
def test_progressive_program_bit_equal_to_frame_step(name, disp, monkeypatch):
    """The progressive ``Renderer`` as one stand-in program a frame,
    replayed, against ``_frame_step`` (one wave of one sample, then the
    frame's tail): the preview and two frames, at the frame's size and in
    10x12 cells of 3x2 pixels (2 rows and 8 columns no cell shows): images,
    the accumulation and rays bit-equal; one capture, one program launch a
    frame, the tail inside it."""
    gc.collect()  # no cache of an earlier test's tables of the signature
    tables = _tables(name)
    tg._plain_calls(monkeypatch)
    want = _frames(tables, name, disp)
    captures = tg._stand_in_programs(monkeypatch)
    graphs.reset_stats()
    integrator.reset_counters()
    got = _frames(tables, name, disp)
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1]) and got[2] == want[2] and float(got[1].sum()) > 0.0
    assert graphs.STATS["captured"] == 1 and graphs.STATS["launches"] == 3
    assert wave.LAUNCHES["frame_post"] == 0  # the plain tail, inside the program's parts
    (_, cap), = captures
    assert tg._shape(cap.nodes) == tg._want_shape(tables, W * H)


@pytest.mark.skipif(jax is None, reason="needs jax")
def test_progressive_program_matches_jax(monkeypatch):
    """The progressive program's replay against the JAX ``Renderer``
    (``_frame_step``) at ``tests/test_torch_progressive.py``'s frame (the
    Cornell box, 24x24, depth 2, the preview and three samples), with its
    tolerances: each frame's accumulation within rtol 1e-5 and its image
    within one level (a path may flip on a last-ulp difference; at most 2
    values), the preview shown and not kept."""
    w = h = 24
    tables = _tables("cornell")
    tg._plain_calls(monkeypatch)
    tg._stand_in_programs(monkeypatch)
    graphs.reset_stats()
    r = renderer.Renderer(tables, _cam("cornell"), w, h, 2)
    jr = JRenderer(jcornell().upload(), _cam("cornell", JCamera), w, h, max_depth=2)
    for k in range(4):
        img, jimg = r.draw_frame(), np.asarray(jr.draw_frame())
        np.testing.assert_allclose(r.accum.numpy(), np.asarray(jr.accum), rtol=1e-5, atol=1e-7)
        off = np.abs(img.astype(int) - jimg.astype(int)) > 1
        assert off.sum() <= 2, (k, int(off.sum()))
        assert k or (not r.accum.any() and img.max() > 0)
    assert graphs.STATS["launches"] == 4
    assert abs(r.rays_traced - jr.rays_traced) <= 1e-3 * jr.rays_traced


def test_renderers_keep_their_own_accumulations(monkeypatch):
    """Two ``Renderer``s on one scene, of one size, with other cameras, in
    turns: each program reads its own buffers, so each sequence is what it
    is alone; a renderer made after another of its size went launches the
    program captured on that one's buffers (only the second live renderer
    captures); a frame whose camera did not move makes no tensor of host
    data outside its launch, one whose camera moved makes one (the
    camera's)."""
    gc.collect()  # no cache of an earlier test's tables of the signature
    tables = _tables("cornell")
    tg._plain_calls(monkeypatch)
    other = Camera(position=np.array([0.3, 1.1, 2.2]), direction=np.array([0.0, -0.1, -1.0]))
    tg._stand_in_programs(monkeypatch)
    alone_a = _frames(tables, "cornell", None)
    alone_b = _frames(tables, "cornell", None,
                      renderer_=renderer.Renderer(tables, other, W, H, DEPTH))
    graphs.reset_stats()
    a = renderer.Renderer(tables, _cam("cornell"), W, H, DEPTH)
    b = renderer.Renderer(tables, Camera(position=other.position.copy(),
                                         direction=other.direction.copy()), W, H, DEPTH)
    imgs_a, imgs_b = [a.draw_frame()], [b.draw_frame()]  # each captures its program
    mode = tg.HostReads()
    tg._outside_launches(monkeypatch, mode)
    with mode:
        for _ in range(2):
            imgs_a.append(a.draw_frame())
            imgs_b.append(b.draw_frame())
    assert mode.found == [], mode.found
    assert graphs.STATS["captured"] == 1 and graphs.STATS["launches"] == 6
    for imgs, r, alone in ((imgs_a, a, alone_a), (imgs_b, b, alone_b)):
        assert all(np.array_equal(x, y) for x, y in zip(imgs, alone[0]))
        assert torch.equal(r.accum, alone[1]) and r.rays_traced == alone[2]
    assert not torch.equal(a.accum, b.accum)
    a.camera.position = np.array([0.0, 1.0, 2.3])  # a moved camera restarts and is written
    a.camera.position_changed = True
    with mode:
        a.draw_frame()
    assert a.sample_count == 1 and mode.found == ["aten.lift_fresh.default"], mode.found
    assert graphs.STATS["captured"] == 1


def test_program_renderer_resize(monkeypatch):
    """``handle_resize`` through the programs: the renderer's buffers go
    back and a zero accumulation of the new size comes, the rays traced
    before it still count, and the frames after it are ``_frame_step``'s
    (the same sequence on the eager side: images, accumulation and rays
    equal)."""
    tables = _tables("cornell")
    tg._plain_calls(monkeypatch)

    def sequence():
        r = renderer.Renderer(tables, _cam("cornell"), W, H, DEPTH)
        imgs = [r.draw_frame() for _ in range(2)]
        r.handle_resize(16, 12)
        assert r.accum.shape == (16 * 12, 3) and not r.accum.any()
        imgs += [r.draw_frame() for _ in range(2)]
        return imgs, r.accum.clone(), r.rays_traced

    want = sequence()
    tg._stand_in_programs(monkeypatch)
    got = sequence()
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1]) and got[2] == want[2] > 0


def test_frame_program_keyed_by_its_waves(monkeypatch):
    """A second ``render_image`` with another start sample launches the
    program already captured (the start sample is written on the device)
    and is the per-wave path's frame of that start; another spp captures
    one more program."""
    tables = _tables("cornell")
    tg._plain_calls(monkeypatch)
    cam = _cam("cornell")
    want = renderer.render_image(tables, cam, W, H, 2, max_depth=DEPTH, start_sample=3,
                                 tonemap=False)
    tg._stand_in_programs(monkeypatch)
    renderer.render_image(tables, cam, W, H, 2, max_depth=DEPTH, tonemap=False)
    graphs.reset_stats()
    got = renderer.render_image(tables, cam, W, H, 2, max_depth=DEPTH, start_sample=3,
                                tonemap=False)
    assert graphs.STATS["captured"] == 0 and graphs.STATS["launches"] == 1
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    renderer.render_image(tables, cam, W, H, 1, max_depth=DEPTH, tonemap=False)
    assert graphs.STATS["captured"] == 1
    assert sorted(k[1:4] for k in graphs.cache(tables).graphs if k[0] == "frame") == [
        (W * H, 1, 1), (W * H, 2, 1)]


def test_frame_post_tool_needs_a_card():
    """tools/bench_torch_frame_post.py times on a card only: without one it
    exits 2 and says so."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tool = Path(__file__).resolve().parent.parent / "tools" / "bench_torch_frame_post.py"
    proc = subprocess.run([sys.executable, str(tool)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 2 and "needs an NVIDIA card" in proc.stderr


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _hdr(n: int, seed: int, device) -> torch.Tensor:
    """Linear values: zeros, values across [0, 1], HDR values and a NaN."""
    r = np.random.default_rng(seed)
    acc = (r.uniform(0.0, 2.0, (n, 3)) ** 4).astype(np.float32)
    acc[r.uniform(size=n) < 0.1] = 0.0
    acc[n // 2] = np.nan
    return torch.as_tensor(acc, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(30, 17), (512, 512), (960, 540), (1920, 1080)])
def test_frame_image_instances_bit_equal(size):
    """``frame_post_kernel``'s headless instances (uint8 and float32, with
    and without tonemap) against ``frame_image_reference``: over the block
    order (at 30x17 the edge blocks' rows are not multiples of 4 pixels), a
    random permutation (no run of 4 pixels), and a sum that starts 12 bytes
    into its buffer (not 16-byte aligned): bit-equal."""
    dev = _card()
    w, h = size
    n = w * h
    block = integrator.block_lanes(w, h, dev)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(5)).to(dev)
    buf = _hdr(n + 1, seed=w, device=dev)
    for lanes, acc in ((block, buf[:n]), (perm, buf[:n]), (block, buf[1:])):
        for tonemap in (True, False):
            for as_uint8 in (True, False):
                before = wave.LAUNCHES["frame_post"]
                got = wave.frame_image(acc, lanes, 7, tonemap, as_uint8)
                want = wave.frame_image_reference(acc, lanes, 7, tonemap, as_uint8)
                torch.cuda.synchronize()
                assert wave.LAUNCHES["frame_post"] == before + 1
                assert torch.equal(got, want) or (not as_uint8 and torch.allclose(
                    got, want, rtol=0, atol=0, equal_nan=True)), (size, tonemap, as_uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("size, disp", [((30, 17), (17, 30)), ((30, 17), (4, 7)),
                                        ((512, 512), (512, 512)), ((512, 512), (120, 160)),
                                        ((1920, 1080), (1080, 1920))])
def test_frame_progressive_instances_bit_equal(size, disp):
    """``frame_post_kernel``'s progressive instances (a thread four pixels
    at the frame's size; the decimating one over ragged cells) against
    ``frame_progressive_reference``: the preview sample 0, then samples 1
    and 6; the image and the accumulation bit-equal after each."""
    dev = _card()
    w, h = size
    n = w * h
    accum = _hdr(n, seed=1, device=dev)
    want_accum = accum.clone()
    for k in (0, 1, 6):
        rad = _hdr(n, seed=k + 2, device=dev)
        got = wave.frame_progressive(rad, accum, torch.tensor([k], device=dev), w, h, *disp)
        want = wave.frame_progressive_reference(rad, want_accum, k, w, h, *disp)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (size, disp, k)
        assert torch.allclose(accum, want_accum, rtol=0, atol=0, equal_nan=True), (size, disp, k)


def _render_frames(tables, name: str, sides, monkeypatch):
    out = {}
    for side in sides:
        graphs_rule, loops_rule = tg._SIDES[side]
        monkeypatch.setattr(graphs, "_graphs_preferred", graphs_rule)
        monkeypatch.setattr(graphs, "_device_loops_preferred", loops_rule)
        integrator.reset_counters()
        graphs.reset_stats()
        img, rays = renderer.render_image(tables, _cam(name), W, H, SPP, max_depth=DEPTH,
                                          tonemap=False)
        out[side] = (img, rays, _counts(), graphs.STATS["launches"],
                     renderer.LAST_RENDER["waves"])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "textured_glb", "gallery_instanced"])
def test_frame_programs_on_the_card(name, monkeypatch):
    """A frame of 4 spp in 2 waves through the device loops (one program
    launch: its waves under one WHILE; the gallery's instance IFs armed
    once for the frame), the host-read replay of the same program and the
    per-wave path (eager): images and rays bit-equal, equal launches,
    widths and alpha loop, 2 waves counted; then the progressive Renderer's
    program against ``_frame_step``: images and the accumulation bit-equal,
    one program launch a frame and no stream launch of the tail."""
    dev = _card()
    if name == "gallery_instanced":
        tables = tg._gallery_tables(monkeypatch, "cuda")
    else:
        tables = _tables(name, dev)
    _two_waves(monkeypatch)
    out = _render_frames(tables, name, ("device", "replay", "eager", "device"), monkeypatch)
    img, rays, counts, launches, waves = out["device"]
    assert launches == 1 and waves == 2
    for side, (img_s, rays_s, counts_s, launches_s, waves_s) in out.items():
        assert np.array_equal(img_s, img) and rays_s == rays and counts_s == counts, side
        assert waves_s == 2
    assert np.isfinite(img).all() and img.mean() > 0.0
    monkeypatch.setattr(graphs, "_graphs_preferred", tg._SIDES["device"][0])
    monkeypatch.setattr(graphs, "_device_loops_preferred", tg._SIDES["device"][1])
    for disp in (None, (10, 12)):
        integrator.reset_counters()
        graphs.reset_stats()
        r = renderer.Renderer(tables, _cam(name), W, H, DEPTH)
        first = r.draw_frame(display_size=disp)
        assert wave.LAUNCHES["frame_post"] == 0  # no launch outside the program
        imgs, accum, rays = _frames(tables, name, disp, n=2, renderer_=r)
        assert graphs.STATS["launches"] == 3 and wave.LAUNCHES["frame_post"] == 3
        monkeypatch.setattr(graphs, "_graphs_preferred", lambda t: False)
        want = _frames(tables, name, disp)
        monkeypatch.setattr(graphs, "_graphs_preferred", tg._SIDES["device"][0])
        assert all(np.array_equal(a, b) for a, b in zip([first, *imgs], want[0])), disp
        assert torch.equal(accum, want[1]) and rays == want[2], disp
