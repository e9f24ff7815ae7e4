"""The wave's tail, the instance scans' skipped launches and the frame's
post-processing of the torch port, held on the CPU.

* ``wave.wave_sum_reference`` (the deferred sky, the repacked wave's scatter
  and the sum over the wave's samples, sample 0 first) bit-equal to the
  port's former composition (``sample_equirect`` x strength x sky weight,
  ``index_copy_`` by slot, ``reshape(k, -1, 3).sum(0)``, ``add_``) on seeded
  states of 256 pixels, repacked and not, at k = 1, 2 and 8 (aten's CPU sum
  over the samples adds them one after another at this width; at a width
  whose columns do not fill its vectors it reduces the tail in another
  order, which the stated order does not follow); without the per-lane
  radiance (``radiance=False``, what ``render_lanes``' waves ask for) it
  returns none and adds the same sum and rays, at k = 1, 2, 3 and 8, with
  edge, NaN and infinite directions, under a sky with NaN, infinite and
  negative texels too; a small ``render_lanes``
  frame (dense, and repacked on BVH streams) sums the same with its waves
  asked for their radiance; the tile of the kernel's tail covers its block;
* its sky term against the JAX ``sample_equirect`` x strength x sky weight
  (render/integrator.py:1128-1137) on a seeded 16x32 HDR sky and the
  directions where the lookup's pieces meet their edges: x = z = 0 (both
  signs of zero), |y| = 1 and beyond (the clamp), u at the wrap: rtol 1e-6,
  as ``tests/test_torch_ops.py``'s lookup (atan2 and asin differ in the last
  ulp between the frameworks);
* ``trace.instance_step_reference``, which merges a launch only where a lane
  touched its instance's box: with no lane touching and the launch's output
  poisoned (a launch an IF skipped leaves whatever its buffers held), the
  running t, id and occlusion stay as they were, for a dense and a BLAS
  prototype;
* the frame's plain post-processing (``wave.frame_image_reference``,
  ``wave.frame_progressive_reference``) bit-equal to the JAX
  ``_postprocess`` and ``_frame_step`` (render/renderer.py:244-292, the
  latter with its sample's radiance given) at a display size that does not
  divide the frame, the preview frame included;
* the new modes and the IF control block against the kernels' source
  enums, and each new wrapper, its launch failing, raising without running
  its plain version.

Marked ``cuda`` (they skip without a card): each kernel
(``wave_sum_kernel``, ``frame_post_kernel``, the instance step on poisoned
outputs) bit-equal to its plain version on the same inputs; the tail at k =
1, 2, 3, 8 and 16, repacked or not, with its radiance asked for or not, over
a sky whose NaN, infinite and negative texels lie beside lanes of zero sky
weight (+0 and -0), and edge, NaN and infinite directions.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the card's machine has no jax; only the cuda-marked tests run there
    import jax
    import jax.numpy as jnp

    from vulkan_raytracer_tpu.ops import texture as jtex
    from vulkan_raytracer_tpu.render import renderer as jrenderer
    from vulkan_raytracer_tpu.scene.procedural import sky_hdr as jsky_hdr
except ImportError:
    jax = None
from test_torch_instancing import instanced_scene
from vulkan_raytracer_tpu_torch.ops import _ext, dense, instanced, trace, wave
from vulkan_raytracer_tpu_torch.ops.math3 import V3
from vulkan_raytracer_tpu_torch.ops.texture import pack_envmap, sample_equirect
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
from vulkan_raytracer_tpu_torch.scene.procedural import sky_hdr

RTOL_SKY = 1e-6
N = 256  # pixels of a seeded wave


def _sky_tables(device="cpu", strength=1.7, poison=False):
    """The tables the tail reads: a seeded 16x32 HDR sky and its strength;
    with ``poison``, a NaN, infinite and negative texel in every row, whose
    fetch makes a lane of zero sky weight NaN or -0 where it is not skipped."""
    sky = sky_hdr(h=16, w=32)
    if poison:
        sky = sky.copy()
        for y in range(16):
            sky[y, (5 * y) % 32] = (np.nan, 1.0, 2.0)
            sky[y, (5 * y + 11) % 32] = (np.inf, -np.inf, 0.5)
            sky[y, (5 * y + 20) % 32] = (-3.0, 0.25, -0.0)
    return types.SimpleNamespace(skybox=pack_envmap(sky, device),
                                 skybox_strength=torch.tensor(strength, dtype=torch.float32,
                                                              device=device))


def _state(n: int, k: int, repack: bool, seed: int, device="cpu") -> dict:
    """A wave's final state over n pixels x k samples, made from ``seed``: unit
    directions, values and sky weights (zero on a third of the lanes, as on
    lanes that never missed), and on a repacked wave a random slot
    permutation."""
    r = np.random.default_rng(seed)
    lanes = n * k
    d = r.normal(size=(lanes, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sky_w = r.uniform(0.0, 2.0, (lanes, 3)).astype(np.float32)
    sky_w[r.uniform(size=lanes) < 1 / 3] = 0.0
    sky_w[r.uniform(size=lanes) < 0.05] = -0.0
    value = (r.uniform(0.0, 3.0, (lanes, 3)) ** 3).astype(np.float32)
    value[r.uniform(size=lanes) < 0.05] = -0.0

    def v3(a):
        return V3(*(torch.as_tensor(a[:, c].copy(), device=device) for c in range(3)))

    s = {"direction": v3(d), "value": v3(value), "sky_w": v3(sky_w),
         "active": torch.zeros(lanes, dtype=torch.bool, device=device)}
    if repack:
        s["slot"] = torch.as_tensor(r.permutation(lanes), device=device)
    return s


def _former_tail(tables, s, repack, total, frame_rays, rays, k):
    """The port's tail before ``wave.wave_sum``: ``integrator._radiance``,
    ``_lane_radiance``'s ``index_copy_`` and ``_add_wave``."""
    sky = sample_equirect(tables.skybox, s["direction"].to_array()) * tables.skybox_strength
    value = (s["value"] + s["sky_w"] * V3.from_array(sky)).to_array()
    if repack:
        value = torch.empty_like(value).index_copy_(0, s["slot"], value)
    total.add_(value if k == 1 else value.reshape(k, -1, 3).sum(dim=0))
    frame_rays.add_(rays)
    return value


def _sums(n: int, seed: int, device="cpu"):
    r = np.random.default_rng(seed)
    total = torch.as_tensor(r.uniform(0.0, 5.0, (n, 3)).astype(np.float32), device=device)
    return total, torch.tensor(1234, device=device), torch.tensor(567, device=device)


@pytest.mark.parametrize("repack", [False, True])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_wave_sum_reference_is_the_former_tail(k, repack):
    tables = _sky_tables()
    s = _state(N, k, repack, seed=10 * k + repack)
    total, frame_rays, rays = _sums(N, seed=k)
    want_total, want_rays = total.clone(), frame_rays.clone()
    want = _former_tail(tables, s, repack, want_total, want_rays, rays, k)
    got = wave.wave_sum(tables, s, repack, total, frame_rays, rays, k, True)  # the CPU: plain
    assert torch.equal(got, want) and torch.equal(total, want_total)
    assert int(frame_rays) == int(want_rays) == 1234 + 567
    assert got.shape == (N * k, 3) and torch.isfinite(got).all()


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where NaN (whatever its payload)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("repack", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_wave_sum_without_radiance_adds_the_same(k, repack, poison):
    """The tail asked for no radiance returns none, and adds the sum and the
    rays it adds when asked (the plain version on the CPU)."""
    tables = _sky_tables(poison=poison)
    s = _state(N, k, repack, seed=20 * k + repack)
    total, frame_rays, rays = _sums(N, seed=k)
    want_total, want_rays = total.clone(), frame_rays.clone()
    want = wave.wave_sum(tables, s, repack, want_total, want_rays, rays, k, True)
    assert want.shape == (N * k, 3)
    assert wave.wave_sum(tables, s, repack, total, frame_rays, rays, k, False) is None
    assert _same(total, want_total) and int(frame_rays) == int(want_rays) == 1234 + 567
    assert bool(torch.isnan(want).any()) == poison


@pytest.mark.parametrize("scene", ["dense", "repacked"])
def test_render_lanes_sums_the_same_with_radiance(scene, monkeypatch):
    """A small ``render_lanes`` frame (its waves ask for no radiance) sums
    and counts rays as it does with its waves asked for their radiance."""
    from vulkan_raytracer_tpu_torch.render import integrator, renderer
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    tables = cornell_box_scene().upload("cpu", traversal="bvh" if scene == "repacked" else "auto")
    monkeypatch.setattr(integrator, "_repack_preferred", lambda t: scene == "repacked")
    monkeypatch.setattr(renderer, "MAX_LANES_PER_PASS", 256)  # waves of 2 samples
    cam = Camera(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))
    view_inv, proj_inv = renderer.camera_uniforms(cam)
    lanes = torch.arange(12 * 10, dtype=torch.int64)

    def frame():
        acc, rays, _, waves = renderer.render_lanes(tables, view_inv, proj_inv, 12, 10, 3, 4, 1,
                                                    lanes)
        return acc, int(rays), waves

    got = frame()
    asked = []
    run = integrator.Waves.run

    def with_radiance(self, first, k, pixel_order=False, radiance=False):
        asked.append(radiance)
        out, rays = run(self, first, k, pixel_order, True)
        assert out.shape == (lanes.shape[0] * k, 3)
        return out, rays

    monkeypatch.setattr(integrator.Waves, "run", with_radiance)
    want = frame()
    assert asked == [False] * got[2] and got[2] == 2
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:] and got[1] > 0


def test_tail_refuses_lanes_beyond_its_32_bit_indices(monkeypatch):
    """On a card the tail indexes its lanes' floats in 32 bits: a wave of
    ``wave.MAX_SUM_LANES`` lanes or more raises before any launch."""
    launched = []
    monkeypatch.setattr(wave, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_ext, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(wave, "MAX_SUM_LANES", 2 * 64)
    with pytest.raises(ValueError, match="32 bits"):
        wave.wave_sum(_sky_tables(), _state(64, 2, False, seed=1), False, *_sums(64, seed=1), 2,
                      False)
    assert launched == []
    wave.wave_sum(_sky_tables(), _state(63, 2, False, seed=1), False, *_sums(63, seed=1), 2, False)
    assert len(launched) == 1


def test_tail_tiles_cover_their_block():
    """A tile of the kernel's tail is a power of two of pixels, at least a
    warp, times as many samples as a chunk holds: the block's threads."""
    for k in range(1, 40):
        tile = wave.sum_tile(k)
        rows = wave.SUM_THREADS // tile
        assert tile * rows == wave.SUM_THREADS and tile >= 32 and tile & (tile - 1) == 0
        assert rows == min(wave.SUM_ROWS, 1 << (k - 1).bit_length())


def _edge_directions() -> np.ndarray:
    """Directions at the lookup's edges: x = z = 0 with both signs of zero,
    the poles and beyond them (the clamp), u at the wrap (z = +-0 with x <
    0), and the seams of the atan2 quadrants."""
    z, nz = 0.0, -0.0
    rows = [(z, 1.0, z), (z, -1.0, z), (nz, 1.0, nz), (z, 1.0, nz), (nz, -1.0, z),
            (z, 1.0000001, z), (z, -1.0000001, z), (z, 1.5, z), (-1.0, 0.0, z), (-1.0, 0.0, nz),
            (-1.0, 0.3, z), (-0.7, -0.7, nz), (1.0, 0.0, z), (1.0, 0.0, nz), (z, 0.0, 1.0),
            (z, 0.0, -1.0), (nz, 0.5, -0.8), (0.6, 0.0, 0.8), (z, z, z)]
    return np.array(rows, np.float32)


@pytest.mark.skipif(jax is None, reason="needs jax")
def test_sky_term_matches_jax():
    r = np.random.default_rng(3)
    d = np.concatenate([_edge_directions(), r.normal(size=(500, 3)).astype(np.float32)])
    d[19:] /= np.linalg.norm(d[19:], axis=1, keepdims=True)
    n = d.shape[0]
    sky_w = r.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    value = r.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    strength = 1.7
    tables = _sky_tables(strength=strength)
    s = {"direction": V3.from_array(torch.as_tensor(d)),
         "value": V3.from_array(torch.as_tensor(value)),
         "sky_w": V3.from_array(torch.as_tensor(sky_w))}
    got = wave.radiance_reference(tables, s).numpy()
    env = jtex.pack_envmap(jsky_hdr(h=16, w=32))
    sky = np.asarray(jtex.sample_equirect(env, jnp.asarray(d))) * np.float32(strength)
    want = value + sky_w * sky
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL_SKY)


def _poisoned_step(shadow: bool, blas: bool, device="cpu"):
    """Two steps of a scan whose rays touch no instance's box, the second
    merging a poisoned launch: (the state after the first, after the
    second).  The poison would win every lane it was read on: t = -1e30 and
    ids out of every table's range."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(dense, "DENSE_MAX_TRIS", 64)
        tables = instanced_scene(tsg, n_soup_instances=2).upload(device, instancing=True)
    scan = list(instanced._scan(tables.inst))
    x0 = next(x for x in scan if (x.group.pblas is not None) == blas)
    x1 = scan[-1]
    n = 64
    r = np.random.default_rng(5)
    o = np.full((n, 3), 100.0, np.float32) + r.uniform(0, 1, (n, 3)).astype(np.float32)
    d = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, 1))
    rays = tuple(torch.as_tensor(c.copy(), device=device) for c in (*o.T, *d.T))
    active = torch.ones(n, dtype=torch.bool, device=device)
    t_max = 1e32 if not shadow else torch.full((n,), 50.0, device=device)
    st0 = trace.instance_step_reference(tables, {}, rays, active, t_max, 1e-7, None, x0, shadow)
    assert not st0["touches"].any()
    poison_t = torch.full((n,), -1e30, device=device)
    poison_hit = torch.full((n,), 2**30, dtype=torch.int32, device=device)
    prev = (x0, None if shadow else poison_t, poison_hit)
    st1 = trace.instance_step_reference(tables, dict(st0), rays, active, t_max, None, prev, x1,
                                        shadow)
    return st0, st1


@pytest.mark.parametrize("blas", [False, True])
@pytest.mark.parametrize("shadow", [False, True])
def test_step_reads_no_launch_that_no_lane_touched(shadow, blas):
    st0, st1 = _poisoned_step(shadow, blas)
    for key in ("occ",) if shadow else ("t_best", "enc"):
        assert torch.equal(st1[key], st0[key]), key
    if not shadow:
        assert (st1["enc"] == -1).all() and (st1["t_best"] == 1e32).all()


def _hdr_sums(n: int, seed: int) -> np.ndarray:
    """A frame's linear sums: zeros, values across [0, 1] and HDR values."""
    r = np.random.default_rng(seed)
    acc = (r.uniform(0.0, 2.0, (n, 3)) ** 4).astype(np.float32)
    acc[r.uniform(size=n) < 0.1] = 0.0
    return acc


@pytest.mark.skipif(jax is None, reason="needs jax")
@pytest.mark.parametrize("tonemap, as_uint8", [(True, True), (True, False), (False, True),
                                               (False, False)])
def test_frame_image_matches_jax_postprocess(tonemap, as_uint8):
    w, h, spp = 20, 14, 3
    n = w * h
    lanes = torch.as_tensor(np.random.default_rng(1).permutation(n))
    pixels = _hdr_sums(n, seed=2)
    acc = torch.as_tensor(pixels)[lanes]  # aligned with the lanes
    got = wave.frame_image(acc, lanes, spp, tonemap, as_uint8).numpy()  # the CPU: plain
    want = np.asarray(jrenderer._postprocess(jnp.asarray(pixels), spp, tonemap, as_uint8))
    assert got.dtype == want.dtype == (np.uint8 if as_uint8 else np.float32)
    if as_uint8:
        assert np.array_equal(got, want)
    else:  # the same float32 ops in the same order
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.skipif(jax is None, reason="needs jax")
def test_frame_progressive_matches_jax_frame_step(monkeypatch):
    """Three frames (the preview sample 0, then 1 and 2) of a 20x14 frame
    shown in 6x4 cells of 3x3 pixels (two columns and two rows no cell
    shows): the uint8 image and the accumulation after each bit-equal to the
    JAX ``_frame_step`` given the same radiance."""
    w, h, dh, dw = 20, 14, 4, 6
    radiances = [_hdr_sums(w * h, seed=7 + k) for k in range(3)]
    # the sample's radiance rides in as the frame step's tables
    monkeypatch.setattr(jrenderer, "render_sample", lambda rad, *args: (rad, jnp.int32(0)))
    step = jax.jit(jrenderer._frame_step.__wrapped__, static_argnums=(3, 4, 6, 7, 8))
    eye = jnp.eye(4, dtype=jnp.float32)
    accum = torch.full((w * h, 3), 9.0)  # the preview zeroes it
    jaccum = jnp.asarray(accum.numpy())
    for k, rad in enumerate(radiances):
        img = wave.frame_progressive(torch.as_tensor(rad), accum, k, w, h, dh, dw)  # plain
        jaccum, jimg, _ = step(jnp.asarray(rad), eye, eye, w, h, jaccum, 3, dh, dw,
                               jnp.uint32(k))
        assert img.shape == (dh, dw, 3) and img.dtype == torch.uint8
        assert np.array_equal(img.numpy(), np.asarray(jimg)), k
        assert np.array_equal(accum.numpy(), np.asarray(jaccum)), k
    # the rows and columns no cell shows still accumulate
    assert np.array_equal(accum.numpy(), radiances[1] + radiances[2])


def _enum(src: str, name: str) -> tuple:
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return tuple(w.strip() for w in body.split(",") if w.strip())


def test_modes_are_the_kernel_source_enums():
    """``wave.SUM_MODES`` and ``wave.FRAME_MODES`` name csrc/wave.cu's
    ``SumMode`` and ``FrameMode`` in order, the instance launch's IF control
    block in csrc/trace.cu has the resample loops' layout
    (``wave.LOOP_WORDS``), and the new launchers are bound."""
    csrc = Path(wave.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "wave.cu").read_text()
    assert _enum(src, "SumMode") == tuple(
        "kSum" + m.capitalize() for m in ("lanes", "scatter", "add")) and wave.SUM_MODES == (
        "lanes", "scatter", "add")
    assert _enum(src, "FrameMode") == ("kFrameImage", "kFrameProgressive")
    assert f"constexpr int kThreads = {wave.SUM_THREADS};" in src
    assert f"constexpr int kSumRows = {wave.SUM_ROWS};" in src
    assert wave.FRAME_MODES == ("image", "progressive")
    trace_src = (csrc / "trace.cu").read_text()
    assert [w.replace("kIf", "kLoop") for w in _enum(trace_src, "IfWord")] == list(
        wave.LOOP_WORDS)
    assert '#include "graph_test.cuh"' in trace_src
    assert {"wave_sum_launch", "frame_post_launch", "graph_loops_add_copy"} <= set(
        _ext._SIGNATURES)


@pytest.mark.parametrize("kernel", ["wave_sum", "frame_image", "frame_progressive"])
def test_failed_launch_raises(kernel, monkeypatch):
    """A wrapper routed to its kernel whose launch fails raises, and never
    runs its plain version."""
    plain = []
    for name in ("wave_sum_reference", "frame_image_reference", "frame_progressive_reference"):
        monkeypatch.setattr(wave, name, lambda *a, _n=name, **k: plain.append(_n))

    def launch(fn, device, *args):
        raise RuntimeError(f"{fn}: CUDA error 700")

    monkeypatch.setattr(wave, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_ext, "launch", launch)
    before = dict(wave.LAUNCHES)
    n = 64
    calls = {
        "wave_sum": lambda: wave.wave_sum(_sky_tables(), _state(n, 2, True, seed=1), True,
                                          *_sums(n, seed=1), 2, True),
        "frame_image": lambda: wave.frame_image(torch.zeros((n, 3)), torch.arange(n), 4, True,
                                                True),
        "frame_progressive": lambda: wave.frame_progressive(
            torch.zeros((n, 3)), torch.zeros((n, 3)), torch.tensor([3]), 8, 8, 4, 4),
    }
    with pytest.raises(RuntimeError, match="CUDA error"):
        calls[kernel]()
    assert plain == [] and wave.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("radiance", [True, False])
@pytest.mark.parametrize("repack", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 16])
def test_wave_sum_kernel_bit_equal(k, repack, radiance):
    """The tail's kernel against its plain version on 4,099 pixels (no
    tile's multiple, so rows start off 16-byte boundaries): a wave in lane
    order in one launch, a repacked one in two (the scatter, then the
    tiles); over a sky with NaN, infinite and negative texels beside lanes
    of zero sky weight, with edge, NaN and infinite directions.  The
    radiance, the sum and the rays bit-equal (NaN where NaN)."""
    dev = _card()
    for poison in (False, True):
        tables = _sky_tables(dev, poison=poison)
        s = _state(4099, k, repack, seed=k, device=dev)
        total, frame_rays, rays = _sums(4099, seed=k, device=dev)
        want_total, want_rays = total.clone(), frame_rays.clone()
        want = wave.wave_sum_reference(tables, s, repack, want_total, want_rays, rays, k, True)
        before = wave.LAUNCHES["wave_sum"]
        got = wave.wave_sum(tables, s, repack, total, frame_rays, rays, k, radiance)
        torch.cuda.synchronize()
        assert wave.LAUNCHES["wave_sum"] - before == 1 + repack
        assert (got is None) != radiance
        assert radiance is False or _same(got, want), poison
        assert _same(total, want_total) and torch.equal(frame_rays, want_rays), poison
        assert bool(torch.isnan(total).any()) == poison


@pytest.mark.cuda
@pytest.mark.parametrize("tonemap, as_uint8", [(True, True), (True, False), (False, True),
                                               (False, False)])
def test_frame_image_kernel_bit_equal(tonemap, as_uint8):
    dev = _card()
    n = 513 * 257
    lanes = torch.randperm(n, generator=torch.Generator().manual_seed(3)).to(dev)
    acc = torch.as_tensor(_hdr_sums(n, seed=4), device=dev)
    want = wave.frame_image_reference(acc, lanes, 5, tonemap, as_uint8)
    got = wave.frame_image(acc, lanes, 5, tonemap, as_uint8)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("disp", [(4, 6), (14, 20), (5, 7)])
def test_frame_progressive_kernel_bit_equal(disp):
    dev = _card()
    w, h = 20, 14
    accum = torch.full((w * h, 3), 9.0, device=dev)
    want_accum = accum.clone()
    for k in range(3):
        rad = torch.as_tensor(_hdr_sums(w * h, seed=k), device=dev)
        want = wave.frame_progressive_reference(rad, want_accum, k, w, h, *disp)
        got = wave.frame_progressive(rad, accum, torch.tensor([k], device=dev), w, h, *disp)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(accum, want_accum), k


@pytest.mark.cuda
@pytest.mark.parametrize("blas", [False, True])
@pytest.mark.parametrize("shadow", [False, True])
def test_step_kernel_reads_no_launch_that_no_lane_touched(shadow, blas):
    """The kernel's step on the poisoned launch of
    :func:`_poisoned_step`, its state as the plain first step left it,
    against the plain second step: bit-equal."""
    dev = _card()
    st0, st1 = _poisoned_step(shadow, blas, dev)
    n = st0["touches"].shape[0]
    st = trace.instance_state(n, dev, shadow=shadow, t_lo=False)
    for key, v in st0.items():
        if key in st and key != "rays":
            st[key].copy_(v)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(dense, "DENSE_MAX_TRIS", 64)
        tables = instanced_scene(tsg, n_soup_instances=2).upload(dev, instancing=True)
    scan = list(instanced._scan(tables.inst))
    x0 = next(x for x in scan if (x.group.pblas is not None) == blas)
    r = np.random.default_rng(5)
    o = np.full((n, 3), 100.0, np.float32) + r.uniform(0, 1, (n, 3)).astype(np.float32)
    d = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, 1))
    rays = tuple(torch.as_tensor(c.copy(), device=dev) for c in (*o.T, *d.T))
    active = torch.ones(n, dtype=torch.bool, device=dev)
    t_max = 1e32 if not shadow else torch.full((n,), 50.0, device=dev)
    prev = (x0, None if shadow else torch.full((n,), -1e30, device=dev),
            torch.full((n,), 2**30, dtype=torch.int32, device=dev))
    got = trace.instance_step(tables, st, rays, active, t_max, None, prev, scan[-1], shadow)
    torch.cuda.synchronize()
    for key in ("occ", "touches") if shadow else ("t_best", "enc", "touches"):
        assert torch.equal(got[key], st1[key].to(dev)), key
