"""The repacked wavefront of the torch port against the JAX package.

``render/integrator.py`` sorts the lanes of a BVH-walked scene by their
coherence key between bounces, sorts the NEE occlusion rays by their own
key, and steps the wave down to half and a quarter of its width once enough
lanes died (the JAX ``render_sample``'s repack, integrator.py:918-1137);
``render/renderer.py`` bands such a scene's frame below the cap
(``_banded_preferred``).  Held here:

* the coherence key (``ops/trace.py coherence_key``, on the CPU its plain
  version) bit-equal to JAX's ``_coherence_key`` on BVH and instanced
  tables, and its stable permutation equal to ``jnp.argsort``'s;
* the repacked loop bit-equal to the unsorted one with equal rays (every
  op is per lane), on JAX's width-ladder scene, with both tiers run; the
  same for ``_shadow`` (flags and seeds, alpha-free and BLEND) and for the
  progressive ``_frame_step``;
* ``_repack_preferred`` and ``_banded_preferred`` deciding as JAX's
  ``_beam_occlusion`` and ``_banded_preferred`` do;
* the repacked ``render_sample`` and banded ``render_image`` against JAX's
  repacked renders (its Pallas kernels in interpret mode, as
  tests/test_width_ladder.py runs them): RMSE < 2e-3, the bar of
  tests/test_torch_render.py, and ray counts within 0.1%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_alpha import _alpha_scene, _rays, _seeds
from test_torch_instancing import instanced_scene
from vulkan_raytracer_tpu.ops.math3 import V3 as JV3
from vulkan_raytracer_tpu.render import integrator as jint
from vulkan_raytracer_tpu.render import renderer as jrnd
from vulkan_raytracer_tpu.scene import scenegraph as jsg
from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
from vulkan_raytracer_tpu.scene.procedural import dragon_scene as jdragon
from vulkan_raytracer_tpu_torch.ops import dense as tdense
from vulkan_raytracer_tpu_torch.ops import trace as ttrace
from vulkan_raytracer_tpu_torch.ops.math3 import V3
from vulkan_raytracer_tpu_torch.render import integrator as tint
from vulkan_raytracer_tpu_torch.render import renderer as trnd
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy
from vulkan_raytracer_tpu_torch.scene.procedural import sky_hdr

RMSE_BAR = 2e-3


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _repack(monkeypatch, on: bool):
    monkeypatch.setattr(tint, "_repack_preferred", lambda tables: on)


def _key_inputs(tables, n, seed):
    """Origins over the scene's bounds and 10% past them (so some cells
    clamp), directions with every octant and some zero components, a dead
    mask: numpy arrays."""
    if tables.inst is not None:
        lo = np.min([g.aabb_min.numpy().min(0) for g in tables.inst.groups], axis=0)
        hi = np.max([g.aabb_max.numpy().max(0) for g in tables.inst.groups], axis=0)
    else:
        lo, hi = tables.bvh.aabb_min[0].numpy(), tables.bvh.aabb_max[0].numpy()
    r = np.random.default_rng(seed)
    pad = 0.1 * (hi - lo)
    o = r.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[r.random((n, 3)) < 0.05] = 0.0
    return o, d, r.random(n) < 0.3


@pytest.mark.parametrize("kind", ["bvh", "instanced"])
def test_coherence_key_matches_jax(kind):
    if kind == "bvh":
        jt = jdragon(detail=12).upload()
        tt = tables_from_numpy(_np_tree(jt), "cpu", traversal="bvh")
    else:
        jt = instanced_scene(jsg).upload(instancing=True)
        tt = tables_from_numpy(_np_tree(jt), "cpu")
        assert tt.inst is not None and len(tt.inst.groups) == 3
    o, d, dead = _key_inputs(tt, 4096, seed=21)
    jkey = np.asarray(jint._coherence_key(jt, JV3(*(jnp.asarray(o[:, k]) for k in range(3))),
                                          JV3(*(jnp.asarray(d[:, k]) for k in range(3))),
                                          jnp.asarray(dead)))
    tkey = ttrace.coherence_key(tt, V3(*(torch.as_tensor(o[:, k].copy()) for k in range(3))),
                                V3(*(torch.as_tensor(d[:, k].copy()) for k in range(3))),
                                torch.as_tensor(~dead))
    np.testing.assert_array_equal(tkey.numpy().astype(np.int64), jkey.astype(np.int64))
    assert jkey.max() < 2 ** 31 and len(np.unique(jkey)) > 1000  # cells and octants spread
    np.testing.assert_array_equal(torch.argsort(tkey, stable=True).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(jkey))))


def _open_tables():
    """tests/test_width_ladder.py's scene: the Cornell geometry under a sky,
    here uploaded with BVH streams (the repack needs the root bounds)."""
    s = cornell_box_scene()
    s.skybox = sky_hdr(h=16, w=32)
    s.skybox_strength = 1.0
    return s.upload("cpu", traversal="bvh")


def _uniforms(z):
    cam = Camera(position=np.array([0.0, 1.0, z]), direction=np.array([0.0, 0.0, -1.0]),
                 aspect=1.0)
    return trnd.camera_uniforms(cam)


@pytest.mark.parametrize("z, tiers", [(14.0, (1024, 256)), (3.0, (1024, 512, 256))])
def test_width_ladder_bit_identical(z, tiers, monkeypatch):
    """tests/test_width_ladder.py's test on the port: 32x32, sample 2,
    depth 4; from z = 14 (JAX's camera) the live share falls below a
    quarter after one bounce, from z = 3 it passes through both tiers."""
    t = _open_tables()
    vi, pi = _uniforms(z)
    _repack(monkeypatch, False)
    tint.reset_bounce_widths()
    ref, rays_ref = tint.render_sample(t, vi, pi, 32, 32, 2, 4)
    assert set(tint.BOUNCE_WIDTHS) == {1024}
    _repack(monkeypatch, True)
    tint.reset_bounce_widths()
    got, rays_got = tint.render_sample(t, vi, pi, 32, 32, 2, 4)
    assert tuple(sorted(tint.BOUNCE_WIDTHS, reverse=True)) == tiers
    assert sum(tint.BOUNCE_WIDTHS.values()) == 5  # depth 4: every bounce ran
    assert torch.equal(got, ref) and int(rays_got) == int(rays_ref)
    assert ref.min() >= 0.0 and ref.max() > 0.0
    # the same lanes in the order of lane_idx, sample-batched, as _render_wave runs them
    lanes = torch.as_tensor(trnd.block_order(32, 32)[0])
    want = trnd._render_wave(t, vi, pi, 32, 32, 4, [1, 2], lanes, "reference")
    _repack(monkeypatch, False)
    plain = trnd._render_wave(t, vi, pi, 32, 32, 4, [1, 2], lanes, "reference")
    assert torch.equal(want[0], plain[0]) and int(want[1]) == int(plain[1])


def _shadow_case(kind):
    """(tables, o, d, t_max, active, seed) of occlusion rays with every
    octant and dead lanes: inside the Cornell box (alpha-free), or through
    tests/test_alpha.py's BLEND + MASK stack from both sides."""
    n = 512
    r = np.random.default_rng(5)
    if kind == "opaque":
        t = cornell_box_scene().upload("cpu", traversal="bvh")
        o = V3(*(torch.as_tensor(r.uniform(lo, hi, n).astype(np.float32))
                 for lo, hi in ((-0.9, 0.9), (0.1, 1.9), (-0.9, 0.9))))
        d = V3(*(torch.as_tensor(c) for c in r.normal(size=(3, n)).astype(np.float32))).normalized()
        t_max = torch.as_tensor(r.uniform(0.2, 3.0, n).astype(np.float32))
    else:
        t = _alpha_scene("vulkan_raytracer_tpu_torch").upload("cpu", traversal="bvh")
        assert t.has_blend
        _, _, (o, d) = _rays(n, seed=9, both_sides=True)
        t_max = torch.as_tensor(np.where(np.arange(n) % 4 == 0, 1.75, 4.5).astype(np.float32))
    active = torch.as_tensor(r.random(n) < 0.8)
    seed = torch.as_tensor(_seeds(n, 747796405, 1).astype(np.int64))
    return t, o, d, t_max, active, seed


@pytest.mark.parametrize("kind", ["opaque", "blend"])
def test_shadow_sorted_matches_unsorted(kind, monkeypatch):
    t, o, d, t_max, active, seed = _shadow_case(kind)
    perm = torch.argsort(ttrace.coherence_key(t, o, d, active), stable=True)
    assert not torch.equal(perm, torch.arange(perm.shape[0]))  # the sort moves lanes
    want, seed_want = tint._shadow_unsorted(t, o, d, t_max=t_max, active=active, seed=seed)
    _repack(monkeypatch, True)
    got, seed_got = tint._shadow(t, o, d, t_max=t_max, active=active, seed=seed)
    assert torch.equal(got, want) and torch.equal(seed_got, seed_want)
    assert 0 < int(want.sum()) < int(active.sum())
    if kind == "blend":  # BLEND candidates drew random numbers on some lanes
        assert (seed_want != seed).any()


def test_repack_rule_matches_jax(monkeypatch):
    """``_repack_preferred`` is JAX's ``_beam_occlusion`` with its packet
    kernel available: off on a dense scene and on a small scene uploaded with
    BVH streams, on above DENSE_MAX_TRIS (shrunk here) and on an instanced
    scene with a prototype that walks a BLAS; off on one without."""
    monkeypatch.setenv("VKRT_PALLAS_INTERPRET", "1")
    jt = jcornell().upload()
    cases = {"dense": (jt, tables_from_numpy(_np_tree(jt), "cpu")),
             "forced_bvh": (jt, tables_from_numpy(_np_tree(jt), "cpu", traversal="bvh")),
             "instanced_dense": (lambda j: (j, tables_from_numpy(_np_tree(j), "cpu")))(
                 instanced_scene(jsg, n_soup_instances=2).upload(instancing=True))}
    got = {k: (bool(jint._beam_occlusion(j)), tint._repack_preferred(t))
           for k, (j, t) in cases.items()}
    assert got == {k: (False, False) for k in cases}
    monkeypatch.setattr(jint, "DENSE_MAX_TRIS", 30)  # Cornell has 36 triangles
    monkeypatch.setattr(jsg, "DENSE_MAX_TRIS", 50)  # the soup prototype has 120
    monkeypatch.setattr(tdense, "DENSE_MAX_TRIS", 30)
    ji = instanced_scene(jsg, n_soup_instances=2).upload(instancing=True)
    ti = tables_from_numpy(_np_tree(ji), "cpu")
    assert ti.inst.groups[0].pblas is not None
    for j, t in ((jt, cases["forced_bvh"][1]), (ji, ti)):
        assert bool(jint._beam_occlusion(j)) and tint._repack_preferred(t)


FRAMES = [(16, 16), (300, 200), (512, 512), (724, 724), (1024, 513)]


def test_banded_preferred_matches_jax(monkeypatch):
    """The port's rule against JAX's over scenes x frames x spp at the real
    cap: bands above it always, below it only on a flattened repacked
    scene whose frame cannot hold min(spp, 8) samples in one wave."""
    monkeypatch.setenv("VKRT_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("VKRT_FORCE_PACKET", raising=False)
    monkeypatch.delenv("VKRT_SPP_CHUNK", raising=False)
    monkeypatch.setattr(jint, "DENSE_MAX_TRIS", 30)
    jt = jcornell().upload()
    ji = instanced_scene(jsg, n_soup_instances=2).upload(instancing=True)
    scenes = {"repacked": (jt, tables_from_numpy(_np_tree(jt), "cpu", traversal="bvh"), 30),
              "dense": (jt, tables_from_numpy(_np_tree(jt), "cpu"), 65536),
              "forced_bvh": (jt, tables_from_numpy(_np_tree(jt), "cpu", traversal="bvh"), 65536),
              "instanced": (ji, tables_from_numpy(_np_tree(ji), "cpu"), 30)}
    decided = set()
    for name, (j, t, cap) in scenes.items():
        monkeypatch.setattr(tdense, "DENSE_MAX_TRIS", cap)
        monkeypatch.setattr(jint, "DENSE_MAX_TRIS", cap)
        for w, h in FRAMES:
            for spp in (1, 2, 4, 8, 16):
                want = jrnd._banded_preferred(j, w, h, spp)
                assert trnd._banded_preferred(t, w, h, spp) == want, (name, w, h, spp)
                decided.add((name, want, w * h <= trnd.MAX_LANES_PER_PASS))
    # both answers below the cap on the repacked scene; no bands there elsewhere
    assert {("repacked", True, True), ("repacked", False, True)} <= decided
    assert not {(k, True, True) for k in ("dense", "forced_bvh", "instanced")} & decided


@pytest.fixture
def jax_repack(monkeypatch):
    """JAX's repacked path as tests/test_width_ladder.py runs it: the packet
    kernel for every scene, in interpret mode, and the repack forced."""
    for name in ("VKRT_PALLAS_INTERPRET", "VKRT_FORCE_PACKET", "VKRT_FORCE_REPACK"):
        monkeypatch.setenv(name, "1")
    monkeypatch.delenv("VKRT_SPP_CHUNK", raising=False)
    jt = jcornell().upload()
    return jt, tables_from_numpy(_np_tree(jt), "cpu", traversal="bvh")


def _cfg1_cam(cls):
    return cls(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))


def test_repacked_render_sample_matches_jax(jax_repack, monkeypatch):
    """16x16 (256 lanes, so the ladder runs), sample 1, depth 3, no lane_idx:
    both take the block order and scatter back to pixel order."""
    jt, tt = jax_repack
    _repack(monkeypatch, True)
    jcam, tcam = _cfg1_cam(JCamera), _cfg1_cam(Camera)
    jcam.aspect = tcam.aspect = 1.0
    jvi, jpi = jrnd.camera_uniforms(jcam)
    vi, pi = trnd.camera_uniforms(tcam)
    want, rays_j = jrnd._render_one(jt, jvi, jpi, 16, 16, 1, 3)  # jitted render_sample
    tint.reset_bounce_widths()
    got, rays_t = tint.render_sample(tt, vi, pi, 16, 16, 1, 3)
    assert set(tint.BOUNCE_WIDTHS) > {256}  # the ladder stepped
    assert _rmse(got.numpy(), np.asarray(want)) < RMSE_BAR
    assert abs(int(rays_t) - int(rays_j)) <= 1e-3 * int(rays_j)
    assert float(got.sum()) > 0.0


def test_repacked_banded_render_matches_jax(jax_repack, monkeypatch):
    """``render_image`` at 16x16, 2 spp, depth 3 with the cap shrunk to the
    frame's 256 pixels: both packages prefer bands below it (2 bands of 128
    pixels x 2 samples), with the same rays and the same image within the
    bar."""
    jt, tt = jax_repack
    _repack(monkeypatch, True)
    monkeypatch.setattr(jrnd, "MAX_LANES_PER_PASS", 256)
    monkeypatch.setattr(trnd, "MAX_LANES_PER_PASS", 256)
    assert jrnd._banded_preferred(jt, 16, 16, 2) and trnd._banded_preferred(tt, 16, 16, 2)
    band_calls = []
    render_band = jrnd._render_band

    def counted(tables, view_inv, proj_inv, width, height, max_depth, spp, start, lanes, **kw):
        band_calls.append((int(lanes.shape[0]), spp))
        return render_band(tables, view_inv, proj_inv, width, height, max_depth, spp, start,
                           lanes, **kw)

    monkeypatch.setattr(jrnd, "_render_band", counted)
    img_j, rays_j = jrnd.render_image(jt, _cfg1_cam(JCamera), 16, 16, spp=2, max_depth=3,
                                      tonemap=False)
    img_t, rays_t = trnd.render_image(tt, _cfg1_cam(Camera), 16, 16, spp=2, max_depth=3,
                                      tonemap=False)
    assert band_calls == [(128, 2), (128, 2)]
    assert trnd.LAST_RENDER == {"bands": 2, "waves": 2}
    assert _rmse(img_t, img_j) < RMSE_BAR
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j
    # the port's bands give the port's whole-frame render bit for bit
    monkeypatch.setattr(trnd, "MAX_LANES_PER_PASS", 1 << 19)
    img_w, rays_w = trnd.render_image(tt, _cfg1_cam(Camera), 16, 16, spp=2, max_depth=3,
                                      tonemap=False)
    assert trnd.LAST_RENDER == {"bands": 0, "waves": 1}
    np.testing.assert_array_equal(img_w, img_t)
    assert rays_w == rays_t


def test_progressive_frame_step_repacked_bit_equal(monkeypatch):
    """The progressive ``_frame_step`` (no lane_idx: block order and slots)
    repacked against unsorted: preview frame and two samples, bit for bit."""
    t = _open_tables()
    vi, pi = _uniforms(3.0)
    out = {}
    for on in (False, True):
        _repack(monkeypatch, on)
        accum = torch.zeros((32 * 32, 3))
        frames = [trnd._frame_step(t, vi, pi, 32, 32, accum, 4, 32, 32, k) for k in range(3)]
        out[on] = (frames, accum)
    for (img_a, rays_a), (img_b, rays_b) in zip(out[False][0], out[True][0]):
        assert torch.equal(img_a, img_b) and int(rays_a) == int(rays_b)
    assert torch.equal(out[False][1], out[True][1]) and float(out[True][1].sum()) > 0.0
