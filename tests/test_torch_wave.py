"""The wave's kernels of the torch port (``ops/wave.py``, ``csrc/wave.cu``).

On the CPU the wrappers run their plain versions, which are held here
against the JAX package:

* ``primary_rays_reference`` against the JAX ``generate_primary_rays`` and
  ``render_sample``'s initial state (integrator.py:936-960) on a 64x64
  Cornell frame in 32x32-block lane order, a wave of two samples and a
  preview wave of sample 0: seeds and preview flags bit-equal, origins
  bit-equal, directions within rtol 1e-6, atol 1e-7
  (tests/test_torch_render.py's tolerance), the constant fields and the
  repacked wavefront's slots as the JAX state has them;
* ``alpha_commit_reference`` against the JAX ``_alpha_test`` and the body of
  the JAX ``_closest`` resample loop (integrator.py:195-214) on random
  candidates and loop states over tests/test_torch_alpha.py's stack, the
  textured glb and the instanced alpha scene: pending flags, triangle ids
  and seeds bit-equal, ``t`` and ``t_lo`` within rtol 1e-6 (the tolerance
  test_torch_alpha.py states for t); and so at pending shares of none, one
  lane, ~1% and every lane, on the untextured stack, the textured glb and
  the instanced alpha scene.

Beside them: the wrappers' column tables name ``csrc/wave.cu``'s enums in
order and the alpha commit's layout its constants, the CPU wrapper writes
the plain version's state over the loop's buffers,
tools/check_torch_wave.py's synthetic check finds nothing with both sides
plain, and a wrapper whose launch fails raises and never runs its plain
version.  Marked ``cuda`` (they skip without a card): each kernel against
its plain version on the card, bit for bit, the alpha commit at each
pending share.
"""

import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import torch_glb_assets  # noqa: E402
from vulkan_raytracer_tpu_torch.ops import _ext, wave  # noqa: E402
from vulkan_raytracer_tpu_torch.render import integrator as tint  # noqa: E402
from vulkan_raytracer_tpu_torch.render.renderer import camera_uniforms  # noqa: E402
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.camera import Camera  # noqa: E402

DIR_RTOL, DIR_ATOL = 1e-6, 1e-7  # tests/test_torch_render.py
T_RTOL = 1e-6  # tests/test_torch_alpha.py
SIZE = 64
STATE = ("origin", "direction", "value", "throughput", "seed", "wavelength", "mat_pdf", "active",
         "sky_w", "preview", "slot")  # render_sample's, as the bounce loop keeps them
LOOP = ("t_lo", "pending", "t", "tri", "u", "v", "seed")  # the resample loop's state


def _camera():
    return Camera(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))


def _wave_inputs(samples, device="cpu"):
    """(samples, block-order lanes, camera tensor) of a 64x64 Cornell wave."""
    vi, pi = camera_uniforms(_camera())
    lanes = torch.as_tensor(tint.block_order(SIZE, SIZE)[0], device=device).long()
    return (torch.tensor(samples, dtype=torch.int64, device=device), lanes,
            wave.camera_tensor(vi, pi, device))


@pytest.mark.parametrize("samples", [[3, 4], [0]], ids=["two_samples", "preview"])
@pytest.mark.parametrize("repack", [False, True])
def test_primary_rays_reference_matches_jax(samples, repack):
    jnp = pytest.importorskip("jax.numpy")
    from vulkan_raytracer_tpu.render import integrator as jint
    from vulkan_raytracer_tpu.render.renderer import camera_uniforms as jcamera_uniforms
    from vulkan_raytracer_tpu.scene.camera import Camera as JCamera

    jcam = JCamera(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))
    s_t, lanes, cam = _wave_inputs(samples)
    s = wave.primary_rays_reference(s_t, lanes, cam, SIZE, SIZE, repack)
    assert list(s) == [f for f in STATE if repack or f != "slot"]
    n, k = lanes.shape[0], len(samples)
    pix = np.tile(lanes.numpy(), k)
    counts = np.repeat(np.asarray(samples, np.uint32), n)
    jo, jd, js = jint.generate_primary_rays(*jcamera_uniforms(jcam), SIZE, SIZE,
                                            jnp.asarray(counts), jnp.asarray(pix))
    np.testing.assert_array_equal(s["seed"].numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(s["preview"].numpy(), counts == 0)
    for g, w in zip(s["origin"], jo):
        np.testing.assert_array_equal(g.numpy(), np.broadcast_to(np.asarray(w), (n * k,)))
    for g, w in zip(s["direction"], jd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=DIR_RTOL, atol=DIR_ATOL)
    # render_sample's initial state (integrator.py:948-960)
    for f, want in (("value", 0.0), ("throughput", 1.0), ("sky_w", 0.0)):
        for c in s[f]:
            assert c.dtype == torch.float32 and bool((c == want).all())
    assert bool((s["wavelength"] == 0.0).all()) and bool((s["mat_pdf"] == 1.0).all())
    assert s["active"].dtype == torch.bool and bool(s["active"].all())
    if repack:
        np.testing.assert_array_equal(s["slot"].numpy(), np.arange(n * k))
        one = wave.primary_rays_reference(s_t[:1], lanes, cam, SIZE, SIZE, True,
                                          pixel_order=True)
        np.testing.assert_array_equal(one["slot"].numpy(), lanes.numpy())  # JAX's slot
    # the wrapper on CPU tensors is the plain version
    got = wave.primary_rays(s_t, lanes, cam, SIZE, SIZE, repack)
    for a, b in zip(tint.graphs._leaves(got), tint.graphs._leaves(s)):
        assert torch.equal(a, b)


def _jax_commit(jint, jnp, jt, st, t_c, tri_c, u_c, v_c):
    """The JAX ``_closest`` loop body's test and commit (integrator.py:195-214)
    after its traversal returned the candidates."""
    found = st["pending"] & (tri_c >= 0)
    keep, seed2 = jint._alpha_test(jt, tri_c, u_c, v_c, st["seed"], found)
    t_safe = jnp.where(jnp.isfinite(t_c), t_c, 0.0)
    rejected = found & ~keep
    return dict(t_lo=jnp.where(rejected, t_safe * (1.0 + 4e-7) + 1e-30, st["t_lo"]),
                pending=rejected, t=jnp.where(keep, t_c, st["t"]),
                tri=jnp.where(keep, tri_c, st["tri"]), u=jnp.where(keep, u_c, st["u"]),
                v=jnp.where(keep, v_c, st["v"]),
                seed=jnp.where(st["pending"], seed2, st["seed"]))


def _alpha_tables(case, monkeypatch):
    """(JAX tables, port tables) of an alpha scene."""
    if case in ("alpha_stack", "untextured_stack"):
        from test_torch_alpha import _tables

        _, jt, _, tt = _tables(with_texture=case == "alpha_stack")
        return jt, tt
    from vulkan_raytracer_tpu.scene import scenegraph as jsg

    if case == "textured_glb":
        out = []
        with tempfile.TemporaryDirectory() as tmp:
            path = torch_glb_assets.write_textured_glb(tmp)
            for sg in (jsg, tsg):
                s = sg.Scene()
                s.load_model(path)
                out.append(s)
        return out[0].upload(), out[1].upload("cpu")
    import test_torch_instancing

    scene, _ = test_torch_instancing.alpha_instanced_scene()
    monkeypatch.setattr(test_torch_instancing, "tsg", jsg)  # the same scene in the JAX package
    jscene, _ = test_torch_instancing.alpha_instanced_scene()
    return jscene.upload(instancing=True), scene.upload("cpu", instancing=True)


@pytest.mark.parametrize("case", ["alpha_stack", "textured_glb", "alpha_instanced"])
def test_alpha_commit_reference_matches_jax(case, monkeypatch):
    jnp = pytest.importorskip("jax.numpy")
    from vulkan_raytracer_tpu.render import integrator as jint

    jt, tt = _alpha_tables(case, monkeypatch)
    assert tt.has_alpha and (tt.inst is not None) == (case == "alpha_instanced")
    ids = (tt.inst.num_proto_tris * tt.inst.num_instances if tt.inst is not None
           else tt.num_triangles)
    r = np.random.default_rng(7)
    n = 4096
    tri_c = np.where(r.random(n) < 0.15, -1, r.integers(0, ids, n)).astype(np.int32)
    t_c = np.where(tri_c >= 0, r.uniform(0.1, 5.0, n), np.inf).astype(np.float32)
    u_c = r.random(n).astype(np.float32)
    v_c = (r.random(n) * (1 - u_c)).astype(np.float32)
    st = dict(t_lo=r.uniform(0.0, 1.0, n).astype(np.float32), pending=r.random(n) < 0.8,
              t=np.where(r.random(n) < 0.5, np.inf, r.uniform(0.1, 5, n)).astype(np.float32),
              tri=r.integers(-1, ids, n).astype(np.int32), u=r.random(n).astype(np.float32),
              v=r.random(n).astype(np.float32),
              seed=r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))
    cand = (t_c, tri_c, u_c, v_c)
    want = _jax_commit(jint, jnp, jt, {k: jnp.asarray(v) for k, v in st.items()},
                       *map(jnp.asarray, cand))
    tst = {k: torch.as_tensor(v.astype(np.int64) if k == "seed" else v) for k, v in st.items()}
    got = wave.alpha_commit_reference(tt, tst, *map(torch.as_tensor, cand))
    assert list(got) == list(LOOP)
    for k in ("pending", "tri", "seed"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(
            got[k].numpy().dtype), err_msg=k)
    for k in ("t", "t_lo", "u", "v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=T_RTOL, err_msg=k)
    keep = st["pending"] & (tri_c >= 0) & ~got["pending"].numpy()
    assert keep.any() and got["pending"].numpy().any()  # candidates kept and rejected
    # the wrapper writes the same state over the loop's own buffers, and the count
    count = torch.zeros((), dtype=torch.int64)
    wave.alpha_commit(tt, tst, *map(torch.as_tensor, cand), count)
    for k in LOOP:
        assert torch.equal(tst[k], got[k]), k
    assert int(count) == int(got["pending"].sum())


#: Pending shares of a pass: none, one lane (None), ~1%, every lane.
SHARES = (0.0, None, 0.01, 1.0)


@pytest.mark.parametrize("share", SHARES, ids=["none", "one", "one_percent", "all"])
@pytest.mark.parametrize("case", ["untextured_stack", "textured_glb", "alpha_instanced"])
def test_alpha_commit_reference_matches_jax_at_pending_shares(case, share, monkeypatch):
    """The plain commit against the JAX loop body on a pass with none, one,
    ~1% or every lane pending, without textures, with them, and on an
    instanced scene: pending flags, ids, seeds and the count bit-equal, t
    and t_lo within rtol 1e-6; lanes not pending keep their state."""
    jnp = pytest.importorskip("jax.numpy")
    from vulkan_raytracer_tpu.render import integrator as jint

    jt, tt = _alpha_tables(case, monkeypatch)
    assert tt.has_textures == (case != "untextured_stack")
    ids = (tt.inst.num_proto_tris * tt.inst.num_instances if tt.inst is not None
           else tt.num_triangles)
    r = np.random.default_rng(11)
    n = 3001
    tri_c = np.where(r.random(n) < 0.15, -1, r.integers(0, ids, n)).astype(np.int32)
    t_c = np.where(tri_c >= 0, r.uniform(0.1, 5.0, n), np.inf).astype(np.float32)
    u_c = r.random(n).astype(np.float32)
    v_c = (r.random(n) * (1 - u_c)).astype(np.float32)
    pending = np.zeros(n, bool)
    if share is None:
        pending[n // 2] = True
        tri_c[n // 2] = max(int(tri_c[n // 2]), 0)  # with a candidate
    else:
        pending = r.random(n) < share
    st = dict(t_lo=r.uniform(0.0, 1.0, n).astype(np.float32), pending=pending,
              t=np.full(n, np.inf, np.float32), tri=np.full(n, -1, np.int32),
              u=np.zeros(n, np.float32), v=np.zeros(n, np.float32),
              seed=r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))
    cand = (t_c, tri_c, u_c, v_c)
    want = _jax_commit(jint, jnp, jt, {k: jnp.asarray(v) for k, v in st.items()},
                       *map(jnp.asarray, cand))
    tst = {k: torch.as_tensor(v.astype(np.int64) if k == "seed" else v) for k, v in st.items()}
    got = wave.alpha_commit_reference(tt, tst, *map(torch.as_tensor, cand))
    for k in ("pending", "tri", "seed"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(
            got[k].numpy().dtype), err_msg=k)
    for k in ("t", "t_lo", "u", "v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=T_RTOL, err_msg=k)
    idle = ~pending  # not pending: untouched
    for k in LOOP:
        np.testing.assert_array_equal(got[k].numpy()[idle], tst[k].numpy()[idle], err_msg=k)
    assert not got["pending"].numpy()[idle].any()
    count = torch.zeros((), dtype=torch.int64)
    wave.alpha_commit(tt, tst, *map(torch.as_tensor, cand), count)
    assert int(count) == int(got["pending"].sum()) == int(np.asarray(want["pending"]).sum())
    if share == 1.0:
        assert 0 < int(count) < n


def test_synthetic_check_finds_nothing_on_the_cpu(monkeypatch):
    """tools/check_torch_wave.py's synthetic passes with both sides plain:
    every share over the alpha gallery instanced, flattened and untextured
    at small counts; the shares as stated, candidates kept and rejected."""
    import check_torch_wave as ctw

    monkeypatch.setattr(ctw, "SYNTHETIC_LANES", (1, 1025, 4097, 0))
    out = ctw.synthetic(torch.device("cpu"))
    assert out["checked"] == 3 * 3 * len(ctw.PENDING_SHARES) and out["differing"] == []
    import chip_smoke

    tables = chip_smoke.alpha_gallery_scene(textured=False).upload("cpu", instancing=True)
    assert tables.has_alpha and not tables.has_textures
    for share, want in zip(ctw.PENDING_SHARES, (0, 1, 41, 4097)):
        st, t_c, tri_c, u_c, v_c = ctw.synthetic_pass(tables, 4097, share, seed=3)
        assert abs(int(st["pending"].sum()) - want) <= max(1, want // 3), share
        if share == 1.0:
            nxt = wave.alpha_commit_reference(tables, st, t_c, tri_c, u_c, v_c)
            assert 0 < int(nxt["pending"].sum()) < int((tri_c >= 0).sum())


def _enum(src: str, name: str) -> tuple:
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return tuple(w.strip() for w in body.split(",") if w.strip())


def test_slots_are_the_kernel_source_enums():
    """ops/wave.py's SLOTS and INTS name csrc/wave.cu's enums in order, and
    the build compiles it and hashes the header it shares with shade.cu."""
    src = (ROOT / "vulkan_raytracer_tpu_torch" / "csrc" / "wave.cu").read_text()
    assert _enum(src, "Slot") == (*wave.SLOTS, "kSlots")
    assert _enum(src, "Int") == (*wave.INTS, "kInts")
    assert "wave.cu" in {p.name for p in _ext.SOURCES}
    assert {p.name for p in _ext.HEADERS} == {"lane_math.cuh"}
    for name in ("wave.cu", "shade.cu"):
        text = (ROOT / "vulkan_raytracer_tpu_torch" / "csrc" / name).read_text()
        assert '#include "lane_math.cuh"' in text
    assert {"primary_rays_launch", "alpha_commit_launch"} <= set(_ext._SIGNATURES)


@pytest.mark.parametrize("kernel", ["primary_rays", "alpha_commit"])
def test_failed_launch_raises(kernel, monkeypatch):
    """A wrapper routed to its kernel whose launch fails raises, and never
    runs its plain version."""
    plain = []
    for name in ("primary_rays_reference", "alpha_commit_reference"):
        monkeypatch.setattr(wave, name, lambda *a, _n=name, **k: plain.append(_n))

    def launch(fn, device, *args):
        raise RuntimeError(f"{fn}: CUDA error 700")

    monkeypatch.setattr(wave, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_ext, "launch", launch)
    before = dict(wave.LAUNCHES)
    if kernel == "primary_rays":
        call = lambda: wave.primary_rays(*_wave_inputs([1, 2]), SIZE, SIZE, True)  # noqa: E731
    else:
        tables = cornell_box_scene().upload("cpu")
        n = 256
        st = dict(t_lo=torch.zeros(n), pending=torch.ones(n, dtype=torch.bool),
                  t=torch.full((n,), torch.inf), tri=torch.full((n,), -1, dtype=torch.int32),
                  u=torch.zeros(n), v=torch.zeros(n), seed=torch.zeros(n, dtype=torch.int64))
        call = lambda: wave.alpha_commit(tables, st, torch.ones(n), torch.zeros(  # noqa: E731
            n, dtype=torch.int32), torch.zeros(n), torch.zeros(n))
    with pytest.raises(RuntimeError, match="CUDA error"):
        call()
    assert plain == [] and wave.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("samples, pixel_order", [([1, 2], False), ([0], True), ([5], False)])
def test_primary_rays_kernel_bit_equal(samples, pixel_order):
    """``primary_rays_kernel`` against its plain version on the card: every
    field of every lane bit-equal, with and without the repacked slot."""
    _card()
    inputs = _wave_inputs(samples, "cuda")
    for repack in (False, True):
        before = wave.LAUNCHES["primary_rays"]
        got = wave.primary_rays(*inputs, SIZE, SIZE, repack, pixel_order and repack)
        want = wave.primary_rays_reference(*inputs, SIZE, SIZE, repack, pixel_order and repack)
        assert wave.LAUNCHES["primary_rays"] == before + 1
        assert list(got) == list(want)
        for a, b in zip(tint.graphs._leaves(got), tint.graphs._leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("instancing", [False, True])
def test_alpha_commit_kernel_bit_equal(instancing):
    """``alpha_commit_kernel`` against its plain version on the card, on
    random candidates over the instanced alpha scene and its flattened
    upload: the state it writes over the loop's buffers and its count of
    pending lanes bit-equal.  Then tools/check_torch_wave.py's synthetic
    passes: every pending share at 1, 1,025 and 524,287 lanes over the alpha
    gallery instanced, flattened and untextured."""
    _card()
    if instancing:
        import check_torch_wave as ctw

        out = ctw.synthetic(torch.device("cuda"))
        assert out["differing"] == [] and out["launches"] == out["checked"] == 36
    import test_torch_instancing

    scene, _ = test_torch_instancing.alpha_instanced_scene()
    tables = scene.upload("cuda", instancing=instancing)
    ids = (tables.inst.num_proto_tris * tables.inst.num_instances if instancing
           else tables.num_triangles)
    g = torch.Generator(device="cuda").manual_seed(3)
    n = 100_003
    tri_c = torch.randint(-1, ids, (n,), generator=g, device="cuda", dtype=torch.int32)
    t_c = torch.where(tri_c >= 0, torch.rand(n, generator=g, device="cuda") * 4, torch.inf)
    u_c = torch.rand(n, generator=g, device="cuda")
    v_c = torch.rand(n, generator=g, device="cuda") * (1 - u_c)
    st = dict(t_lo=torch.rand(n, generator=g, device="cuda"),
              pending=torch.rand(n, generator=g, device="cuda") < 0.8,
              t=torch.full((n,), torch.inf, device="cuda"),
              tri=torch.full((n,), -1, dtype=torch.int32, device="cuda"),
              u=torch.zeros(n, device="cuda"), v=torch.zeros(n, device="cuda"),
              seed=torch.randint(0, 2**32, (n,), generator=g, device="cuda"))
    want = wave.alpha_commit_reference(tables, st, t_c, tri_c, u_c, v_c)
    count = torch.full((), 99, dtype=torch.int64, device="cuda")
    wave.alpha_commit(tables, st, t_c, tri_c, u_c, v_c, count)
    for k in LOOP:
        assert torch.equal(st[k], want[k]), k
    assert int(count) == int(want["pending"].sum()) > 0
