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
from vulkan_raytracer_tpu_torch.ops import _ext, trace, wave  # noqa: E402
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


def _raw(tables, t_c, tri_c, seed: int):
    """A traversal's raw result whose ids are ``tri_c`` (a triangle, or an
    instanced scene's encoded id) and t ``t_c``, for random rays made from
    ``seed``: (rays, t, hit, mode), the alpha commit's input."""
    r = np.random.default_rng(seed)
    n = len(tri_c)
    o = r.uniform(-1, 1, (3, n)).astype(np.float32)
    d = r.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    rays = tuple(torch.as_tensor(c.copy()) for c in (*o, *d))
    mode = "instanced" if tables.inst is not None else "dense"
    return rays, torch.as_tensor(t_c), torch.as_tensor(tri_c), mode


def _commit_matches_the_plain_pass(tt, tst, t_c, tri_c):
    """The CPU wrapper, from a raw traversal result over random rays, writes
    the plain finish and commit's state over the loop's own buffers, and the
    count of lanes still pending into the loop's control block."""
    raw = _raw(tt, t_c, tri_c, seed=5)
    want = wave.alpha_commit_reference(tt, tst, *trace.hit_finish_reference(tt, *raw))
    assert all(torch.equal(a, b) for a, b in zip(
        want.values(), wave.alpha_pass_reference(tt, tst, raw).values()))
    loop = wave.loop_block("cpu")
    wave.alpha_commit(tt, tst, raw, loop)
    for k in LOOP:
        assert torch.equal(tst[k], want[k]), k
    assert int(wave.loop_count(loop)) == int(want["pending"].sum())
    return want


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
    # the wrapper finishes a raw hit and writes the same state over the
    # loop's own buffers, and the count
    _commit_matches_the_plain_pass(tt, tst, t_c, tri_c)


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
    assert int(got["pending"].sum()) == int(np.asarray(want["pending"]).sum())
    count = int(_commit_matches_the_plain_pass(tt, tst, t_c, tri_c)["pending"].sum())
    if share == 1.0:
        assert 0 < count < n


@pytest.mark.parametrize("share", [0.0, 0.05, 1.0], ids=["none", "few", "all"])
@pytest.mark.parametrize("mode", ["dense", "bvh", "instanced"])
def test_alpha_pass_matches_jax_loop_body(mode, share, monkeypatch):
    """One pass of the resample loop as the port runs it (``_alpha_pass``:
    the traversal's raw hit, then the plain finish and commit that the card
    fuses into one kernel) against one run of the body of the JAX
    ``_closest`` loop (integrator.py:195-214: its traversal, ``_alpha_test``
    and the commit) from the same state, on each finish mode: the alpha
    stack swept densely and, with ``traversal="bvh"``, walked against JAX's
    packet kernel in interpret mode, and the instanced alpha scene; with
    none, a few and every lane pending.  Pending flags, ids and seeds
    bit-equal, t and t_lo within rtol 1e-6, u and v within 1e-6
    (test_torch_alpha.py's tolerances); the count the pass leaves in the
    loop's control block is the JAX state's."""
    jnp = pytest.importorskip("jax.numpy")
    from test_torch_alpha import _rays
    from test_torch_alpha import _tables as stack_tables
    from vulkan_raytracer_tpu.render import integrator as jint

    if mode == "bvh":
        monkeypatch.setenv("VKRT_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("VKRT_FORCE_PACKET", "1")
    if mode == "instanced":
        jt, tt = _alpha_tables("alpha_instanced", monkeypatch)
    else:
        _, jt, _, tt = stack_tables(traversal=mode if mode == "bvh" else "auto")
    n = 96
    _, (jo, jd), (to, td) = _rays(n, seed=13)
    r = np.random.default_rng(17)
    pending = r.random(n) < share
    if share:
        pending[: max(1, n // 20)] = True
    # lower bounds before, between and past the quads (z = 0.5, 0, -0.5 from z = 2)
    st = dict(t_lo=r.choice(np.float32([1e-6, 1.7, 2.2]), n), pending=pending,
              t=np.full(n, np.inf, np.float32), tri=np.full(n, -1, np.int32),
              u=np.zeros(n, np.float32), v=np.zeros(n, np.float32),
              seed=r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    t_c, tri_c, u_c, v_c = jint._closest_opaque(jt, jo, jd, t_min=jst["t_lo"], t_max=1e32,
                                                active=jst["pending"])
    want = _jax_commit(jint, jnp, jt, jst, t_c, tri_c, u_c, v_c)
    tst = {k: torch.as_tensor(v.astype(np.int64) if k == "seed" else v) for k, v in st.items()}
    raw = tint._closest_opaque(tt, to, td, t_min=tst["t_lo"], t_max=1e32, active=tst["pending"],
                               raw=True)
    assert raw[3] == mode and (mode != "bvh" or jint._packet_preferred(jt))
    loop = wave.loop_block("cpu")
    tint._alpha_pass(tt, to, td, 1e32, tst, loop)
    for k in ("pending", "tri", "seed"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(want[k]).astype(
            tst[k].numpy().dtype), err_msg=k)
    for k in ("t", "t_lo"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(want[k]), rtol=T_RTOL, err_msg=k)
    for k in ("u", "v"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    assert int(wave.loop_count(loop)) == int(np.asarray(want["pending"]).sum())
    if share:  # candidates accepted and rejected
        assert (tst["tri"].numpy() >= 0).any() and tst["pending"].numpy().any()


@pytest.mark.parametrize("repack", [False, True])
@pytest.mark.parametrize("sample", [False, True])
def test_wave_check_holds_both_tail_flags(sample, repack, monkeypatch):
    """tools/check_torch_wave.py on a small Cornell frame (its first wave,
    and with ``sample`` one sample of the whole frame as ``render_sample``
    runs it), in lane order and repacked: the tail is held once with each
    radiance flag, no lane differing with both sides plain; a radiance lane
    one ulp off in the tail's radiance-writing instance is found, whichever
    flag the wave asks for."""
    import check_torch_wave as ctw

    monkeypatch.setattr(tint, "_repack_preferred", lambda t: repack)
    spec = (lambda device: cornell_box_scene().upload(
        device, traversal="bvh" if repack else "auto"),
        ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0]), 12, 10, 2, 3)
    cpu = torch.device("cpu")
    line = ctw.check_config("cornell", spec, cpu, sample=sample)
    assert line["differing_lanes"] == 0 and line["finite"] and line["rays"] > 0
    assert line["other_flag"] == {"checks": 1, "launches": 0}
    assert line["calls"]["wave_sum"] == 1 + repack
    assert line["lanes"] == 120 * (1 if sample else 2)
    tail = wave.wave_sum

    def off_by_an_ulp(tables, s, repack, total, frame_rays, rays, k, radiance):
        out = tail(tables, s, repack, total, frame_rays, rays, k, radiance)
        if out is not None:
            out[7, 1] = torch.nextafter(out[7, 1], torch.tensor(np.inf))
        return out

    monkeypatch.setattr(wave, "wave_sum", off_by_an_ulp)
    line = ctw.check_config("cornell", spec, cpu, sample=sample)
    assert line["by_kernel"] == {"wave_sum_kernel": 1}
    assert line["first"][0]["lane"] == 7 * 3 + 1 and line["first"][0]["ulps"] == 1
    assert line["first"][0]["field"] == ("[0]" if sample else "other_flag[0]")


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
        st, raw = ctw.synthetic_pass(tables, 4097, share, seed=3)
        assert raw[3] == "instanced" and len(raw[0]) == 6
        assert abs(int(st["pending"].sum()) - want) <= max(1, want // 3), share
        if share == 1.0:
            nxt = wave.alpha_pass_reference(tables, st, raw)
            assert 0 < int(nxt["pending"].sum()) < int((raw[2] >= 0).sum())


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
    assert _enum(src, "LoopWord") == wave.LOOP_WORDS
    assert "wave.cu" in {p.name for p in _ext.SOURCES}
    assert {p.name for p in _ext.HEADERS} == {"lane_math.cuh", "hit_finish.cuh",
                                              "graph_test.cuh"}
    csrc = ROOT / "vulkan_raytracer_tpu_torch" / "csrc"
    for name, header in (("wave.cu", "hit_finish.cuh"), ("wave.cu", "graph_test.cuh"),
                         ("hit_finish.cuh", "lane_math.cuh"), ("shade.cu", "lane_math.cuh"),
                         ("trace.cu", "hit_finish.cuh"), ("graph_loops.cu", "graph_test.cuh")):
        assert f'#include "{header}"' in (csrc / name).read_text(), (name, header)
    assert {"primary_rays_launch", "alpha_commit_launch"} <= set(_ext._SIGNATURES)


@pytest.mark.parametrize("kernel", ["primary_rays", "alpha_commit"])
def test_failed_launch_raises(kernel, monkeypatch):
    """A wrapper routed to its kernel whose launch fails raises, and never
    runs its plain version."""
    plain = []
    for name in ("primary_rays_reference", "alpha_commit_reference", "alpha_pass_reference"):
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
        raw = (tuple(torch.zeros(n) for _ in range(6)), torch.ones(n),
               torch.zeros(n, dtype=torch.int32), "dense")
        call = lambda: wave.alpha_commit(tables, st, raw, wave.loop_block("cpu"))  # noqa: E731
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
    """``alpha_commit_kernel`` against its plain version (the finish, then
    the commit) on the card, on random raw hits over the instanced alpha
    scene and its flattened upload: the state it writes over the loop's
    buffers and the count of pending lanes it leaves in the loop's control
    block bit-equal, the block's accumulator back at 0 and, not armed, no
    row kept.  Then tools/check_torch_wave.py's synthetic passes: every
    pending share at 1, 1,025 and 524,287 lanes over the alpha gallery
    instanced, flattened and untextured."""
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
    hit = torch.randint(-1, ids, (n,), generator=g, device="cuda", dtype=torch.int32)
    t = torch.where(hit >= 0, torch.rand(n, generator=g, device="cuda") * 4, torch.inf)
    d = torch.randn((3, n), generator=g, device="cuda")
    d = d / d.norm(dim=0)
    rays = tuple(c.contiguous() for c in (*(torch.rand((3, n), generator=g, device="cuda") * 2
                                             - 1), *d))
    raw = (rays, t, hit, "instanced" if instancing else "dense")
    st = dict(t_lo=torch.rand(n, generator=g, device="cuda"),
              pending=torch.rand(n, generator=g, device="cuda") < 0.8,
              t=torch.full((n,), torch.inf, device="cuda"),
              tri=torch.full((n,), -1, dtype=torch.int32, device="cuda"),
              u=torch.zeros(n, device="cuda"), v=torch.zeros(n, device="cuda"),
              seed=torch.randint(0, 2**32, (n,), generator=g, device="cuda"))
    want = wave.alpha_pass_reference(tables, st, raw)
    loop = wave.loop_block("cuda")
    loop[3] = 99
    wave.alpha_commit(tables, st, raw, loop)
    for k in LOOP:
        assert torch.equal(st[k], want[k]), k
    assert int(wave.loop_count(loop)) == int(want["pending"].sum()) > 0
    assert loop[:3].tolist() == [0, 0, 0]
