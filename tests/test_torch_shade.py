"""The bounce's shading (``ops/shade.py``, ``csrc/shade.cu``).

On CUDA tensors a bounce shades its lanes with three hand-written kernels
(the hit, the scatter and light sample, the NEE resolve); on CPU tensors
the wrappers run their plain versions, the port's torch code regrouped.
Held here on the CPU, on 4,096 camera lanes of four scenes (the built-in
Cornell box under a point and a directional light, the textured glb with
MASK and BLEND alpha and its six texture slots, a small instanced gallery,
and a dispersive glass sphere under analytic lights):

* the plain versions against the JAX functions they regroup: ``eval_hit``
  and the bounce's masks, ``sample_material`` and the next state,
  ``material_bsdf`` and ``material_pdf`` at the sampled light, and the
  ``sample_lights`` parts before and after the shadow ray against JAX's
  ``sample_lights``.  The tolerances are those tests/test_torch_ops.py and
  tests/test_torch_texture.py state for these functions (floats rtol 1e-5 /
  atol 1e-6, a few BSDF lanes within 10x; the NEE contribution rtol 1e-4 as
  in tests/test_torch_render.py); seeds, hit ids, masks and ray counts
  bit-equal;
* the split exact on the CPU: the hit state bit-equal to ``eval_hit`` and
  the bounce's masks; ``shade_scatter_reference``, ``_shadow``, the probe
  and ``shade_resolve_reference`` bit-equal to the unsplit ``sample_lights``
  (contribution, seed and rays);
* a ``TorchDispatchMode`` budget: with the wrappers routed to their kernels
  (the library stubbed) and the traversal calls opaque, a bounce runs at
  most :data:`OPS_OUTSIDE` aten ops outside them, and the wrappers
  themselves only allocate and view;
* a wrapper whose launch fails raises and never runs its plain version;
* the pointer slots and counts of ``ops/shade.py`` are the enums of the
  source, in order;
* ``tools/check_torch_shade.py`` on the CPU (both sides plain) finds no lane.

Marked ``cuda`` (they skip without a card): each kernel against its plain
version on the waves of six scenes, bit for bit, through the same tool.
"""

import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

try:  # the card's machine has no jax; only the cuda-marked tests run there
    import jax
    import jax.numpy as jnp

    from vulkan_raytracer_tpu.ops import bsdf as jbsdf
    from vulkan_raytracer_tpu.ops import math3 as jm3
    from vulkan_raytracer_tpu.render import integrator as jint
    from vulkan_raytracer_tpu.render.renderer import camera_uniforms as jcamera_uniforms
    from vulkan_raytracer_tpu.scene import builtin as jbuiltin
    from vulkan_raytracer_tpu.scene import scenegraph as jsg
    from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
except ImportError:
    jax = None

import check_torch_shade  # noqa: E402
import torch_glb_assets  # noqa: E402
from vulkan_raytracer_tpu_torch.ops import _ext, bsdf, shade  # noqa: E402
from vulkan_raytracer_tpu_torch.ops.math3 import (  # noqa: E402
    EPS, INF, V3, v3_from_tangent, v3_to_tangent)
from vulkan_raytracer_tpu_torch.render import integrator as tint  # noqa: E402
from vulkan_raytracer_tpu_torch.render.renderer import camera_uniforms  # noqa: E402
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.camera import Camera  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
W = H = 64  # 4,096 lanes
B, DEPTH = 2, 4  # the bounce index the lanes shade at, and the depth
RTOL, ATOL = 1e-5, 1e-6
BSDF_MAX_LOOSE_LANES = 8  # tests/test_torch_ops.py
NEE_RTOL = 1e-4  # tests/test_torch_render.py
#: aten ops a bounce may run outside the shading wrappers and the traversal
#: calls: the emissive probe's lanes, ``vis_pre & ~occluded``
OPS_OUTSIDE = 2
SCENES = ("cornell_lights", "textured", "instanced", "glass")


def _lights(sg, scene, directional=True):
    scene.point_lights.append(sg.PointLight(np.array([0.4, 1.6, 0.3], np.float32),
                                            np.array([1.0, 0.9, 0.7], np.float32), 3.0, 0.0))
    scene.point_lights.append(sg.PointLight(np.array([-0.5, 1.2, 0.8], np.float32),
                                            np.array([0.6, 0.7, 1.0], np.float32), 2.0, 2.5))
    if directional:
        scene.directional_lights.append(sg.DirectionalLight(
            np.array([0.3, -1.0, -0.4], np.float32), np.array([1.0, 1.0, 1.0], np.float32), 1.5))
    return scene


def _build(name, tmp):
    """(JAX scene, port scene, camera position, direction, upload kwargs)."""
    if name == "cornell_lights":
        from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

        return (_lights(jsg, jbuiltin.cornell_box_scene()), _lights(tsg, cornell_box_scene()),
                [0.0, 1.0, 2.4], [0.0, 0.0, -1.0], {})
    if name == "textured":
        path = torch_glb_assets.write_textured_glb(tmp)
        out = []
        for sg in (jsg, tsg):
            s = sg.Scene()
            s.load_model(path)
            out.append(s)
        return (*out, [0.0, 0.0, 2.8], [0.0, 0.0, -1.0], {})
    if name == "instanced":
        from test_torch_instancing import instanced_scene

        return (instanced_scene(jsg), instanced_scene(tsg), [0.0, 1.2, 5.0], [0.0, -0.25, -1.0],
                {"instancing": True})
    from vulkan_raytracer_tpu_torch.scene.builtin import glass_sphere_scene

    return (_lights(jsg, jbuiltin.glass_sphere_scene(dispersion=0.4), directional=False),
            _lights(tsg, glass_sphere_scene(dispersion=0.4), directional=False),
            [0.0, 0.9, 2.6], [0.0, -0.2, -1.0], {})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what, loose=0):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=10 * RTOL if loose else RTOL,
                               atol=10 * ATOL if loose else ATOL, err_msg=what)
    with np.errstate(invalid="ignore"):  # inf - inf on lanes both sides agree on
        out = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert out.sum() <= loose, f"{what}: {out.sum()} lanes outside rtol 1e-5"


def _close_v3(got, want, what, loose=0):
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{what}[{k}]", loose)


class Lanes:
    """4,096 camera lanes of a scene at bounce :data:`B`: the port's wave
    state ``s`` and its closest hits, and the JAX package's same state from
    the same numpy inputs, at the same hits."""

    def __init__(self, name, tmp):
        jscene, tscene, pos, d, kw = _build(name, tmp)
        self.jt = jscene.upload(**kw)
        self.tt = tscene.upload("cpu", **kw)
        cam = Camera(position=np.array(pos), direction=np.array(d))
        jcam = JCamera(position=np.array(pos), direction=np.array(d))
        n = W * H
        r = np.random.default_rng(7)
        jo, jd, js = jint.generate_primary_rays(*jcamera_uniforms(jcam), W, H, 1)
        to, td, ts = tint.generate_primary_rays(*camera_uniforms(cam), W, H, 1, device="cpu")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        tp = r.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
        val = r.uniform(0.0, 0.5, (n, 3)).astype(np.float32)
        wl = np.where(r.random(n) < 0.5, 0.0, r.uniform(400, 700, n)).astype(np.float32)
        mat_pdf = r.uniform(0.1, 2.0, n).astype(np.float32)
        self.s = dict(origin=to, direction=td, value=V3(*map(torch.as_tensor, val.T.copy())),
                      throughput=V3(*map(torch.as_tensor, tp.T.copy())), seed=ts,
                      wavelength=torch.as_tensor(wl), mat_pdf=torch.as_tensor(mat_pdf),
                      active=torch.ones(n, dtype=torch.bool),
                      sky_w=V3.full((0.0, 0.0, 0.0), n, "cpu"),
                      preview=torch.zeros(n, dtype=torch.bool))
        self.js = dict(origin=jo, direction=jd, value=jm3.V3(*map(jnp.asarray, val.T)),
                       throughput=jm3.V3(*map(jnp.asarray, tp.T)), seed=js,
                       wavelength=jnp.asarray(wl), mat_pdf=jnp.asarray(mat_pdf),
                       active=jnp.ones(n, bool), preview=jnp.zeros(n, bool))
        (self.t, self.tri, self.u, self.v), self.seed = tint._closest(
            self.tt, to, td, t_min=EPS, t_max=INF, active=self.s["active"], seed=ts)
        # the JAX side shades the same hits (the traversals' own parity is
        # tests/test_torch_dense.py's, tests/test_torch_instancing.py's, ...)
        self.jraw = tuple(jnp.asarray(x.numpy()) for x in (self.t, self.tri, self.u, self.v))
        self.jseed = jnp.asarray(self.seed.numpy().astype(np.uint32))
        assert (self.tri.numpy() >= 0).sum() > n // 4

    def hit_state(self):
        return shade.shade_hit_reference(self.tt, self.s, B, DEPTH, self.t, self.tri, self.u,
                                         self.v)

    def probe(self, hs):
        return tint._emissive_pdf(self.tt, self.s["origin"], self.s["direction"], t_min=EPS,
                                  active=hs.probe_mask)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    if jax is None:
        pytest.skip("needs jax (the JAX package is the reference)")
    tmp = tmp_path_factory.mktemp("shade")
    return {name: Lanes(name, tmp) for name in SCENES}


def _jax_bounce(L: Lanes):
    """The JAX bounce body (integrator.py:975-1031) at the lanes' hits, up to
    and including its ``sample_lights``."""
    jt, s = L.jt, L.js
    hit = jint.eval_hit(jt, s["origin"], s["direction"], *L.jraw, sky=False)
    miss = L.jraw[1] < 0
    is_emissive = hit.mat.emissive.any_nonzero()
    terminal = miss | is_emissive | (B == DEPTH) | (s["preview"] & (B == 1))
    probe_mask = s["active"] & terminal & is_emissive & ~miss & (B != 0)
    pdf_probe = jint._emissive_pdf(jt, s["origin"], s["direction"], t_min=EPS,
                                   active=probe_mask)
    weight = jnp.where(probe_mask, jint._balance(s["mat_pdf"], pdf_probe), 1.0)
    value = s["value"] + (s["throughput"] * hit.mat.emissive * weight).where(
        s["active"] & terminal, jm3.V3(0.0, 0.0, 0.0))
    cont = s["active"] & ~terminal
    view = -s["direction"]
    tview = jm3.v3_to_tangent(view, hit.tangent, hit.bitangent, hit.normal)
    d_t, est, pdf_m, _, wl_new, seed_m = jbsdf.sample_material(L.jseed, hit, s["wavelength"],
                                                               tview)
    seed = jnp.where(cont, seed_m, L.jseed)
    wavelength = jnp.where(cont, wl_new, s["wavelength"])
    new_dir = jm3.v3_from_tangent(d_t, hit.tangent, hit.bitangent, hit.normal)
    throughput = (s["throughput"] * est).where(cont, s["throughput"])
    alive = cont & throughput.any_nonzero()
    light, seed_l, nee_rays = jint.sample_lights(jt, hit, wavelength, view, seed, alive)
    return dict(hit=hit, terminal=terminal, probe_mask=probe_mask, value=value, cont=cont,
                tview=tview, new_dir=new_dir.where(cont, s["direction"]),
                throughput=throughput, alive=alive, seed=seed, wavelength=wavelength,
                mat_pdf=jnp.where(cont, pdf_m, s["mat_pdf"]), light=light, seed_l=seed_l,
                nee_rays=nee_rays)


@pytest.mark.parametrize("scene", SCENES)
def test_plain_versions_match_jax(lanes, scene):
    """shade_hit / shade_scatter / shade_resolve (plain) against JAX's
    eval_hit, sample_material, material_bsdf, material_pdf and
    sample_lights on the same lanes."""
    L = lanes[scene]
    want = _jax_bounce(L)
    hs = L.hit_state()
    hit, jhit = hs.hit, want["hit"]
    # eval_hit and the masks
    for name in ("pos", "normal", "tangent", "bitangent"):
        _close_v3(getattr(hit, name), getattr(jhit, name), name)
    _close(hit.t, jhit.t, "t")
    np.testing.assert_array_equal(hit.front_face.numpy(), np.asarray(jhit.front_face))
    for name in ("base_colour", "emissive", "attenuation"):
        _close_v3(getattr(hit.mat, name), getattr(jhit.mat, name), f"mat.{name}")
    for name in ("metallic", "alpha_x", "alpha_y", "ad_x", "ad_y", "transmission", "ior",
                 "dispersion"):
        _close(getattr(hit.mat, name), getattr(jhit.mat, name), f"mat.{name}")
    np.testing.assert_array_equal(hit.mat.thin.numpy(), np.asarray(jhit.mat.thin))
    np.testing.assert_array_equal(hs.terminal.numpy(), np.asarray(want["terminal"]))
    np.testing.assert_array_equal(hs.probe_mask.numpy(), np.asarray(want["probe_mask"]))

    # sample_material and the next state
    st, ls = shade.shade_scatter_reference(L.tt, L.s, hs, L.probe(hs), L.seed)
    _close_v3(st["value"], want["value"], "value")
    np.testing.assert_array_equal(st["active"].numpy(), np.asarray(want["alive"]))
    _close_v3(st["direction"], want["new_dir"], "direction", loose=BSDF_MAX_LOOSE_LANES)
    _close_v3(st["throughput"], want["throughput"], "throughput", loose=BSDF_MAX_LOOSE_LANES)
    _close(st["mat_pdf"], want["mat_pdf"], "mat_pdf", loose=BSDF_MAX_LOOSE_LANES)
    _close(st["wavelength"], want["wavelength"], "wavelength")

    # material_bsdf and material_pdf at the sampled light, on JAX's hit
    jtv, jtl = (jm3.V3(*(jnp.asarray(c.numpy()) for c in v)) for v in (ls.tview, ls.tlight))
    _close_v3(ls.bsdf, jbsdf.material_bsdf(jhit, want["wavelength"], jtv, jtl), "bsdf",
              loose=BSDF_MAX_LOOSE_LANES)
    _close(bsdf.material_pdf(hit, ls.tview, ls.tlight), jbsdf.material_pdf(jhit, jtv, jtl),
           "material_pdf", loose=BSDF_MAX_LOOSE_LANES)

    # the light sample, the shadow ray, the probe and the resolve against
    # JAX's sample_lights
    occluded, seed = tint._shadow(L.tt, ls.ray_o, ls.light_dir, t_max=ls.t_max,
                                  active=ls.trace_mask, seed=st["seed"])
    visible = ls.vis_pre & ~occluded
    pdf_e = tint._emissive_pdf(L.tt, ls.ray_o, ls.light_dir, t_min=0.0, active=visible)
    light = shade.light_resolve(L.tt, hit, ls, occluded, visible, pdf_e, st["active"])
    np.testing.assert_array_equal(seed.numpy(), np.asarray(want["seed_l"]).astype(np.int64))
    for g, w in zip(light, want["light"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=NEE_RTOL, atol=ATOL)
    rays = torch.zeros((), dtype=torch.int64)
    st["seed"] = seed
    shade.shade_resolve_reference(L.tt, L.s, hs, st, ls, occluded, visible, pdf_e,
                                  "reference", rays)
    assert int(rays) == W * H + int(np.asarray(want["probe_mask"]).sum()) + int(
        want["nee_rays"])
    assert float(light.x.sum()) > 0


def _bits(x):
    x = x.numpy()
    return x.view(np.int32) if x.dtype == np.float32 else x


def _eq_fields(got, want):
    a, b = check_torch_shade._fields(got), check_torch_shade._fields(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, g), (_, w) in zip(a, b):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("nee", ["reference", "physical"])
def test_split_bit_equal_to_the_unsplit_bounce(lanes, scene, nee):
    """The hit state is eval_hit and the bounce's masks; the scatter, the
    shadow query, the probe and the resolve are the material sample and
    sample_lights: the value, seeds and rays bit for bit."""
    L = lanes[scene]
    s, tt = L.s, L.tt
    hs = L.hit_state()
    hit = tint.eval_hit(tt, s["origin"], s["direction"], L.t, L.tri, L.u, L.v)
    _eq_fields(hs.hit, hit)
    miss = L.tri < 0
    is_emissive = hit.mat.emissive.any_nonzero()
    terminal = miss | is_emissive | (B == DEPTH) | (s["preview"] & (B == 1))
    np.testing.assert_array_equal(hs.terminal.numpy(), terminal.numpy())
    np.testing.assert_array_equal(
        hs.probe_mask.numpy(), (s["active"] & terminal & is_emissive & ~miss & (B != 0)).numpy())

    pdf_probe = L.probe(hs)
    st, ls = shade.shade_scatter_reference(tt, s, hs, pdf_probe, L.seed)
    # the unsplit bounce up to NEE (integrator._bounce before this split)
    cont = s["active"] & ~terminal
    view = -s["direction"]
    tview = v3_to_tangent(view, hit.tangent, hit.bitangent, hit.normal)
    d_t, est, pdf_m, _, wl_new, seed_m = bsdf.sample_material(L.seed, hit, s["wavelength"], tview)
    seed = torch.where(cont, seed_m, L.seed)
    wavelength = torch.where(cont, wl_new, s["wavelength"])
    new_dir = v3_from_tangent(d_t, hit.tangent, hit.bitangent, hit.normal)
    throughput = (s["throughput"] * est).where(cont, s["throughput"])
    alive = cont & throughput.any_nonzero()
    _eq_fields({k: st[k] for k in ("direction", "throughput", "wavelength", "active")},
               dict(direction=new_dir.where(cont, s["direction"]), throughput=throughput,
                    wavelength=wavelength, active=alive))
    light, seed_u, rays_u = tint.sample_lights(tt, hit, wavelength, view, seed, alive)

    occluded, st["seed"] = tint._shadow(tt, ls.ray_o, ls.light_dir, t_max=ls.t_max,
                                        active=ls.trace_mask, seed=st["seed"])
    visible = ls.vis_pre & ~occluded
    pdf_e = tint._emissive_pdf(tt, ls.ray_o, ls.light_dir, t_min=0.0, active=visible)
    rays = torch.zeros((), dtype=torch.int64)
    value = shade.shade_resolve_reference(tt, s, hs, st, ls, occluded, visible, pdf_e, nee,
                                          rays)
    ntp = throughput if nee == "reference" else s["throughput"]
    _eq_fields(value, st["value"] + (ntp * light).where(alive, 0.0))
    np.testing.assert_array_equal(st["seed"].numpy(), seed_u.numpy())
    assert int(rays) == int(s["active"].sum() + hs.probe_mask.sum() + rays_u)


class _Budget(TorchDispatchMode):
    """aten ops by region: inside a shading wrapper, inside a traversal
    call, or outside both."""

    def __init__(self):
        super().__init__()
        self.region = ["outside"]
        self.ops = {"outside": [], "shade": [], "traversal": []}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[self.region[-1]].append(str(func))
        return func(*args, **(kwargs or {}))


def _routed(monkeypatch, budget, fail=None):
    """The wrappers routed to their kernels on CPU tensors with the launch
    stubbed (a no-op, or raising ``fail``); the traversal calls opaque."""
    launched = []

    def launch(fn, device, *args):
        if fail is not None:
            raise fail
        launched.append(fn)

    monkeypatch.setattr(shade, "_on_cuda", lambda tables, lanes: True)
    monkeypatch.setattr(_ext, "launch", launch)
    for name in ("shade_hit", "shade_scatter", "shade_resolve"):
        monkeypatch.setattr(shade, name, _region(budget, "shade", getattr(shade, name)))
    for name in ("_closest", "_shadow", "_emissive_pdf"):
        monkeypatch.setattr(tint, name, _region(budget, "traversal", getattr(tint, name)))
    return launched


def _region(budget, region, fn):
    def call(*args, **kw):
        if budget is not None:
            budget.region.append(region)
        try:
            return fn(*args, **kw)
        finally:
            if budget is not None:
                budget.region.pop()
    return call


def _cpu_state(tables, n=256):
    """A wave state of the 16x16 camera lanes of bench cfg1's camera."""
    cam = Camera(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))
    o, d, seed = tint.generate_primary_rays(*camera_uniforms(cam), 16, 16, 1, device="cpu")
    return dict(origin=o, direction=d, value=V3.full((0.0, 0.0, 0.0), n, "cpu"),
                throughput=V3.full((1.0, 1.0, 1.0), n, "cpu"), seed=seed,
                wavelength=torch.zeros(n), mat_pdf=torch.ones(n),
                active=torch.ones(n, dtype=torch.bool), sky_w=V3.full((0.0, 0.0, 0.0), n, "cpu"),
                preview=torch.zeros(n, dtype=torch.bool))


@pytest.mark.parametrize("tensor_b", [False, True])
def test_bounce_runs_few_aten_ops_beside_its_kernels(monkeypatch, tensor_b):
    """With the shading kernels launched (stubbed) and the traversal opaque,
    one bounce of the lit Cornell box runs at most OPS_OUTSIDE aten ops of
    its own; the wrappers only allocate their outputs and view them; each
    kernel launches once, also with ``b`` on the device."""
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    tables = _lights(tsg, cornell_box_scene()).upload("cpu")
    s = _cpu_state(tables)
    budget = _Budget()
    launched = _routed(monkeypatch, budget)
    shade.reset_launches()
    b = torch.tensor(1, dtype=torch.int32) if tensor_b else 1
    rays = torch.zeros((), dtype=torch.int64)
    with budget:
        out, _ = tint._bounce(tables, s, b, DEPTH, "reference", rays)
    assert launched == ["shade_hit_launch", "shade_scatter_launch", "shade_resolve_launch"]
    assert shade.LAUNCHES == {"hit": 1, "scatter": 1, "resolve": 1}
    assert len(budget.ops["outside"]) <= OPS_OUTSIDE, budget.ops["outside"]
    assert set(budget.ops["shade"]) <= {"aten.empty.memory_format", "aten.unbind.int"}, \
        sorted(set(budget.ops["shade"]))
    assert set(out) == set(s)


@pytest.mark.parametrize("kernel", ["hit", "scatter", "resolve"])
def test_failed_launch_raises_without_the_plain_version(monkeypatch, kernel):
    """A wrapper on the card whose launch fails raises; it never runs its
    plain version."""
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    tables = cornell_box_scene().upload("cpu")
    s = _cpu_state(tables)
    (t, tri, u, v), seed = tint._closest(tables, s["origin"], s["direction"], t_min=EPS,
                                         t_max=INF, active=s["active"], seed=s["seed"])
    hs = shade.shade_hit(tables, s, 1, DEPTH, t, tri, u, v)
    st, ls = shade.shade_scatter(tables, s, hs, torch.zeros(256), seed)
    occ = torch.zeros(256, dtype=torch.bool)
    plain = []
    for name in ("shade_hit_reference", "shade_scatter_reference", "shade_resolve_reference"):
        monkeypatch.setattr(shade, name, lambda *a, _n=name, **k: plain.append(_n))
    _routed(monkeypatch, None, fail=RuntimeError("shade: CUDA error 700"))
    calls = {"hit": lambda: shade.shade_hit(tables, s, 1, DEPTH, t, tri, u, v),
             "scatter": lambda: shade.shade_scatter(tables, s, hs, torch.zeros(256), seed),
             "resolve": lambda: shade.shade_resolve(tables, s, hs, st, ls, occ, occ,
                                                    torch.zeros(256), "reference",
                                                    torch.zeros((), dtype=torch.int64))}
    with pytest.raises(RuntimeError, match="CUDA error"):
        calls[kernel]()
    assert plain == []


def test_slots_are_the_kernel_source_enums():
    """ops/shade.py's SLOTS and INTS name csrc/shade.cu's enums in order."""
    src = (ROOT / "vulkan_raytracer_tpu_torch" / "csrc" / "shade.cu").read_text()

    def enum(name):
        body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        return tuple(w.strip() for w in body.split(",") if w.strip())

    assert enum("Slot") == (*shade.SLOTS, "kSlots")
    assert enum("Int") == (*shade.INTS, "kInts")
    assert len(set(shade.SLOTS)) == len(shade.SLOTS)
    assert "shade.cu" in {p.name for p in _ext.SOURCES}


def _kernel_columns(src: str) -> dict:
    """kernel -> the lane columns that csrc/shade.cu's kernel and the
    functions it calls name (a V3's X slot standing for its three)."""
    src = re.sub(r"//[^\n]*", "", src)
    bodies = {}
    for m in re.finditer(r"\b(\w+)\s*\((?:[^;{}()]|\([^;{}()]*\))*\)\s*\{", src):
        depth, end = 0, m.end() - 1
        for end in range(m.end() - 1, len(src)):
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            if depth == 0:
                break
        if m.group(1) not in ("if", "for", "while", "switch"):
            bodies.setdefault(m.group(1), src[m.end():end])
    lane = {x for x in shade.SLOTS if x.split("_")[0] in "S C R X O L Z".split()} - {"Z_RAYS"}
    out = {}
    for kernel in shade.MOVES:
        seen, todo, cols = set(), [f"shade_{kernel}_kernel"], set()
        while todo:
            body = bodies[todo.pop()]
            for w in set(re.findall(r"\b\w+\b", body)):
                if w in bodies and w not in seen:
                    seen.add(w)
                    todo.append(w)
                if w in lane:
                    cols.add(w)
                    if w.endswith("X") and {w[:-1] + "Y", w[:-1] + "Z"} <= lane:
                        cols |= {w[:-1] + "Y", w[:-1] + "Z"}
        out[kernel] = cols
    return out


def test_moved_columns_are_the_kernel_source_loads():
    """The columns ops/shade.py counts in each kernel's bytes bound are those
    the kernel names in csrc/shade.cu, and each is a slot; the wrappers pass
    every record column whichever the kernel reads."""
    src = (ROOT / "vulkan_raytracer_tpu_torch" / "csrc" / "shade.cu").read_text()
    assert {k: set(v) for k, v in shade.MOVES.items()} == _kernel_columns(src)
    assert set(shade.MOVES["scatter"]) < set(shade.SLOTS)
    assert "X_PDF_PROBE" not in _kernel_columns(src)["hit"]


def test_lane_bytes_count_the_lanes_read(monkeypatch):
    """A column a kernel reads on some lanes only counts on those lanes: the
    hit reads ``preview`` only where the path may go on; at bounce 0 the
    scatter reads no probe pdf and the old origin only where the path
    stops; the resolve reads one of the two throughputs, the light's
    radiance where it traced, and the material and emissive pdfs where the
    emissive strategy was drawn."""
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    tables = _lights(tsg, cornell_box_scene()).upload("cpu")
    s = _cpu_state(tables)
    s["active"] = torch.arange(256) % 3 != 0
    (t, tri, u, v), seed = tint._closest(tables, s["origin"], s["direction"], t_min=EPS,
                                         t_max=INF, active=s["active"], seed=s["seed"])
    hit_args = (tables, s, 0, DEPTH, t, tri, u, v)
    hs = shade.shade_hit_reference(*hit_args)
    probe = torch.zeros(256)
    st, ls = shade.shade_scatter_reference(tables, s, hs, probe, seed)
    occ = torch.arange(256) % 5 == 0
    res_args = (tables, s, hs, st, ls, occ, ls.vis_pre & ~occ, torch.zeros(256), "reference",
                torch.zeros((), dtype=torch.int64))
    _routed(monkeypatch, None)
    shade.shade_hit(*hit_args)
    shade.shade_scatter(tables, s, hs, probe, seed)
    shade.shade_resolve(*res_args)

    def every_lane(kernel, mask=None):
        n, size = shade._LAST[kernel]
        return sum(n * size[c] for c, m in shade.MOVES[kernel].items()
                   if c in size and (mask is None or m == mask))

    em = hs.hit.mat.emissive
    preview = int(((tri >= 0) & (em.x == 0) & (em.y == 0) & (em.z == 0)).sum())
    assert 0 < preview < 256
    assert shade.lane_bytes("hit", hit_args, hs) == every_lane("hit") - (256 - preview)
    stay = int((~(s["active"] & ~hs.terminal)).sum())
    assert not hs.probe_mask.any() and 0 < stay < 256
    assert (shade.lane_bytes("scatter", (tables, s, hs, probe, seed), (st, ls))
            == every_lane("scatter") - 256 * 4 - (256 - stay) * 12)
    picked, unlit = int(ls.pick.sum()), int((occ | ~ls.trace_mask).sum())
    assert 0 < picked < 256 and 0 < unlit < 256
    assert (shade.lane_bytes("resolve", res_args, None)
            == every_lane("resolve") - 256 * 12 - int(occ.sum()) - unlit * 12
            - picked * every_lane("resolve", "mis") // 256)


def test_check_tool_finds_no_lane_on_the_cpu():
    """tools/check_torch_shade.py with both sides plain (the CPU)."""
    with tempfile.TemporaryDirectory() as tmp:
        specs = check_torch_shade.configs(Path(tmp))
        for name in ("cfg1", "textured"):
            build, cam, _, _, _, depth = specs[name]
            line = check_torch_shade.check_config(name, (build, cam, 16, 16, 2, depth),
                                                  torch.device("cpu"))
            assert line["differing_lanes"] == 0 and line["finite"]
            assert line["calls"]["hit"] == line["calls"]["resolve"] >= 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["cfg1", "textured", "glass_lights", "gallery", "soup",
                                    "cfg4"])
def test_cuda_kernels_match_plain(config, cuda_device):
    """Each kernel against its plain version on the card, on every bounce
    state of a 128x128 wave of the config: bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        build, cam, _, _, spp, depth = check_torch_shade.configs(Path(tmp))[config]
        line = check_torch_shade.check_config(config, (build, cam, 128, 128, 2, depth),
                                              cuda_device)
    assert line["finite"] and line["launches"] == line["calls"]
    assert line["differing_lanes"] == 0, line["first"]
