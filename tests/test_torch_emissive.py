"""The port's emissive-BVH pdf probe against the JAX package's.

Scenes with more than ``EMISSIVE_MAX_TRIS`` (1,024) emissive triangles take
their MIS and NEE pdf probes through a walk of the emissive-only BVH:
``trace_emissive_pdf`` (vulkan_raytracer_tpu/ops/traverse.py:241) in the JAX
package, ``bvh_emissive_pdf`` in the port.  On the CPU the port runs the
walk's plain version, which the card-only test at the end holds the CUDA
kernel against.

Tolerances.  The walk is held to rtol 1e-5 / atol 1e-7 against JAX: both add
the same terms in the same order (visit order, a leaf at a time), so what is
left are last-ulp differences of the frameworks' float32 divide, sqrt and
sum (ROADMAP.md Queue 3).  The CUDA kernel is built with ``--fmad=false``
like every kernel of the library, so its products round as the plain
version's; it is held to the same tolerance, not to bit-equality, because
its divides and its square root are the compiler's.  Inactive lanes are
exactly 0 everywhere.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

from vulkan_raytracer_tpu_torch.ops import dense as tdense  # noqa: E402
from vulkan_raytracer_tpu_torch.ops import traverse as ttr  # noqa: E402
from vulkan_raytracer_tpu_torch.ops.math3 import V3 as TV3  # noqa: E402
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg  # noqa: E402
from vulkan_raytracer_tpu_torch.scene import convert  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7
EPS = 1e-7
W = H = 32
SPP, DEPTH = 2, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _cols(a):
    return tuple(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3))


def _unit_rays(n, seed, extent):
    r = np.random.default_rng(seed)
    o = r.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, r


def test_walk_matches_jax_on_the_traverse_test_inputs():
    """The inputs of tests/test_traverse.py:166-204: 40 random triangles
    (seed 9), random p_delta and vertex normals (seed 10), 200 rays (seed
    11), every lane active."""
    import jax.numpy as jnp
    from vulkan_raytracer_tpu.accel.bvh import build_bvh as jbuild_bvh
    from vulkan_raytracer_tpu.ops import traverse as jtr

    r = np.random.default_rng(9)
    v0 = r.uniform(-2.0, 2.0, (40, 3)).astype(np.float32)
    v1 = v0 + r.normal(0, 0.6, (40, 3)).astype(np.float32)
    v2 = v0 + r.normal(0, 0.6, (40, 3)).astype(np.float32)
    r = np.random.default_rng(10)
    p_delta = r.uniform(0.01, 1.0, 40).astype(np.float32)
    p_delta /= p_delta.sum()
    n0, n1, n2 = (r.normal(size=(40, 3)).astype(np.float32) for _ in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1).astype(np.float32)
    o, d, _ = _unit_rays(200, 11, 3.0)

    jebvh = jbuild_bvh(v0, v1, v2, leaf_size=4)
    jem = jtr.EmissivePDFTables(*(jnp.asarray(a) for a in (p_delta, area, n0, n1, n2)))
    want = np.asarray(jtr.trace_emissive_pdf(jebvh, jem, jnp.asarray(o), jnp.asarray(d),
                                             t_min=EPS, active=jnp.ones(200, bool)))

    tem = tsg.EmissivePDFTables(*(torch.as_tensor(a) for a in (p_delta, area, n0, n1, n2)))
    stream = ttr.build_emissive_stream(convert._bvh_from_numpy(jebvh), tem)
    assert stream.rows.shape == (40, 20) and stream.num_nodes == jebvh.num_nodes
    got = ttr.emissive_pdf_walk(stream, _cols(o) + _cols(d), torch.ones(200, dtype=torch.bool),
                                EPS).numpy()
    assert (want > 0).sum() > 10
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _soup_scene(pkg, n_grey, n_emissive, seed):
    """A soup in the Cornell volume built with package ``pkg``: ``n_grey``
    diffuse triangles (if any) and ``n_emissive`` small emissive ones, two
    ``add_raw_mesh`` calls from one numpy seed."""
    sg = importlib.import_module(f"{pkg}.scene.scenegraph")
    r = np.random.default_rng(seed)
    s = sg.Scene()

    def mesh(n, spread, material):
        base = r.uniform([-1.0, 0.0, -1.0], [1.0, 2.0, 1.0], (n, 3)).astype(np.float32)
        offs = r.normal(0.0, spread, (n, 2, 3)).astype(np.float32)
        pos = np.concatenate([base, base + offs[:, 0], base + offs[:, 1]], 1).reshape(-1, 3)
        nrm = np.cross(offs[:, 0], offs[:, 1])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
        s.add_raw_mesh(pos, np.repeat(nrm, 3, axis=0).astype(np.float32),
                       np.arange(3 * n, dtype=np.uint32), material)

    if n_grey:
        mesh(n_grey, 0.3, sg.Material())
    light = sg.Material()
    light.emissive_factor = np.array([3.0, 2.5, 2.0], np.float32)
    mesh(n_emissive, 0.06 if n_grey else 0.15, light)
    return s


_TABLES = {}


def _tables(n_grey, n_emissive):
    """(JAX tables, port tables on the CPU carried over from them)."""
    key = (n_grey, n_emissive)
    if key not in _TABLES:
        import jax

        jt = _soup_scene("vulkan_raytracer_tpu", n_grey, n_emissive, seed=5).upload()
        _TABLES[key] = (jt, convert.tables_from_numpy(
            jax.tree_util.tree_map(np.asarray, jt), "cpu"))
    return _TABLES[key]


@pytest.mark.parametrize("t_min", [EPS, 0.0])
def test_bvh_emissive_pdf_matches_jax_on_an_emissive_soup(t_min):
    """A 2,000-triangle all-emissive soup, 1,500 rays inside it, 20% of the
    lanes inactive, at both t_min the integrator uses (EPS for the MIS
    probe, 0 for the NEE probe)."""
    import jax.numpy as jnp
    from vulkan_raytracer_tpu.ops import traverse as jtr

    jt, tt = _tables(0, 2000)
    assert tt.num_emissive_tris == 2000 > tdense.EMISSIVE_MAX_TRIS
    o, d, r = _unit_rays(1500, 21, 0.9)
    o[:, 1] += 1.0
    active = r.random(1500) < 0.8
    want = np.asarray(jtr.trace_emissive_pdf(jt.ebvh, jt.em_tables, jnp.asarray(o),
                                             jnp.asarray(d), t_min=t_min,
                                             active=jnp.asarray(active)))
    got = ttr.bvh_emissive_pdf(tt, TV3(*_cols(o)), TV3(*_cols(d)), t_min=t_min,
                               active=torch.as_tensor(active)).numpy()
    assert (want[active] > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[~active] == 0.0).all() and (want[~active] == 0.0).all()


@pytest.mark.parametrize("source", ["converted", "uploaded"])
def test_ebvh_bit_equal_to_the_jax_upload(source):
    """The emissive-only BVH of the port's tables, carried over by
    scene/convert.py or built by the port's own upload, is the JAX upload's
    bit for bit; so is what the probe reads beside it."""
    jt, tt = _tables(300, 1200)
    if source == "uploaded":
        tt = _soup_scene("vulkan_raytracer_tpu_torch", 300, 1200, seed=5).upload("cpu")
    assert tt.ebvh.leaf_size == jt.ebvh.leaf_size == 4
    for name in ("aabb_min", "aabb_max", "first_tri", "miss", "tri_v0", "tri_e1", "tri_e2",
                 "tri_id"):
        np.testing.assert_array_equal(getattr(tt.ebvh, name).numpy(),
                                      np.asarray(getattr(jt.ebvh, name)), err_msg=name)
    for name in ("p_delta", "area", "n0", "n1", "n2"):
        np.testing.assert_array_equal(getattr(tt.em_tables, name).numpy(),
                                      np.asarray(getattr(jt.em_tables, name)), err_msg=name)
    # the packed stream holds every emissive triangle once, in slot order
    ids = tt.ebvh.tri_id.numpy()
    ids = ids[ids >= 0]
    assert sorted(ids.tolist()) == list(range(1200))
    np.testing.assert_array_equal(tt.em_stream.rows[:, 9].numpy(),
                                  tt.em_tables.p_delta.numpy()[ids])
    assert tt.to("cpu").ebvh.num_nodes == tt.ebvh.num_nodes


def test_stream_leaf_records_by_hand():
    """Five triangles in a row along x, leaf size 4: the stream's leaves hold
    the count of their real slots and the first of their rows, interior
    nodes the BVH's skip pointer."""
    x = np.arange(5, dtype=np.float32)[:, None] * np.float32([2, 0, 0])
    v0, v1, v2 = x, x + np.float32([1, 0, 0]), x + np.float32([0, 1, 0])
    from vulkan_raytracer_tpu_torch.accel.bvh import build_bvh

    bvh = build_bvh(v0, v1, v2, leaf_size=4)
    em = tsg.EmissivePDFTables(
        p_delta=torch.arange(5, dtype=torch.float32), area=torch.full((5,), 0.5),
        n0=torch.ones(5, 3), n1=torch.ones(5, 3), n2=torch.ones(5, 3))
    s = ttr.build_emissive_stream(bvh, em)
    words = s.nodes.view(torch.int32)
    first, miss = bvh.first_tri.numpy(), bvh.miss.numpy()
    counts = 0
    for i in range(bvh.num_nodes):
        if first[i] >= 0:
            count = int(words[i, 7])
            ids = bvh.tri_id.numpy()[first[i]:first[i] + 4]
            assert count == (ids >= 0).sum() and int(words[i, 3]) == counts
            np.testing.assert_array_equal(s.rows[counts:counts + count, 9].numpy(),
                                          ids[ids >= 0].astype(np.float32))
            counts += count
        else:
            assert int(words[i, 3]) == -1 and int(words[i, 7]) == miss[i]
    assert counts == 5 and s.nbytes == s.nodes.nbytes + s.rows.nbytes
    # a ray down through triangle 3 adds that triangle's term only
    rays = tuple(torch.tensor([c], dtype=torch.float32) for c in (6.25, 0.25, 1.0, 0.0, 0.0, -1.0))
    pdf = ttr.emissive_pdf_walk(s, rays, torch.ones(1, dtype=torch.bool), EPS)
    n_hat_d = 1.0 / np.sqrt(3.0)
    assert pdf.item() == pytest.approx(3.0 * 1.0 / (0.5 * n_hat_d), rel=1e-6)
    v = ttr.emissive_walk_visits(s, rays, torch.ones(1, dtype=torch.bool), EPS)
    assert int(v["hits"].sum()) == 1 and int(v["nodes"].sum()) >= 2 and v["tri_rows"] >= 1


def test_walk_refuses_what_the_kernel_does_not_take():
    jt, tt = _tables(0, 2000)
    rays = tuple(torch.zeros(4) for _ in range(6))
    with pytest.raises(ValueError):
        ttr.emissive_pdf_walk(tt.em_stream, rays, torch.ones(4, dtype=torch.bool, device="meta"),
                              EPS)


def _cam(cls):
    return cls(position=np.array([0.0, 1.0, 3.2]), direction=np.array([0.0, 0.0, -1.0]))


def test_render_with_emissive_bvh_matches_jax(monkeypatch):
    """300 grey and 1,200 emissive triangles, 32x32, 2 spp, depth 3: both
    probes go through the walk (calls with live lanes counted at t_min EPS,
    the MIS probe, and 0, the NEE probe), and the image is the JAX render's:
    RMSE < 1e-6; ray counts within 0.1% (a lane whose hit flips on a
    last-ulp difference traces another number of rays, ROADMAP.md Queue 3)."""
    from vulkan_raytracer_tpu.render.renderer import render_image as jrender_image
    from vulkan_raytracer_tpu.scene.camera import Camera as JCamera

    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    jt, tt = _tables(300, 1200)
    assert tt.num_emissive_tris == 1200 and tt.pbvh is None
    probes = {EPS: 0, 0.0: 0}
    walk = ttr.emissive_pdf_walk

    def counting(stream, rays, active, t_min):
        probes[t_min] += int(active.any())
        return walk(stream, rays, active, t_min)

    monkeypatch.setattr(ttr, "emissive_pdf_walk", counting)
    img_t, rays_t = render_image(tt, _cam(Camera), W, H, spp=SPP, max_depth=DEPTH, tonemap=False)
    assert probes[EPS] > 0 and probes[0.0] > 0, probes
    img_j, rays_j = jrender_image(jt, _cam(JCamera), W, H, spp=SPP, max_depth=DEPTH,
                                  tonemap=False)
    rmse = float(np.sqrt(np.mean((img_t - np.asarray(img_j)) ** 2)))
    assert np.isfinite(img_t).all() and img_t.mean() > 1e-3
    assert rmse < 1e-6, f"port vs JAX RMSE {rmse}"
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)


# ---------------------------------------------------------------------------
# The CUDA walk against its plain version (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("share", cs.LIVE_SHARES)
@pytest.mark.parametrize("n_tris", [2000, 20000])
def test_cuda_emissive_walk_matches_plain(n_tris, share, cuda_device):
    """emissive_walk_kernel against emissive_pdf_walk_reference on an
    all-emissive soup, at 524,288 rays (a whole number of 128-thread blocks)
    and at a ragged 524,251, with the given share of live lanes (all-live,
    all-dead and mixed blocks), at both t_min the render uses: within rtol
    1e-5 / atol 1e-7 on live lanes, exactly +0 elsewhere; one launch each."""
    tt = cs.soup_scene(n_tris, seed=7).upload(cuda_device)
    stream = tt.em_stream
    before = ttr.LAUNCHES["emissive_pdf"]
    for n in (524288, 524251):
        rays = cs.make_rays(n, seed=n, device=cuda_device)
        cols = tdense.ray_columns(rays["o"], rays["d"])
        active = torch.as_tensor(cs.live_mask(n, share, seed=n), device=cuda_device)
        for t_min in (EPS, 0.0):
            got = ttr.emissive_pdf_walk(stream, cols, active, t_min)
            want = ttr.emissive_pdf_walk_reference(stream, cols, active, t_min)
            torch.testing.assert_close(got[active], want[active], rtol=RTOL, atol=ATOL)
            off = got[~active]
            assert bool((off == 0.0).all()) and not bool(torch.signbit(off).any())
    assert ttr.LAUNCHES["emissive_pdf"] - before == 4
