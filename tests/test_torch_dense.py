"""The port's dense sweeps against the JAX package's.

The plain PyTorch versions (what the port runs on CPU tensors) are held
against ``pallas_closest`` / ``pallas_shadow`` / ``pallas_emissive_pdf`` in
Pallas interpret mode and against the XLA fold (``dense_closest`` /
``dense_shadow`` / ``dense_emissive_pdf``), on the rays of
tests/test_pallas.py, over the built-in Cornell box and a 200-triangle
emissive soup.  Hit ids and occlusion flags must be equal; t, u, v agree
within rtol 1e-5 and the pdf within rtol 1e-4 / atol 1e-6 (last-ulp
differences of the frameworks' float32 arithmetic, and the pdf's sum order).
The closest and pdf cases run with all, 5% and none of the lanes live, at a
whole number of the card kernels' 256-lane blocks and at a ragged count.

Tests marked ``cuda`` compare the CUDA kernels with their plain versions on
the card and skip without one.  The module imports jax only inside the
parity tests, because the card's machine has no jax; run the card tests
there with ``python -m pytest tests/test_torch_dense.py -m cuda --noconftest``
(tests/conftest.py imports jax).
"""

import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

from vulkan_raytracer_tpu_torch.ops import dense as tdense  # noqa: E402
from vulkan_raytracer_tpu_torch.ops.math3 import V3 as TV3  # noqa: E402
from vulkan_raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy  # noqa: E402

N = 1024
#: live shares of the parity cases (of the lanes each test's own pattern
#: leaves active), and their ray counts (the second ragged)
LIVE = [1.0, 0.05, 0.0]
COUNTS = [N, N - 37]


@pytest.fixture
def interpret():
    os.environ["VKRT_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("VKRT_PALLAS_INTERPRET", None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _soup_scene(sg, n_tris=200, seed=0):
    """A random emissive triangle soup around the Cornell volume, built with
    scene-graph module ``sg`` (the JAX package's or the port's)."""
    r = np.random.default_rng(seed)
    base = r.uniform([-1.0, 0.0, -1.0], [1.0, 2.0, 1.0], (n_tris, 3)).astype(np.float32)
    offs = r.normal(0, 0.3, (n_tris, 2, 3)).astype(np.float32)
    pos = np.concatenate([base, base + offs[:, 0], base + offs[:, 1]], axis=1).reshape(-1, 3)
    nrm = np.cross(offs[:, 0], offs[:, 1])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
    m = sg.Material()
    m.emissive_factor = np.array([3.0, 2.0, 1.0], np.float32)
    s = sg.Scene()
    s.add_raw_mesh(pos, np.repeat(nrm, 3, axis=0).astype(np.float32),
                   np.arange(3 * n_tris, dtype=np.uint32), m)
    return s


def _scene(name, pkg):
    """The named test scene built with package ``pkg``'s scene modules."""
    builtin = importlib.import_module(f"{pkg}.scene.builtin")
    sg = importlib.import_module(f"{pkg}.scene.scenegraph")
    return builtin.cornell_box_scene() if name == "cornell" else _soup_scene(sg)


_TABLES = {}


def _tables(name):
    """(JAX tables, port tables on CPU) for a scene, built once."""
    if name not in _TABLES:
        import jax

        jt = _scene(name, "vulkan_raytracer_tpu").upload()
        _TABLES[name] = (jt, tables_from_numpy(jax.tree_util.tree_map(np.asarray, jt), "cpu"))
    return _TABLES[name]


def _rays(seed, dy=1.0, up=False, n=N):
    """The ray generator of tests/test_pallas.py, for both packages: the
    first n of its N rays."""
    import jax.numpy as jnp
    from vulkan_raytracer_tpu.ops.math3 import V3 as JV3

    r = np.random.default_rng(seed)
    o = r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)[:n]
    o[:, 1] += dy
    d = r.normal(size=(N, 3)).astype(np.float32)[:n]
    if up:
        d[:, 1] = np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jo = JV3(*(jnp.asarray(o[:, k]) for k in range(3)))
    jd = JV3(*(jnp.asarray(d[:, k]) for k in range(3)))
    to = TV3(*(torch.as_tensor(o[:, k].copy()) for k in range(3)))
    td = TV3(*(torch.as_tensor(d[:, k].copy()) for k in range(3)))
    return jo, jd, to, td, r


def _live(pattern, live, r):
    """A share ``live`` of the lanes a test's pattern leaves active.  (Lanes
    off the pattern stay dead: on one of them, 890 of the closest rays, two
    Cornell triangles lie 1 ulp apart in t and the Pallas interpreter's
    rounding picks the other.)"""
    return pattern & (r.random(pattern.shape[0]) < live)


def _jax_impl(kind, which):
    mod = "dense" if which == "xla" else "pallas_dense"
    prefix = "dense" if which == "xla" else "pallas"
    return getattr(importlib.import_module(f"vulkan_raytracer_tpu.ops.{mod}"), f"{prefix}_{kind}")


@pytest.mark.parametrize("which", ["pallas", "xla"])
@pytest.mark.parametrize("scene", ["cornell", "soup200"])
@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("live", LIVE)
def test_closest_plain_matches_jax(live, n, scene, which, interpret):
    import jax.numpy as jnp

    jt, tt = _tables(scene)
    jo, jd, to, td, r = _rays(0, n=n)
    act = _live(np.arange(n) % 5 != 0, live, r)
    want = _jax_impl("closest", which)(jt, jo, jd, t_min=1e-7, t_max=1e32,
                                       active=jnp.asarray(act))
    got = tdense.dense_closest(tt, to, td, t_min=1e-7, t_max=1e32, active=torch.as_tensor(act))
    tri = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), tri)
    assert (tri >= 0).sum() > (N // 4 if (live, n) == (1.0, N) else act.sum() // 4) or not act.any()
    assert (tri[~act] < 0).all()
    m = tri >= 0
    for k in (0, 2, 3):  # t, u, v
        np.testing.assert_allclose(got[k].numpy()[m], np.asarray(want[k])[m], rtol=1e-5,
                                   atol=1e-6)
    assert np.isinf(got[0].numpy()[~m]).all()


@pytest.mark.parametrize("scene", ["cornell", "soup200"])
def test_closest_dead_lanes_keep_t_init(scene, interpret):
    """Lanes whose lower bound reaches their upper one (t_lo >= t_init, as the
    alpha loop leaves settled lanes) miss in the JAX kernel and return
    exactly t_init and -1 from the sweep; the other lanes hit as before."""
    import jax.numpy as jnp

    jt, tt = _tables(scene)
    jo, jd, to, td, r = _rays(0)
    t_max = r.uniform(0.5, 4.0, N).astype(np.float32)
    dead = (np.arange(N) % 5 == 0) | (r.random(N) < 0.5)  # lanes off the pattern: see _live
    # at, and beyond, the lane's t_max
    t_min = np.where(dead, t_max * np.where(r.random(N) < 0.5, 1.0, 1.5), 1e-7)
    t_min = t_min.astype(np.float32)
    act = np.ones(N, bool)
    want = _jax_impl("closest", "pallas")(jt, jo, jd, t_min=jnp.asarray(t_min),
                                          t_max=jnp.asarray(t_max), active=jnp.asarray(act))
    got = tdense.dense_closest(tt, to, td, t_min=torch.as_tensor(t_min),
                               t_max=torch.as_tensor(t_max), active=torch.as_tensor(act))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (np.asarray(want[1])[dead] < 0).all() and (np.asarray(want[1])[~dead] >= 0).any()
    cols = tdense.ray_columns(to, td)
    t_init = torch.as_tensor(t_max)
    t, tri = tdense.closest_sweep(tt.tri_table, cols, torch.as_tensor(t_min), t_init)
    d = torch.as_tensor(dead)
    assert torch.equal(t[d], t_init[d]) and bool((tri[d] == -1).all())
    assert torch.equal(tri, got[1])


@pytest.mark.parametrize("which", ["pallas", "xla"])
@pytest.mark.parametrize("scene", ["cornell", "soup200"])
def test_shadow_plain_matches_jax(scene, which, interpret):
    """Dead lanes and per-lane t_max below / straddling / above the hits."""
    import jax.numpy as jnp

    jt, tt = _tables(scene)
    jo, jd, to, td, r = _rays(8)
    act = np.arange(N) % 4 != 0
    t_max = r.uniform(0.05, 5.0, N).astype(np.float32)
    impl = _jax_impl("shadow", which)
    for tm_j, tm_t in ((jnp.asarray(t_max), torch.as_tensor(t_max)), (2.5, 2.5)):
        want = np.asarray(impl(jt, jo, jd, t_max=tm_j, active=jnp.asarray(act)))
        got = tdense.dense_shadow(tt, to, td, t_max=tm_t, active=torch.as_tensor(act)).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < act.sum()
        assert not got[~act].any()


@pytest.mark.parametrize("which", ["pallas", "xla"])
@pytest.mark.parametrize("scene", ["cornell", "soup200"])
@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("live", LIVE)
def test_emissive_pdf_plain_matches_jax(live, n, scene, which, interpret):
    """Lanes whose gate is 0 give +0 in both packages."""
    import jax.numpy as jnp

    jt, tt = _tables(scene)
    jo, jd, to, td, r = _rays(4, dy=0.5, up=True, n=n)
    act = _live(np.arange(n) % 3 != 0, live, r)
    want = np.asarray(_jax_impl("emissive_pdf", which)(jt, jo, jd, t_min=1e-7,
                                                       active=jnp.asarray(act)))
    got = tdense.dense_emissive_pdf(tt, to, td, t_min=1e-7, active=torch.as_tensor(act)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert want.max() > 0 if live == 1.0 else True
    off = got[~act]
    assert (off == 0.0).all() and not np.signbit(off).any() and (want[~act] == 0.0).all()


def test_closest_tie_rule_keeps_lowest_id_and_bound():
    """Duplicate triangles hit at equal t: the lowest id wins; a hit at
    exactly the initial t bound still counts (the Pallas kernel's rule)."""
    tri = np.array([[-1, -1, 1], [1, -1, 1], [0, 1, 1]], np.float32)
    v = np.stack([tri, tri, tri + np.float32([0, 0, -1])])  # ids 0, 1 tie; 2 farther
    table = torch.as_tensor(np.concatenate(
        [v[:, 0].T, (v[:, 1] - v[:, 0]).T, (v[:, 2] - v[:, 0]).T]).copy())
    rays = tuple(torch.as_tensor(np.float32(c)).reshape(1) for c in (0, 0, 3, 0, 0, -1))
    lo = torch.tensor([1e-7], dtype=torch.float32)
    t, ids = tdense.closest_sweep_reference(table, rays, lo, torch.tensor([1e32]))
    assert ids.tolist() == [0] and t.item() == 2.0
    t, ids = tdense.closest_sweep_reference(table, rays, lo, torch.tensor([2.0]))
    assert ids.tolist() == [0] and t.item() == 2.0
    t, ids = tdense.closest_sweep_reference(table, rays, torch.tensor([2.0]),
                                            torch.tensor([1e32]))
    assert ids.tolist() == [2] and t.item() == 3.0


def test_sweeps_refuse_mixed_devices():
    table = tdense.closest_table(tbuiltin.cornell_box_scene().upload("cpu"))
    rays = tuple(torch.zeros(4) for _ in range(6))
    with pytest.raises(ValueError):
        tdense.shadow_sweep(table, rays, torch.zeros(4, device="meta"))


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("share", cs.LIVE_SHARES)
@pytest.mark.parametrize("scene", ["cornell", "soup200"])
def test_cuda_kernels_match_plain(scene, share, cuda_device):
    """At bench cfg1's wave of 524,288 rays (a whole number of 256-thread
    blocks) and at a ragged 524,251, whose last block has threads past the
    last ray, with the given share of live lanes.  Closest (t, tri) and
    occlusion bit-equal to plain; the pdf, at both t_min the render uses,
    within rtol 1e-5 / atol 1e-7 of plain on lanes whose gate is 1 and
    exactly +0 where it is 0; dead closest lanes keep t_init and -1."""
    tt = _scene(scene, "vulkan_raytracer_tpu_torch").upload(cuda_device)
    r = np.random.default_rng(21)
    table, ptable = tt.tri_table, tt.em_table
    before = dict(tdense.LAUNCHES)
    for n in (524288, 524251):
        o = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
        o[:, 1] += 1.0
        d = r.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        cols = tuple(torch.as_tensor(a.copy(), device=cuda_device) for a in (*o.T, *d.T))
        act = torch.as_tensor(cs.live_mask(n, share, seed=n), device=cuda_device)
        t_max = torch.as_tensor(r.uniform(0.0, 4.0, n).astype(np.float32), device=cuda_device)
        t_lo = torch.full((n,), 1e-7, device=cuda_device)
        t_init = torch.where(act, t_max, 0.0).contiguous()

        t_k, tri_k = tdense.closest_sweep(table, cols, t_lo, t_init)
        t_p, tri_p = tdense.closest_sweep_reference(table, cols, t_lo, t_init)
        assert torch.equal(tri_k, tri_p) and torch.equal(t_k, t_p)
        assert torch.equal(t_k[~act], t_init[~act]) and bool((tri_k[~act] == -1).all())
        occ_k = tdense.shadow_sweep(table, cols, t_init)
        assert torch.equal(occ_k, tdense.shadow_sweep_reference(table, cols, t_init))
        gate = act.float().contiguous()
        for t_min in (1e-7, 0.0):
            pdf_k = tdense.pdf_sweep(ptable, cols, gate, t_min)
            pdf_p = tdense.pdf_sweep_reference(ptable, cols, gate, t_min)
            torch.testing.assert_close(pdf_k[act], pdf_p[act], rtol=1e-5, atol=1e-7)
            off = pdf_k[~act]
            assert bool((off == 0.0).all()) and not bool(torch.signbit(off).any())
    assert {k: tdense.LAUNCHES[k] - before[k] for k in before} == {
        "closest": 2, "shadow": 2, "pdf": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("share", cs.LIVE_SHARES)
@pytest.mark.parametrize("scene", ["cornell", "soup1000"])
def test_cuda_shadow_matches_plain(scene, share, cuda_device):
    """The occlusion kernel bit-equal to its plain version at 524,288 and at
    a ragged 524,251 rays with the given share of live lanes: all-dead,
    all-live and mixed blocks (``cs.live_mask``), a block whose every ray is
    occluded by triangle 0 (the block leaves after the first chunk of the
    soup's four), and, on the sparse shares, blocks with few live rays over
    the soup's long table (a warp per ray).  Inactive lanes are never
    occluded; one launch per sweep."""
    scenes = {"cornell": tbuiltin.cornell_box_scene, "soup1000": lambda: cs.soup_scene(1000, 7)}
    tt = scenes[scene]().upload(cuda_device)
    table = tt.tri_table
    v0, e1, e2 = (table[3 * k:3 * k + 3, 0].cpu().numpy() for k in range(3))
    nrm = np.cross(e1, e2) / np.linalg.norm(np.cross(e1, e2))
    centre = v0 + (e1 + e2) / 3.0
    r = np.random.default_rng(22)
    before = tdense.LAUNCHES["shadow"]
    for n in (524288, 524251):
        o = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
        o[:, 1] += 1.0
        d = r.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        act = cs.live_mask(n, share, seed=n)
        t_max = r.uniform(0.0, 4.0, n).astype(np.float32)
        early = slice(1280, 1536)  # block 5: straight down onto triangle 0 from 0.3 away
        if share not in (0.0, "one"):
            o[early], d[early] = centre + 0.3 * nrm, -nrm
            act[early], t_max[early] = True, 1.0
        cols = tuple(torch.as_tensor(a.copy(), device=cuda_device) for a in (*o.T, *d.T))
        act = torch.as_tensor(act, device=cuda_device)
        t_hi = torch.where(act, torch.as_tensor(t_max, device=cuda_device), 0.0).contiguous()
        occ_k = tdense.shadow_sweep(table, cols, t_hi)
        occ_p = tdense.shadow_sweep_reference(table, cols, t_hi)
        assert torch.equal(occ_k, occ_p)
        assert not bool(occ_k[~act].any())
        if share not in (0.0, "one"):
            assert bool((occ_k[early] == 1).all())
        if share == 1.0:
            assert 0 < int(occ_k.sum()) < n
    assert tdense.LAUNCHES["shadow"] - before == 2
