"""The port's threaded-BVH build, streams and walks against the JAX package's.

* ``build_bvh``, ``treelet_cut`` and ``octant_permutations`` are the same
  NumPy (or native C++) code in both packages: bit-equal, with the native
  builder on both sides and with it disabled on both sides.
* The port's streams, built from the JAX ``ThreadedBVH`` carried over by
  ``tables_from_numpy``, hold the content of the JAX ``PacketBVH`` in the
  card's layout (one triangle table for the eight octant streams, padding
  slots dropped): bit-equal, octant by octant and leaf by leaf.
* The plain versions of the two walks (what the port runs on CPU tensors)
  against ``packet_closest`` / ``packet_shadow`` in Pallas interpret mode
  (K4 with a single treelet, K5 with 128-triangle treelets) and against the
  XLA dense fold: hit flags and occlusion flags equal, t within rtol 1e-5
  (atol 1e-7 near the origin),
  triangle ids equal on more than 99.9% of hits (the walks visit triangles
  in BVH order, so an exact-t tie may pick another triangle), u / v within
  atol 1e-5 (last-ulp differences of the frameworks' float32 arithmetic).
* Inside the port, the treelet walk against the whole-stream walk: t
  bit-equal, ids equal except at exact ties.
* A forced-BVH render of a small dragon against the JAX render and the NumPy
  oracle: RMSE < 2e-3, ray counts within 0.1%.

Tests marked ``cuda`` hold the CUDA kernels against their plain versions on
the card and skip without one.  jax is imported only inside the parity
tests; run the card tests with
``python -m pytest tests/test_torch_bvh.py -m cuda --noconftest``.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from vulkan_raytracer_tpu_torch.accel import bvh as tbvh
from vulkan_raytracer_tpu_torch.ops import dense as tdense
from vulkan_raytracer_tpu_torch.ops import trace as ttrace
from vulkan_raytracer_tpu_torch.ops import traverse as ttr
from vulkan_raytracer_tpu_torch.ops.math3 import V3 as TV3
from vulkan_raytracer_tpu_torch.scene import procedural as tproc
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg

N = 1024
RMSE_BAR = 2e-3


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


def _soup(n_tris, seed, spread=1.0):
    """(v0, v1, v2) of a random soup in a [-spread, spread]^3 box."""
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    offs = r.normal(0, 0.15 * spread, (n_tris, 2, 3)).astype(np.float32)
    return base, base + offs[:, 0], base + offs[:, 1]


def _soup_scene(pkg, n_tris, seed):
    """The soup as a scene of package ``pkg`` (the JAX one or the port)."""
    sg = importlib.import_module(f"{pkg}.scene.scenegraph")
    v0, v1, v2 = _soup(n_tris, seed)
    pos = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)
    nrm = np.cross(v1 - v0, v2 - v0)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
    s = sg.Scene()
    s.add_raw_mesh(pos, np.repeat(nrm, 3, axis=0).astype(np.float32),
                   np.arange(3 * n_tris, dtype=np.uint32), sg.Material())
    return s


def _small_dragon_tris():
    t = tproc.dragon_scene(detail=12).upload("cpu")
    return tuple(np.stack([c.numpy() for c in v], 1) for v in (t.v0, t.v1, t.v2))


def _bvh_arrays(bvh):
    """The port ThreadedBVH's array fields as numpy arrays."""
    return {f.name: getattr(bvh, f.name).numpy()
            for f in dataclasses.fields(bvh) if f.name != "leaf_size"}


def _no_native(monkeypatch):
    import vulkan_raytracer_tpu.accel.native as jnative

    from vulkan_raytracer_tpu_torch.accel import native as tnative

    monkeypatch.setattr(jnative, "bvh_build_native", lambda *a: None)
    monkeypatch.setattr(tnative, "bvh_build_native", lambda *a: None)


# ---------------------------------------------------------------------------
# (a) the build, the treelet cut and the octant orders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("geometry", ["soup3000", "dragon"])
def test_build_bvh_bit_equal_to_jax(geometry, builder, monkeypatch):
    from vulkan_raytracer_tpu.accel import bvh as jbvh

    if builder == "numpy":
        _no_native(monkeypatch)
    tris = _soup(3000, seed=13, spread=5.0) if geometry == "soup3000" else _small_dragon_tris()
    want = jbvh.build_bvh(*tris)
    got = tbvh.build_bvh(*tris)
    assert got.leaf_size == want.leaf_size and got.num_nodes == want.num_nodes > 100
    for name, arr in _bvh_arrays(got).items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(want, name)), err_msg=name)
    first, miss = got.first_tri.numpy(), got.miss.numpy()
    for max_tris in (128, 2048):
        np.testing.assert_array_equal(
            tbvh.treelet_cut(first, miss, got.leaf_size, max_tris),
            jbvh.treelet_cut(first, miss, got.leaf_size, max_tris))
    args = (got.aabb_min.numpy(), got.aabb_max.numpy(), first, miss)
    np.testing.assert_array_equal(tbvh.octant_permutations(*args),
                                  jbvh.octant_permutations(*args))


def test_native_builder_builds_into_the_package():
    """The port compiles native/accel_build.cpp into its own build directory
    and never writes beside the source."""
    from vulkan_raytracer_tpu_torch.accel import native as tnative

    if tnative.get_lib() is None:
        pytest.skip("no g++ here: the NumPy builder runs (covered above)")
    assert tnative._library_path().parent == tnative.BUILD_DIR
    assert tnative._library_path().exists()


# ---------------------------------------------------------------------------
# (b) the streams
# ---------------------------------------------------------------------------


def _jax_and_port(monkeypatch, max_tris, n_tris=3000):
    """(JAX tables, port tables on CPU) of an ``n_tris``-triangle soup; JAX
    builds its PacketBVH at ``VKRT_TREELET_TRIS`` = max_tris, the port its
    streams at max_tris."""
    import jax

    from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

    monkeypatch.setenv("VKRT_TREELET_TRIS", str(max_tris))
    jt = _soup_scene("vulkan_raytracer_tpu", n_tris, seed=3).upload()
    tt = tables_from_numpy(jax.tree_util.tree_map(np.asarray, jt), "cpu", traversal="bvh",
                           max_tris=max_tris)
    return jt, tt


def _words(s):
    """(8, Nn, 2) int32 ``leaf`` and ``link`` words of the node records."""
    return s.nodes.view(torch.int32)[..., 3::4].numpy()


@pytest.mark.parametrize("max_tris", [128, 2048])
def test_streams_match_jax_packet_bvh(max_tris, monkeypatch):
    jt, tt = _jax_and_port(monkeypatch, max_tris)
    pb, s = jt.pbvh, tt.pbvh
    n, k = s.num_nodes, pb.leaf_size
    assert (n, s.n_treelets) == (pb.num_nodes, pb.n_treelets)
    assert s.n_treelets > (4 if max_tris == 128 else 0)
    # per-octant node order and boxes
    jf = np.asarray(pb.nodes_f).reshape(8, 6, -1)[:, :, :n].transpose(0, 2, 1)
    np.testing.assert_array_equal(s.nodes[..., 0:3].numpy(), jf[..., 0:3])
    np.testing.assert_array_equal(s.nodes[..., 4:7].numpy(), jf[..., 3:6])
    j_leaf, j_miss = np.asarray(pb.nodes_i).reshape(8, 2, -1)[:, :, :n].transpose(1, 0, 2)
    leaf, link = _words(s)[..., 0], _words(s)[..., 1]
    is_leaf = j_leaf >= 0
    np.testing.assert_array_equal(leaf >= 0, is_leaf)
    # skip pointers: an interior node's link; a leaf's is always the next node
    np.testing.assert_array_equal(link[~is_leaf], j_miss[~is_leaf])
    np.testing.assert_array_equal(j_miss[is_leaf], np.nonzero(is_leaf)[1] + 1)
    # each octant's leaf sequence, mapped through the shared table
    j_tris = np.asarray(pb.leaves)
    j_ids = np.asarray(pb.tri_id)
    tris, ids = s.tris.numpy(), s.tri_id.numpy()
    assert ids.shape[0] == (ids >= 0).sum() == int((np.asarray(jt.bvh.tri_id) >= 0).sum())
    for o in range(8):
        for node in np.nonzero(is_leaf[o])[0]:
            lj = j_leaf[o, node]
            real = j_ids[o, lj * k:(lj + 1) * k] >= 0
            rows = slice(leaf[o, node], leaf[o, node] + link[o, node])
            assert link[o, node] == real.sum()
            np.testing.assert_array_equal(ids[rows], j_ids[o, lj * k:(lj + 1) * k][real])
            want = j_tris[o, :, lj].reshape(k, 9)[real]
            np.testing.assert_array_equal(tris[rows][:, [0, 1, 2, 4, 5, 6, 8, 9, 10]], want)
    assert not tris[:, 3::4].any()
    np.testing.assert_array_equal(s.tl_box.numpy(), np.asarray(pb.tl_box))
    np.testing.assert_array_equal(s.tl_lim.numpy(), np.asarray(pb.tl_lim))
    # each group box is the union of its treelets' boxes
    for g, box in enumerate(s.tl_group.numpy()):
        tl = s.tl_box.numpy()[g * ttr.TREELET_GROUP:(g + 1) * ttr.TREELET_GROUP]
        np.testing.assert_array_equal(box, np.concatenate([tl[:, :3].min(0), tl[:, 3:].max(0)]))
    # the BVH itself came across bit for bit
    for name, arr in _bvh_arrays(tt.bvh).items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jt.bvh, name)), err_msg=name)


def test_dragon_streams_fit_half_the_l2():
    """The full cfg2 dragon's streams take at most 25 MB (the parent layout's
    per-octant triangle copies took 93 MB); padding slots are not stored."""
    tables = tproc.dragon_scene().upload("cpu")
    s = tables.pbvh
    assert tables.num_triangles == 262280 and s.tris.shape[0] == 262280
    assert s.nbytes <= 25e6
    assert s.nbytes == sum(getattr(s, f).nbytes for f in
                           ("nodes", "tris", "tri_id", "tl_box", "tl_group", "tl_lim"))


def test_streams_guard_treelet_cap():
    tris = _soup(3000, seed=1)
    b = tbvh.build_bvh(*tris)
    s = ttr.build_streams(b, max_tris=16, max_treelets=8)
    assert s.n_treelets <= 8
    with pytest.raises(ValueError, match="at most"):
        ttr.build_streams(b, max_treelets=ttr.MAX_TREELETS + 1)


# ---------------------------------------------------------------------------
# (c), (d) the walks' plain versions against the JAX kernels and dense fold
# ---------------------------------------------------------------------------


def _rays(seed, n=N):
    """Rays through the soup box, a few with +-0.0 direction components (the
    octant bit counts -0.0 as positive), per-lane t_min, inactive lanes and
    per-lane shadow bounds; for both packages."""
    import jax.numpy as jnp
    from vulkan_raytracer_tpu.ops.math3 import V3 as JV3

    r = np.random.default_rng(seed)
    o = r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::17, 1] = -0.0
    d[5::23, 0] = 0.0
    t_min = np.where(np.arange(n) % 3 == 0, r.uniform(0.0, 0.5, n), 1e-7).astype(np.float32)
    t_max = r.uniform(0.05, 3.0, n).astype(np.float32)
    active = np.arange(n) % 5 != 0
    jax_in = (JV3(*(jnp.asarray(o[:, k]) for k in range(3))),
              JV3(*(jnp.asarray(d[:, k]) for k in range(3))))
    port_in = (TV3(*(torch.as_tensor(o[:, k].copy()) for k in range(3))),
               TV3(*(torch.as_tensor(d[:, k].copy()) for k in range(3))))
    return jax_in, port_in, t_min, t_max, active


def _jax_impl(kind, which):
    if which == "pallas":
        return getattr(importlib.import_module("vulkan_raytracer_tpu.ops.pallas_bvh"),
                       f"packet_{kind}")
    return getattr(importlib.import_module("vulkan_raytracer_tpu.ops.dense"), f"dense_{kind}")


def _check_walks_match_jax(jt, tt, which, seed, min_hits=N // 4):
    import jax.numpy as jnp

    (jo, jd), (to, td), t_min, t_max, active = _rays(seed)
    want = _jax_impl("closest", which)(jt, jo, jd, t_min=jnp.asarray(t_min), t_max=1e32,
                                       active=jnp.asarray(active))
    got = ttr.bvh_closest(tt, to, td, t_min=torch.as_tensor(t_min), t_max=1e32,
                          active=torch.as_tensor(active))
    tri_w, tri_g = np.asarray(want[1]), got[1].numpy()
    np.testing.assert_array_equal(tri_g >= 0, tri_w >= 0)
    hit = tri_w >= 0
    assert hit.sum() > min_hits
    # rtol 1e-5; atol 1e-7 for hits a few 1e-5 from the origin, where the
    # frameworks' last-ulp differences cancel into a larger relative error
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit], rtol=1e-5,
                               atol=1e-7)
    assert np.isinf(got[0].numpy()[~hit]).all()
    same = tri_g == tri_w
    assert same[hit].mean() > 0.999
    for k in (2, 3):  # u, v
        np.testing.assert_allclose(got[k].numpy()[hit & same], np.asarray(want[k])[hit & same],
                                   atol=1e-5)

    occ_w = np.asarray(_jax_impl("shadow", which)(jt, jo, jd, t_max=jnp.asarray(t_max),
                                                  active=jnp.asarray(active)))
    occ_g = ttr.bvh_shadow(tt, to, td, t_max=torch.as_tensor(t_max),
                           active=torch.as_tensor(active)).numpy()
    np.testing.assert_array_equal(occ_g, occ_w)
    assert 0 < occ_w.sum() < active.sum() and not occ_g[~active].any()

    # an all-dead wave finds nothing
    none = torch.zeros(N, dtype=torch.bool)
    t0, tri0, _, _ = ttr.bvh_closest(tt, to, td, t_min=0.0, t_max=1e32, active=none)
    assert (tri0 == -1).all() and torch.isinf(t0).all()
    assert not ttr.bvh_shadow(tt, to, td, t_max=1e32, active=none).any()


@pytest.mark.parametrize("which", ["pallas", "xla"])
def test_whole_stream_walk_matches_jax(which, interpret, monkeypatch):
    """K4' plain (a single treelet) against JAX K4 and the dense fold."""
    jt, tt = _jax_and_port(monkeypatch, 1 << 20)
    assert jt.pbvh.n_treelets == tt.pbvh.n_treelets == 1
    _check_walks_match_jax(jt, tt, which, seed=0)


@pytest.mark.parametrize("which", ["pallas", "xla"])
def test_treelet_walk_matches_jax(which, interpret, monkeypatch):
    """K5' plain (128-triangle treelets) against JAX's windowed K5 and the
    dense fold."""
    jt, tt = _jax_and_port(monkeypatch, 128)
    assert jt.pbvh.n_treelets == tt.pbvh.n_treelets > 4
    _check_walks_match_jax(jt, tt, which, seed=1)


@pytest.mark.parametrize("walk", ["whole_stream", "treelet"])
def test_half_filled_leaves_match_jax(walk, interpret, monkeypatch):
    """1,152 triangles make 128 leaves of 9 real triangles in 16 slots (44%
    padding, as in the 147k glTF): the plain walks skip the padding and still
    give JAX K4 / K5's t and triangles (interpret mode) and the dense fold's."""
    jt, tt = _jax_and_port(monkeypatch, 1 << 20 if walk == "whole_stream" else 128, 9 * 128)
    ids = np.asarray(jt.bvh.tri_id)
    assert (ids < 0).mean() > 0.4 and tt.pbvh.tris.shape[0] == 9 * 128
    assert (tt.pbvh.n_treelets == 1) == (walk == "whole_stream")
    _check_walks_match_jax(jt, tt, "pallas", seed=2, min_hits=N // 8)
    _check_walks_match_jax(jt, tt, "xla", seed=2, min_hits=N // 8)
    # no padding slot is tested: at most 9 triangle tests per leaf entered
    rays, active, t_lo, _ = _port_rays(N, seed=4)
    v = ttr.walk_visits(tt.pbvh, rays, t_lo, torch.where(active, 1e32, -1.0), False,
                        walk == "treelet")
    assert int(v["leaves"].sum()) > 0 and int(v["tris"].sum()) == 9 * int(v["leaves"].sum())


def test_walk_visits_counts_by_hand():
    """Two one-triangle leaves, z = 1 (A) and z = -1 (B), under one root; a
    ray down the z axis from z = 3 and one that misses both."""
    a = np.float32([[-1, -1, 1], [1, -1, 1], [0, 1, 1]])
    b = a - np.float32([0, 0, 2])
    v0, v1, v2 = (np.stack([a[i], b[i]]) for i in range(3))
    bvh = tbvh.build_bvh(v0, v1, v2, leaf_size=1)
    assert bvh.num_nodes == 3
    whole = ttr.build_streams(bvh, max_tris=1 << 20)
    split = ttr.build_streams(bvh, max_tris=1)
    assert (whole.n_treelets, split.n_treelets) == (1, 2)
    rays = tuple(torch.tensor(c, dtype=torch.float32)
                 for c in ([0, 5], [0, 5], [3, 3], [0, 0], [0, 0], [-1, -1]))
    lo, hi = torch.full((2,), 1e-7), torch.full((2,), 10.0)

    def counts(s, shadow, treelets):
        v = ttr.walk_visits(s, rays, lo, hi, shadow, treelets)
        return {k: v[k].tolist() for k in ("nodes", "leaves", "tris", "boxes")}

    # closest, whole stream: the root, A (hit at t = 2), B missed (entry 4 > 2)
    assert counts(whole, False, False) == {
        "nodes": [3, 1], "leaves": [1, 0], "tris": [1, 0], "boxes": [0, 0]}
    # shadow, whole stream: the root, then A occludes and ends the walk
    assert counts(whole, True, False) == {
        "nodes": [2, 1], "leaves": [1, 0], "tris": [1, 0], "boxes": [0, 0]}
    # treelets: one group box, then its two treelet boxes for the ray that
    # enters it; A's treelet (entry 2) hits, B's (entry 4) is never walked
    assert counts(split, False, True) == {
        "nodes": [1, 0], "leaves": [1, 0], "tris": [1, 0], "boxes": [3, 1]}
    v = ttr.walk_visits(whole, rays, lo, hi, False, False)
    assert (v["node_rows"], v["tri_rows"]) == (3, 1)


def test_upload_defaults_to_the_card():
    """``Scene.upload()`` and ``tables_from_numpy`` put the tables on the
    card unless asked for the CPU; without a card they raise."""
    import jax

    from vulkan_raytracer_tpu.scene import builtin as jbuiltin

    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene
    from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

    jt = jax.tree_util.tree_map(np.asarray, jbuiltin.cornell_box_scene().upload())
    if torch.cuda.is_available():
        assert cornell_box_scene().upload().v0.x.is_cuda
        assert tables_from_numpy(jt).v0.x.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            cornell_box_scene().upload()
        with pytest.raises(RuntimeError, match="CUDA"):
            tables_from_numpy(jt)
    assert cornell_box_scene().upload("cpu").v0.x.device.type == "cpu"


def _port_rays(n, seed, device="cpu"):
    """Ray columns, active lanes, per-lane t_min and shadow bounds."""
    r = np.random.default_rng(seed)
    o = r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    t_lo = np.where(r.random(n) < 0.3, r.uniform(0, 0.5, n), 1e-7).astype(np.float32)
    return (tuple(col(c) for c in (*o.T, *d.T)), col(r.random(n) < 0.8), col(t_lo),
            col(r.uniform(0.05, 3.0, n).astype(np.float32)))


def test_treelet_walk_matches_whole_stream_walk():
    """Inside the port: t bit-equal, triangle ids equal except at exact ties,
    occlusion equal; a bound at exactly the hit t still finds the hit."""
    s = ttr.build_streams(tbvh.build_bvh(*_soup(3000, seed=3)), max_tris=128)
    assert s.n_treelets > 4
    rays, active, t_lo, t_hi = _port_rays(4096, seed=5)
    t_init = torch.where(active, 1e32, -1.0)
    t4, slot4 = ttr.bvh_walk_reference(s, rays, t_lo, t_init, False)
    t5, slot5 = ttr.treelet_walk_reference(s, rays, t_lo, t_init, False)
    tri4, f4 = ttrace.slot_to_tri(s, slot4)
    tri5, f5 = ttrace.slot_to_tri(s, slot5)
    assert torch.equal(f4, f5) and int(f4.sum()) > 1000
    assert torch.equal(t4, t5)
    assert float((tri4 == tri5)[f4].float().mean()) > 0.999

    t_tie = torch.where(f4, t4, t_init)
    for fn in (ttr.bvh_walk_reference, ttr.treelet_walk_reference):
        t_b, slot_b = fn(s, rays, t_lo, t_tie, False)
        assert torch.equal(ttrace.slot_to_tri(s, slot_b)[1], f4)
        assert torch.equal(t_b[f4], t4[f4])

    t_sh = torch.where(active, t_hi, -1.0)
    zeros = torch.zeros_like(t_hi)
    _, o4 = ttr.bvh_walk_reference(s, rays, zeros, t_sh, True)
    t5s, o5 = ttr.treelet_walk_reference(s, rays, zeros, t_sh, True)
    assert torch.equal(o4 >= 0, o5 >= 0) and 0 < int((o5 >= 0).sum()) < int(active.sum())
    assert (t5s[o5 >= 0] == -1.0).all()


def test_walk_tie_rule_first_visited_wins():
    """Two copies of one triangle tie at equal t: the slot visited first wins
    and a hit at exactly the initial bound counts."""
    tri = np.array([[-1, -1, 1], [1, -1, 1], [0, 1, 1]], np.float32)
    v0 = np.stack([tri[0], tri[0], tri[0] + np.float32([0, 0, -1])])
    v1 = np.stack([tri[1], tri[1], tri[1] + np.float32([0, 0, -1])])
    v2 = np.stack([tri[2], tri[2], tri[2] + np.float32([0, 0, -1])])
    s = ttr.build_streams(tbvh.build_bvh(v0, v1, v2))
    rays = tuple(torch.tensor([c], dtype=torch.float32) for c in (0, 0, 3, 0, 0, -1))
    lo = torch.tensor([1e-7])
    # the triangles in the order the ray's octant stream visits its leaves
    leaf, link = _words(s)[int(ttr.octant(rays)[0])].T
    visit_order = [int(s.tri_id[r]) for node in np.nonzero(leaf >= 0)[0]
                   for r in range(leaf[node], leaf[node] + link[node])]
    first = next(i for i in visit_order if i in (0, 1))
    for t_init in (1e32, 2.0):
        t, slot = ttr.bvh_walk_reference(s, rays, lo, torch.tensor([t_init]), False)
        tri_id, found = ttrace.slot_to_tri(s, slot)
        assert bool(found) and t.item() == 2.0 and tri_id.item() == first
    t, slot = ttr.bvh_walk_reference(s, rays, torch.tensor([2.0]), torch.tensor([1e32]), False)
    assert ttrace.slot_to_tri(s, slot)[0].item() == 2 and t.item() == 3.0


def test_walks_refuse_mixed_devices():
    s = ttr.build_streams(tbvh.build_bvh(*_soup(100, seed=2)))
    rays = tuple(torch.zeros(4) for _ in range(6))
    with pytest.raises(ValueError):
        ttr.bvh_walk(s, rays, torch.zeros(4), torch.zeros(4, device="meta"), False)


# ---------------------------------------------------------------------------
# The upload rule and (e) a forced-BVH render
# ---------------------------------------------------------------------------


def test_upload_builds_bvh_only_when_asked_or_large():
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    s = cornell_box_scene()
    assert s.upload("cpu").pbvh is None
    tt = s.upload("cpu", traversal="bvh")
    assert tt.pbvh.n_treelets == 1 and tt.bvh.num_nodes > 1
    assert {"bvh_seconds", "streams_seconds", "copy_seconds", "bvh_builder"} <= set(s.upload_stats)
    with pytest.raises(ValueError):
        s.upload("cpu", traversal="grid")
    moved = tt.to("cpu")
    assert isinstance(moved.pbvh, ttr.BVHStreams) and moved.pbvh.num_nodes == tt.pbvh.num_nodes


W = H = 32
SPP, DEPTH = 2, 3


def _cfg2_cam(cls):
    return cls(position=np.array([0.0, 2.2, 4.5]), direction=np.array([0.0, -0.25, -1.0]))


def test_forced_bvh_render_matches_jax_and_oracle():
    """A 712-triangle dragon through the BVH path (one treelet: the
    whole-stream walk) against the JAX render of the same scene and the
    NumPy oracle: RMSE < 2e-3 (measured ~1e-7), rays within 0.1%."""
    from vulkan_raytracer_tpu.render import oracle
    from vulkan_raytracer_tpu.render.renderer import render_image as jrender_image
    from vulkan_raytracer_tpu.scene import procedural as jproc
    from vulkan_raytracer_tpu.scene.camera import Camera as JCamera

    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    tt = tproc.dragon_scene(detail=12).upload("cpu", traversal="bvh")
    assert tt.pbvh is not None and tt.pbvh.n_treelets == 1
    img_t, rays_t = render_image(tt, _cfg2_cam(Camera), W, H, spp=SPP, max_depth=DEPTH,
                                 tonemap=False)
    jt = jproc.dragon_scene(detail=12).upload()
    img_j, rays_j = jrender_image(jt, _cfg2_cam(JCamera), W, H, spp=SPP, max_depth=DEPTH,
                                  tonemap=False)
    img_o = oracle.render_image(tt.to("cpu"), _cfg2_cam(Camera), W, H, spp=SPP,
                                max_depth=DEPTH)
    for ref, name in ((img_j, "JAX"), (img_o, "oracle")):
        rmse = float(np.sqrt(np.mean((img_t - np.asarray(ref)) ** 2)))
        assert rmse < RMSE_BAR, f"port vs {name} RMSE {rmse}"
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)
    assert img_t.mean() > 1e-3


def test_scene_above_dense_cap_is_not_refused():
    """A scene above DENSE_MAX_TRIS renders (the BVH path), where the port
    used to raise NotImplementedError."""
    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    s = _soup_scene("vulkan_raytracer_tpu_torch", tdense.DENSE_MAX_TRIS + 1, seed=4)
    m = tsg.Material()
    m.emissive_factor = np.full(3, 5.0, np.float32)
    s.add_raw_mesh(np.float32([[-3, 3, -3], [3, 3, -3], [3, 3, 3], [-3, 3, 3]]),
                   np.float32([[0, -1, 0]] * 4), np.uint32([0, 2, 1, 0, 3, 2]), m)
    tt = s.upload("cpu")
    assert tt.pbvh is not None and tt.pbvh.n_treelets > 1
    img, rays = render_image(tt, Camera(position=np.array([0.0, 0.0, 4.0]),
                                        direction=np.array([0.0, 0.0, -1.0])),
                             8, 8, spp=1, max_depth=2, tonemap=False)
    assert np.isfinite(img).all() and rays > 64


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("max_tris", [1 << 20, 128])
def test_cuda_walks_match_plain(max_tris, cuda_device):
    """K4' and K5' (closest and shadow) bit-equal to their plain versions, at
    a whole number of 128-thread blocks and at a ragged count, with per-lane
    bounds, bounds at exactly the hit t and inactive lanes."""
    s = ttr.build_streams(tbvh.build_bvh(*_soup(20000, seed=8)), max_tris=max_tris)
    s = s.to(cuda_device)
    before = dict(ttr.LAUNCHES)
    for n in (1 << 15, (1 << 15) - 37):
        rays, active, t_lo, t_hi = _port_rays(n, seed=n, device=cuda_device)
        t_init = torch.where(active, 1e32, -1.0).contiguous()
        t_sh = torch.where(active, t_hi, -1.0).contiguous()
        zeros = torch.zeros_like(t_hi)
        for walk, ref in ((ttr.bvh_walk, ttr.bvh_walk_reference),
                          (ttr.treelet_walk, ttr.treelet_walk_reference)):
            tk, sk = walk(s, rays, t_lo, t_init, False)
            tp, sp = ref(s, rays, t_lo, t_init, False)
            assert torch.equal(tk, tp) and torch.equal(sk, sp)
            t_tie = torch.where(sp >= 0, tp, t_init).contiguous()
            tk2, sk2 = walk(s, rays, t_lo, t_tie, False)
            assert torch.equal(tk2, tp) and torch.equal(sk2 >= 0, sp >= 0)
            ok, osk = walk(s, rays, zeros, t_sh, True)
            op, osp = ref(s, rays, zeros, t_sh, True)
            assert torch.equal(ok, op) and torch.equal(osk, osp)
    got = {k: ttr.LAUNCHES[k] - before[k] for k in before}
    assert got == {"bvh_closest": 4, "bvh_shadow": 2, "treelet_closest": 4, "treelet_shadow": 2,
                   "emissive_pdf": 0}
