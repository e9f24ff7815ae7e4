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
sum (ROADMAP.md Queue 3).  The CUDA kernel walks the wide nodes of
``EmissiveStream.wide``; it is built with ``--fmad=false`` like every kernel
of the library, its divides and square root are IEEE (``-prec-div``,
``-prec-sqrt``), it enters the leaves the binary walk enters in the same
order and adds their terms in the same order, so it is held to bit-equality
with the plain version on the card (``torch.equal`` on active lanes).  A
plain walk of the wide layout here (:func:`_wide_walk`) shows on the CPU
that the layout enters the same leaves in the same order.  Inactive lanes
are exactly +0 everywhere.
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
    assert counts == 5 and s.nbytes == s.nodes.nbytes + s.rows.nbytes + s.wide.nbytes
    # a ray down through triangle 3 adds that triangle's term only
    rays = tuple(torch.tensor([c], dtype=torch.float32) for c in (6.25, 0.25, 1.0, 0.0, 0.0, -1.0))
    pdf = ttr.emissive_pdf_walk(s, rays, torch.ones(1, dtype=torch.bool), EPS)
    n_hat_d = 1.0 / np.sqrt(3.0)
    assert pdf.item() == pytest.approx(3.0 * 1.0 / (0.5 * n_hat_d), rel=1e-6)
    v = ttr.emissive_walk_visits(s, rays, torch.ones(1, dtype=torch.bool), EPS)
    assert int(v["hits"].sum()) == 1 and int(v["nodes"].sum()) >= 2 and v["tri_rows"] >= 1


def test_wide_records_by_hand():
    """A binary tree written by hand: root -> (leaf 1, B), B a full tree of
    eight leaves three levels down.  Nine leaves need two wide nodes; among
    the frontiers that make two, the root takes the most children (eight)
    and splits each frontier as early as it can, so B's first quarter, node
    4, roots the second wide node.  Children keep the binary preorder, wide
    nodes are breadth first."""
    #            0  1   2   3  4  5  6  7  8  9  10  11  12  13  14  15  16
    first = np.array([-1, 0, -1, -1, -1, 4, 8, -1, 12, 16, -1, -1, 20, 24, -1, 28, 32])
    miss = np.array([17, 2, 17, 10, 7, 6, 7, 10, 9, 10, 17, 14, 13, 14, 17, 16, 17])
    leaves = first >= 0
    count = np.where(leaves, [0, 3, 0, 0, 0, 4, 1, 0, 2, 4, 0, 0, 3, 4, 0, 1, 2], 0)
    row0 = np.where(leaves, np.cumsum(count) - count, -1)
    kids, ref, kind, stack = ttr.wide_layout(first, miss, row0, count)
    assert kids.tolist() == [[1, 4, 8, 9, 12, 13, 15, 16], [5, 6, -1, -1, -1, -1, -1, -1]]
    assert kind.tolist() == [[3, -1, 2, 4, 3, 4, 1, 2], [4, 1, 0, 0, 0, 0, 0, 0]]
    assert ref.tolist() == [[0, 1, 8, 10, 14, 17, 21, 22], [3, 7, 0, 0, 0, 0, 0, 0]]
    assert stack == 8  # the root's eight children, or node 4's two above the root's last six
    # the packed record: the two leaves of the five triangles in a row
    x = np.arange(5, dtype=np.float32)[:, None] * np.float32([2, 0, 0])
    from vulkan_raytracer_tpu_torch.accel.bvh import build_bvh

    bvh = build_bvh(x, x + np.float32([1, 0, 0]), x + np.float32([0, 1, 0]), leaf_size=4)
    em = tsg.EmissivePDFTables(
        p_delta=torch.ones(5), area=torch.ones(5), n0=torch.ones(5, 3), n1=torch.ones(5, 3),
        n2=torch.ones(5, 3))
    s = ttr.build_emissive_stream(bvh, em)
    assert s.wide.shape == (1, 64) and s.stack == 2
    child = s.wide.view(1, 8, 8)
    words = child.view(torch.int32)
    first, miss = bvh.first_tri.numpy(), bvh.miss.numpy()
    for j, node in enumerate((1, int(miss[1]))):  # the root's two leaves
        assert first[node] >= 0
        np.testing.assert_array_equal(child[0, j, 0:3].numpy(), bvh.aabb_min[node].numpy())
        np.testing.assert_array_equal(child[0, j, 4:7].numpy(), bvh.aabb_max[node].numpy())
        assert (int(words[0, j, 3]), int(words[0, j, 7])) == tuple(
            s.nodes.view(torch.int32)[node, [3, 7]].tolist())
    assert int(words[0, 0, 7]) + int(words[0, 1, 7]) == 5
    assert not child[0, 2:].any()  # empty children: kind 0


def _wide_tree(s):
    """(min, max, ref, kind) of ``s.wide``, (Nw, W, ...) numpy arrays."""
    w = s.wide.numpy().reshape(-1, ttr.EMISSIVE_WIDE, 8)
    return w[..., 0:3], w[..., 4:7], w.view(np.int32)[..., 3], w.view(np.int32)[..., 7]


def _contained(s, bvh):
    """Every binary interior node's box (``bvh``: ``s``'s tree) holds its
    children's, and every interior child of a wide node holds the children
    of the wide node it refers to; consecutive leaf children have contiguous
    rows."""
    lo, hi = bvh.aabb_min.numpy(), bvh.aabb_max.numpy()
    miss = bvh.miss.numpy()
    inner = np.flatnonzero(bvh.first_tri.numpy() < 0)
    for kids in (inner + 1, miss[inner + 1]):
        assert (lo[inner] <= lo[kids]).all() and (hi[inner] >= hi[kids]).all()
    bmin, bmax, ref, kind = _wide_tree(s)
    w, j = np.nonzero(kind < 0)
    some = kind[ref[w, j]] != 0
    assert (bmin[w, j][:, None] <= bmin[ref[w, j]])[some].all()
    assert (bmax[w, j][:, None] >= bmax[ref[w, j]])[some].all()
    leaf = kind > 0
    pair = leaf[:, :-1] & leaf[:, 1:]
    assert (ref[:, 1:][pair] == (ref[:, :-1] + kind[:, :-1])[pair]).all()


def _refit(tables, seed):
    """The tables' emissive BVH refitted to its triangles, each vertex moved
    by up to 0.05 (seeded): a deformation, not a rigid move."""
    from vulkan_raytracer_tpu_torch.accel.bvh import refit_bvh

    e = tables.ebvh
    ids = e.tri_id.numpy()
    real = ids >= 0
    v0 = np.zeros((int(real.sum()), 3), np.float32)
    v1, v2 = v0.copy(), v0.copy()
    v0[ids[real]] = e.tri_v0.numpy()[real]
    v1[ids[real]] = v0[ids[real]] + e.tri_e1.numpy()[real]
    v2[ids[real]] = v0[ids[real]] + e.tri_e2.numpy()[real]
    r = np.random.default_rng(seed)
    move = [r.uniform(-0.05, 0.05, v0.shape).astype(np.float32) for _ in range(3)]
    return refit_bvh(e, v0 + move[0], v1 + move[1], v2 + move[2])


def test_wide_boxes_contain_their_children():
    """The 2,000-triangle soup's emissive tree and its refit: every box
    holds its children's, in the binary tree and in the wide layout."""
    _, tt = _tables(0, 2000)
    _contained(tt.em_stream, tt.ebvh)
    refit = _refit(tt, 3)
    _contained(ttr.build_emissive_stream(refit, tt.em_tables), refit)


def test_refit_layout_equals_the_layout_built_from_its_boxes():
    """A refitted tree's stream has its parent's wide topology (the same
    shapes, refs, kinds and stack: a captured program replays it), and its
    boxes are the refitted binary nodes' boxes at the same children."""
    _, tt = _tables(0, 2000)
    s0 = tt.em_stream
    refit = _refit(tt, 4)
    s1 = ttr.build_emissive_stream(refit, tt.em_tables)
    assert s1.wide.shape == s0.wide.shape
    assert s1.rows.shape == s0.rows.shape and s1.nodes.shape == s0.nodes.shape
    w0, w1 = s0.wide.view(torch.int32), s1.wide.view(torch.int32)
    assert torch.equal(w0[:, 3::4], w1[:, 3::4]) and s1.stack == s0.stack  # refs and kinds
    e = tt.ebvh
    kids, _, _, _ = ttr.wide_layout(e.first_tri.numpy(), e.miss.numpy(),
                                    s0.nodes.view(torch.int32)[:, 3].numpy(),
                                    np.where(e.first_tri.numpy() >= 0,
                                             s0.nodes.view(torch.int32)[:, 7].numpy(), 0))
    some = kids >= 0
    bmin, bmax, _, _ = _wide_tree(s1)
    np.testing.assert_array_equal(bmin[some], refit.aabb_min.numpy()[kids[some]])
    np.testing.assert_array_equal(bmax[some], refit.aabb_max.numpy()[kids[some]])
    assert not bmin[~some].any() and not bmax[~some].any()
    assert not torch.equal(s0.wide, s1.wide)


def _wide_walk(s, rays, active, t_min):
    """Plain walk of the wide layout (a test helper): each active ray, one
    at a time, tests the children of each wide node it reaches in order with
    the plain walk's slab arithmetic and goes down an entered interior child
    before the next child.  Returns ({lane: [(first row, count) of each leaf
    entered, in order]}, the pdf summed leaf by leaf in that order with
    ``emissive_leaf_sums``)."""
    from vulkan_raytracer_tpu_torch.ops.math3 import safe_inv_dir

    bmin, bmax, ref, kind = _wide_tree(s)
    o = np.stack([c.numpy() for c in rays[:3]], 1)
    inv = np.stack([safe_inv_dir(c).numpy() for c in rays[3:]], 1)
    t_lo, t_hi = np.float32(t_min), np.float32(1e32)
    orders = {}

    def visit(lane, node, order):
        lo = (bmin[node] - o[lane]) * inv[lane]
        hi = (bmax[node] - o[lane]) * inv[lane]
        near = np.minimum(lo, hi).max(1)
        far = np.maximum(lo, hi).min(1)
        enter = (kind[node] != 0) & (near <= far) & (far >= t_lo) & (near <= t_hi)
        for c in np.flatnonzero(enter).tolist():
            if kind[node, c] < 0:
                visit(lane, int(ref[node, c]), order)
            else:
                order.append((int(ref[node, c]), int(kind[node, c])))

    for lane in np.flatnonzero(active.numpy()).tolist():
        orders[lane] = []
        visit(lane, 0, orders[lane])
    pdf = torch.zeros(active.shape[0])
    for p in range(max((len(v) for v in orders.values()), default=0)):
        lanes = [k for k, v in orders.items() if len(v) > p]
        at = torch.tensor(lanes)
        row0 = torch.tensor([orders[k][p][0] for k in lanes])
        count = torch.tensor([orders[k][p][1] for k in lanes])
        leaf_sum = ttr.emissive_leaf_sums(s, [c[at] for c in rays], row0, count, t_min)[0]
        pdf[at] = pdf[at] + leaf_sum
    return orders, pdf


@pytest.mark.parametrize("t_min", [EPS, 0.0])
def test_wide_walk_enters_the_binary_walks_leaves(t_min):
    """On the 2,000-triangle soup, 400 rays inside it (20% inactive): a
    plain walk of the wide layout enters the leaves the binary plain walk
    enters, in the same order, and its sum is bit-equal to the binary
    walk's, at both t_min."""
    _, tt = _tables(0, 2000)
    s = tt.em_stream
    o, d, r = _unit_rays(400, 23, 0.9)
    o[:, 1] += 1.0
    rays = _cols(o) + _cols(d)
    active = torch.as_tensor(r.random(400) < 0.8)
    v = {k: torch.zeros(400, dtype=torch.int64) for k in ("nodes", "tris", "hits")}
    v.update(node_rows=torch.zeros(s.num_nodes, dtype=torch.bool),
             tri_rows=torch.zeros(s.rows.shape[0], dtype=torch.bool), order=[])
    want = ttr.emissive_pdf_walk_reference(s, rays, active, t_min, visits=v)
    words = s.nodes.view(torch.int32)
    binary = {k: [] for k in np.flatnonzero(active.numpy()).tolist()}
    for lanes, leaves in v["order"]:
        for lane, leaf in zip(lanes.tolist(), leaves.tolist()):
            binary[lane].append((int(words[leaf, 3]), int(words[leaf, 7])))
    orders, got = _wide_walk(s, rays, active, t_min)
    assert orders == binary
    assert sum(len(x) for x in orders.values()) > 1000
    assert torch.equal(got, want) and int((want > 0).sum()) > 100


def test_walk_refuses_what_the_kernel_does_not_take():
    jt, tt = _tables(0, 2000)
    rays = tuple(torch.zeros(4) for _ in range(6))
    with pytest.raises(ValueError):
        ttr.emissive_pdf_walk(tt.em_stream, rays, torch.ones(4, dtype=torch.bool, device="meta"),
                              EPS)


def _cuda_constants() -> dict:
    """csrc/bvh_walk.cu's ``constexpr int kName = <int or 1 << int>;`` lines."""
    import re

    src = (Path(__file__).resolve().parent.parent / "vulkan_raytracer_tpu_torch" / "csrc"
           / "bvh_walk.cu").read_text()
    out = {}
    for name, value in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        m = re.fullmatch(r"(\d+)|1 << (\d+)", value.strip())
        if m:
            out[name] = int(m[1]) if m[1] else 1 << int(m[2])
    return out


def test_walk_limits_are_the_kernel_sources():
    """The wrapper's limits are the CUDA walk's: the children of a wide node
    and the lanes of a ray (kWide), the stack words of a ray (kStack), the
    bits of a leaf word's first row (kRowBits), with a leaf's count less one
    between them and bit 31, and the wide nodes it takes (kMaxWideNodes)."""
    k = _cuda_constants()
    assert k["kWide"] == ttr.EMISSIVE_WIDE
    assert k["kStack"] == ttr.EMISSIVE_STACK
    assert k["kRowBits"] == ttr.EMISSIVE_ROW_BITS
    assert k["kMaxWideNodes"] == ttr.EMISSIVE_MAX_NODES
    assert ttr.EMISSIVE_WIDE - 1 < 2 ** (31 - ttr.EMISSIVE_ROW_BITS)


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
@pytest.mark.parametrize("scene", ["soup2000", "soup20000", "emitter_soup5000"])
def test_cuda_emissive_walk_matches_plain(scene, share, cuda_device):
    """emissive_walk_kernel against emissive_pdf_walk_reference on the
    streams of an all-emissive soup of 2,000 and of 20,000 triangles and of
    the emitter soup's 5,000 emissive triangles (``chip_smoke.
    emitter_soup_scene(100000, 5000, seed=31)``), at 524,288 rays and at a
    ragged 524,251, with the given share of live lanes (none, one, sparse,
    mixed, all), at both t_min the render uses: bit-equal on live lanes
    (``torch.equal``), exactly +0 elsewhere; one launch each."""
    if scene == "emitter_soup5000":
        tt = cs.emitter_soup_scene(100000, 5000, seed=31).upload(cuda_device)
    else:
        tt = cs.soup_scene(int(scene[4:]), seed=7).upload(cuda_device)
    stream = tt.em_stream
    before = ttr.LAUNCHES["emissive_pdf"]
    for n in (524288, 524251):
        rays = cs.make_rays(n, seed=n, device=cuda_device)
        cols = tdense.ray_columns(rays["o"], rays["d"])
        active = torch.as_tensor(cs.live_mask(n, share, seed=n), device=cuda_device)
        for t_min in (EPS, 0.0):
            got = ttr.emissive_pdf_walk(stream, cols, active, t_min)
            want = ttr.emissive_pdf_walk_reference(stream, cols, active, t_min)
            assert torch.equal(got[active], want[active]), (
                int((got[active] != want[active]).sum()), float(_max_abs(got, want)))
            off = got[~active]
            assert bool((off == 0.0).all()) and not bool(torch.signbit(off).any())
    assert ttr.LAUNCHES["emissive_pdf"] - before == 4


def _max_abs(a, b):
    return (a.double() - b.double()).abs().max() if a.numel() else 0.0
