"""The kernels around the traversal launches (``ops/trace.py``, ``csrc/trace.cu``).

On the CPU the wrappers run their plain versions, which are held here
against the JAX package:

* the closest hit's finish (``hit_finish``) against the finish of
  ``pallas_dense.pallas_closest`` and of ``pallas_bvh.packet_closest``
  (Pallas in interpret mode, as tests/test_torch_dense.py and
  tests/test_torch_bvh.py run them) for the same traversal result, JAX's:
  triangle ids and t bit-equal, (u, v) within atol 1e-5
  (tests/test_torch_bvh.py's tolerance), t = inf and u = v = 0 on a miss
  (the traversals themselves are held against JAX there);
* the instance steps (``instance_step``, the scans of ``instanced_closest``
  / ``instanced_shadow``) against JAX ``instanced_closest`` /
  ``instanced_shadow`` on dense groups and on a BLAS (tests/test_torch_instancing.py's
  scene and rays; t within its rtol 5e-6, XLA contracting the affine map into
  FMAs), one step an instance and one more a call;
* the key (``coherence_key``) bit-equal to JAX ``_coherence_key`` on a
  forced-BVH Cornell box and on an instanced scene's refit tables, also over
  the box the kernel reads (``key_box``), and its stable permutation equal
  to ``jnp.argsort``'s;
* the permutation (``permute``) in its three modes against the re-sort's
  former ``index_select`` / ``index_copy_`` / ``copy_`` and
  ``_sort_wavefront`` against its former per-field gathers; the plain
  version on identity, reversed, block-shuffled and random permutations of
  1, 3, 1,025 and 4,099 lanes of 1-, 4- and 8-byte columns, and
  tools/check_torch_trace.py's synthetic check, both sides plain.

Beside them: the column tables name ``csrc/trace.cu``'s enums in order, and
the permutation's layout its constants; each
kernel's byte count lists the lane columns its source names; with the
wrappers routed to stubbed launches, a closest hit or an alpha pass runs a
few aten ops beside its kernels, an instance step none and a re-sort's key
none (on an instanced scene too); and a wrapper
whose launch fails raises and never runs its plain version;
tools/check_torch_trace.py finds no lane with both sides plain, and times
its kernels on copies of their inputs that span four times the L2.  Marked ``cuda``
(they skip without a card): each kernel against its plain version on the
card, bit for bit, the permutation also on the synthetic permutations.
"""

import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

from vulkan_raytracer_tpu_torch.ops import _ext, dense, instanced, trace, traverse  # noqa: E402
from vulkan_raytracer_tpu_torch.ops.math3 import V3, v3_gather  # noqa: E402
from vulkan_raytracer_tpu_torch.render import graphs  # noqa: E402
from vulkan_raytracer_tpu_torch.render import integrator as tint  # noqa: E402
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene  # noqa: E402

UV_ATOL = 1e-5  # tests/test_torch_bvh.py
INST_T_RTOL = 5e-6  # tests/test_torch_instancing.py
N = 512


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("VKRT_PALLAS_INTERPRET", "1")


def _np_tree(t):
    import jax

    return jax.tree_util.tree_map(np.asarray, t)


def _rays(n, seed, lo=-0.9, hi=0.9, dy=1.0):
    """Rays inside a box, per-lane t_min, dead lanes: numpy arrays."""
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[:, 1] += dy
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.where(np.arange(n) % 3 == 0, r.uniform(0.0, 0.5, n), 1e-7).astype(np.float32)
    return o, d, t_min, np.arange(n) % 5 != 0


def _v3(a, kind):
    if kind == "jax":
        import jax.numpy as jnp
        from vulkan_raytracer_tpu.ops.math3 import V3 as JV3

        return JV3(*(jnp.asarray(a[:, k]) for k in range(3)))
    return V3(*(torch.as_tensor(a[:, k].copy()) for k in range(3)))


@pytest.mark.parametrize("mode", ["dense", "bvh"])
def test_hit_finish_matches_jax(mode, interpret, monkeypatch):
    """The finish of JAX's Pallas closest hit (K1's, or K4''s through
    ``_slot_to_tri``) for the same traversal result: JAX's (t, tri), the
    triangle as its slot of the port's streams in "bvh" mode, go through the
    finish, which must give JAX's triangle ids bit for bit, its t, and its
    (u, v) within atol 1e-5."""
    import jax.numpy as jnp
    from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
    from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

    if mode == "dense":
        from vulkan_raytracer_tpu.ops.pallas_dense import pallas_closest as jclosest
    else:
        from vulkan_raytracer_tpu.ops.pallas_bvh import packet_closest as jclosest
        monkeypatch.setenv("VKRT_FORCE_PACKET", "1")
    jt = jcornell().upload()
    tt = tables_from_numpy(_np_tree(jt), "cpu", traversal=mode if mode == "bvh" else "auto")
    o, d, t_min, act = _rays(N, seed=4)
    t_j, tri_j, u_j, v_j = (np.asarray(x) for x in jclosest(
        jt, _v3(o, "jax"), _v3(d, "jax"), t_min=jnp.asarray(t_min), t_max=1e32,
        active=jnp.asarray(act)))
    hit = tri_j >= 0
    assert N // 4 < hit.sum() < act.sum() and not hit[~act].any()
    ids = torch.as_tensor(tri_j.copy())
    if mode == "bvh":  # each triangle's row of the shared table
        slot_of = torch.argsort(tt.pbvh.tri_id).int()
        assert torch.equal(tt.pbvh.tri_id[slot_of.long()], torch.arange(36, dtype=torch.int32))
        ids = torch.where(ids >= 0, slot_of[ids.clamp_min(0).long()], -1)
    rays = dense.ray_columns(_v3(o, "torch"), _v3(d, "torch"))
    t, tri, u, v = (x.numpy() for x in trace.hit_finish(tt, rays, torch.as_tensor(t_j.copy()),
                                                          ids, mode))
    np.testing.assert_array_equal(tri, tri_j)
    np.testing.assert_array_equal(t[hit], t_j[hit])
    assert np.isinf(t[~hit]).all() and (u[~hit] == 0).all() and (v[~hit] == 0).all()
    np.testing.assert_allclose(u[hit], u_j[hit], atol=UV_ATOL)
    np.testing.assert_allclose(v[hit], v_j[hit], atol=UV_ATOL)


@pytest.mark.parametrize("kind", ["dense", "blas"])
def test_instance_steps_match_jax(kind, monkeypatch):
    """The instance scans, one ``instance_step`` an instance and one more a
    call, then the finish, against JAX ``instanced_closest`` /
    ``instanced_shadow``: dense groups, and the soup prototype on a BLAS
    (DENSE_MAX_TRIS shrunk; JAX's walk in interpret mode)."""
    import jax.numpy as jnp
    from test_torch_instancing import _shell_rays, instanced_scene
    from vulkan_raytracer_tpu.ops import instanced as jinst
    from vulkan_raytracer_tpu.scene import scenegraph as jsg
    from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

    if kind == "blas":
        monkeypatch.setattr(jsg, "DENSE_MAX_TRIS", 50)
        monkeypatch.setattr(dense, "DENSE_MAX_TRIS", 50)
        monkeypatch.setenv("VKRT_PALLAS_INTERPRET", "1")
    jt = instanced_scene(jsg, n_soup_instances=3).upload(instancing=True)
    tt = tables_from_numpy(_np_tree(jt), "cpu")
    assert (tt.inst.groups[0].pblas is not None) == (kind == "blas")
    steps = []
    step = trace.instance_step
    monkeypatch.setattr(trace, "instance_step",
                        lambda *a, **k: steps.append(k["shadow"]) or step(*a, **k))
    n = 256
    o, d, t_min, t_sh, act = _shell_rays(n, seed=5)
    jo, jd, to, td = _v3(o, "jax"), _v3(d, "jax"), _v3(o, "torch"), _v3(d, "torch")
    want = jinst.instanced_closest(jt, jo, jd, t_min=jnp.asarray(t_min), t_max=1e32,
                                   active=jnp.asarray(act))
    got = instanced.instanced_closest(tt, to, td, t_min=torch.as_tensor(t_min), t_max=1e32,
                                      active=torch.as_tensor(act))
    e, je = got[1].numpy(), np.asarray(want[1])
    hit = je >= 0
    np.testing.assert_array_equal(e, je)
    assert hit.sum() > n // 8 and len(set((e[hit] // tt.inst.num_proto_tris).tolist())) > 2
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit], rtol=INST_T_RTOL)
    for k in (2, 3):
        np.testing.assert_allclose(got[k].numpy()[hit], np.asarray(want[k])[hit], atol=UV_ATOL)
    occ = instanced.instanced_shadow(tt, to, td, t_max=torch.as_tensor(t_sh),
                                     active=torch.as_tensor(act))
    jocc = jinst.instanced_shadow(jt, jo, jd, t_max=jnp.asarray(t_sh), active=jnp.asarray(act))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert 0 < occ.sum() < act.sum()
    instances = tt.inst.num_instances
    assert steps == [False] * (instances + 1) + [True] * (instances + 1)


@pytest.mark.parametrize("case", ["cornell_bvh", "instanced_refit"])
def test_coherence_key_matches_jax(case, monkeypatch):
    """The key's plain version bit-equal to JAX ``_coherence_key`` on a
    forced-BVH Cornell box (its root box) and on an instanced scene after a
    refit that moves an instance (each package's own refit tables: the
    instance boxes' union), and its stable permutation; then over the box
    the kernel reads (``trace.key_box``: on the instanced scene the tables'
    stored union box), bit-equal again."""
    import jax.numpy as jnp
    from test_torch_instancing import _trs, instanced_scene
    from test_torch_repack import _key_inputs
    from vulkan_raytracer_tpu.render import integrator as jint
    from vulkan_raytracer_tpu.scene import scenegraph as jsg
    from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as jcornell
    from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy

    if case == "cornell_bvh":
        jt = jcornell().upload()
        tt = tables_from_numpy(_np_tree(jt), "cpu", traversal="bvh")
    else:
        def refit(sg, up):
            s = instanced_scene(sg, n_soup_instances=3)
            t0 = up(s)
            next(n for n in s.iter_depth_first() if n.mesh == 0).world_transform = _trs(
                (1.5, 4.8, -1.2), ry=0.5)
            return s.refit(t0)

        jt = refit(jsg, lambda s: s.upload(instancing=True))
        tt = refit(tsg, lambda s: s.upload("cpu", instancing=True))
    o, d, dead = _key_inputs(tt, 2048, seed=8)
    want = np.asarray(jint._coherence_key(jt, _v3(o, "jax"), _v3(d, "jax"), jnp.asarray(dead)))
    got = trace.coherence_key(tt, _v3(o, "torch"), _v3(d, "torch"), torch.as_tensor(~dead))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    assert len(np.unique(want)) > 500
    np.testing.assert_array_equal(torch.argsort(got, stable=True).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(want))))
    monkeypatch.setattr(trace, "root_bounds", trace.key_box)
    boxed = trace.coherence_key(tt, _v3(o, "torch"), _v3(d, "torch"), torch.as_tensor(~dead))
    assert torch.equal(boxed, got)


def _state(n, seed):
    """A repacked wave state of random columns (21 of them)."""
    g = torch.Generator().manual_seed(seed)

    def v3():
        return V3(*(torch.randn(n, generator=g) for _ in range(3)))

    return dict(origin=v3(), direction=v3(), value=v3(), throughput=v3(),
                seed=torch.randint(0, 2**32, (n,), generator=g),
                wavelength=torch.rand(n, generator=g),
                mat_pdf=torch.rand(n, generator=g), active=torch.rand(n, generator=g) < 0.6,
                sky_w=v3(), preview=torch.rand(n, generator=g) < 0.5,
                slot=torch.randperm(n, generator=g))


def test_permute_modes_match_the_index_ops(monkeypatch):
    """Gather, scatter and copy of a state's columns against the re-sort's
    former ``index_select`` per field, ``index_copy_`` and ``copy_``; the
    re-sort itself against its former per-field gathers, on a BVH scene."""
    s = _state(300, seed=2)
    cols = list(graphs._leaves(s))
    assert len(cols) == 21
    perm = torch.randperm(300, generator=torch.Generator().manual_seed(3))
    for got, c in zip(trace.permute(cols, perm), cols):
        assert got.dtype == c.dtype and torch.equal(got, torch.index_select(c, 0, perm))
    for got, c in zip(trace.permute(cols, perm, "scatter"), cols):
        assert torch.equal(got, torch.empty_like(c).index_copy_(0, perm, c))
    out = [torch.empty_like(c) for c in cols]
    assert trace.permute(cols, mode="copy", out=out) == out
    assert all(torch.equal(a, b) for a, b in zip(out, cols))
    tables = cornell_box_scene().upload("cpu", traversal="bvh")
    key = trace.coherence_key(tables, s["origin"], s["direction"], s["active"])
    p = torch.argsort(key, stable=True)
    want = {k: v3_gather(v, p) if isinstance(v, V3) else torch.index_select(v, 0, p)
            for k, v in s.items()}
    got = tint._sort_wavefront(tables, s)
    assert list(got) == list(want)
    assert all(torch.equal(a, b) for a, b in zip(graphs._leaves(got), graphs._leaves(want)))
    assert not bool(got["active"][-1]) and bool(got["active"][0])  # dead lanes last


PERM_KINDS = ("identity", "reversed", "blocks", "random")


def _permutation(kind, n, seed):
    """tools/check_torch_trace.py's permutation, from numpy: identity,
    reversed, shuffled within 1,024-lane blocks, or random."""
    r = np.random.default_rng(seed)
    if kind == "identity":
        p = np.arange(n)
    elif kind == "reversed":
        p = np.arange(n)[::-1].copy()
    elif kind == "random":
        p = r.permutation(n)
    else:
        p = np.argsort(np.arange(n) // 1024 + r.random(n), kind="stable")
    return torch.as_tensor(p, dtype=torch.int64)


@pytest.mark.parametrize("kind", PERM_KINDS)
@pytest.mark.parametrize("n", [1, 3, 1025, 4099])
def test_permute_reference_matches_the_index_ops(kind, n):
    """The plain permutation of 1-, 4- and 8-byte columns against
    ``index_select`` (gather), ``index_copy_`` (scatter) and ``copy_`` on
    synthetic permutations, each lane checked against the permutation."""
    r = np.random.default_rng(n)
    cols = [torch.as_tensor(r.random(n) < 0.5), torch.as_tensor(r.random(n).astype(np.float32)),
            torch.as_tensor(r.integers(-2**31, 2**31, n, dtype=np.int32)),
            torch.as_tensor(r.integers(0, 2**40, n))]
    assert [c.element_size() for c in cols] == [1, 4, 4, 8]
    perm = _permutation(kind, n, seed=n + 1)
    assert torch.equal(torch.sort(perm).values, torch.arange(n))
    p = perm.numpy()
    for got, c in zip(trace.permute_reference(cols, perm, "gather"), cols):
        assert torch.equal(got, torch.index_select(c, 0, perm))
        np.testing.assert_array_equal(got.numpy(), c.numpy()[p])
    for got, c in zip(trace.permute_reference(cols, perm, "scatter"), cols):
        assert torch.equal(got, torch.empty_like(c).index_copy_(0, perm, c))
        np.testing.assert_array_equal(got.numpy()[p], c.numpy())
    out = [torch.empty_like(c) for c in cols]
    assert trace.permute_reference(cols, mode="copy", out=out) == out
    assert all(torch.equal(a, b) for a, b in zip(out, cols))
    # the wrapper on CPU tensors is the plain version
    for got, c in zip(trace.permute(cols, perm), cols):
        assert torch.equal(got, torch.index_select(c, 0, perm))


def test_synthetic_check_finds_nothing_on_the_cpu(monkeypatch):
    """tools/check_torch_trace.py's synthetic check with both sides plain:
    every kind and mode at small counts, the tool's permutations true
    permutations, its state the wave state's 21 column widths."""
    import check_torch_trace as ctt

    monkeypatch.setattr(ctt, "PERM_LANES", (1, 3, 1025, 4099))
    out = ctt.synthetic(torch.device("cpu"))
    assert out["checked"] == 4 * len(ctt.PERM_KINDS) * 3 and out["differing"] == []
    cols = ctt._state_columns(5, torch.device("cpu"), seed=1)
    assert sorted(c.element_size() for c in cols) == [1] * 2 + [4] * 17 + [8] * 2
    for kind in ctt.PERM_KINDS:
        p = ctt.permutation(kind, 3000, torch.device("cpu"), seed=2)
        assert torch.equal(torch.sort(p).values, torch.arange(3000)), kind
        if kind == "blocks":  # each lane stays in its 1,024-lane block
            assert torch.equal(p // 1024, torch.arange(3000) // 1024)


# ---------------------------------------------------------------------------
# The source
# ---------------------------------------------------------------------------


SRC = ROOT / "vulkan_raytracer_tpu_torch" / "csrc" / "trace.cu"


def _enum(src: str, name: str) -> tuple:
    """An enum's names in order; ``X = Y0 + kCols`` ends the run that starts
    at ``Y0``, which stands for ``Y0`` .. ``Y{kCols - 1}``."""
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    cols = int(re.search(r"constexpr int kCols = (\d+);", src).group(1))
    out = []
    for w in (w.strip() for w in body.split(",") if w.strip()):
        if "=" in w:
            w, base = (x.strip() for x in w.split("=", 1))
            base = base.split("+")[0].strip()
            out[out.index(base):] = [f"{base[:-1]}{k}" for k in range(cols)]
        out.append(w)
    return tuple(out)


def test_slots_are_the_kernel_source_enums():
    """ops/trace.py's SLOTS, INTS, REALS and modes name csrc/trace.cu's enums
    in order, and the build compiles it with its launchers bound."""
    src = SRC.read_text()
    cols = trace.MAX_COLS
    assert int(re.search(r"constexpr int kCols = (\d+);", src).group(1)) == cols
    assert _enum(src, "Slot") == (*trace.SLOTS, "kSlots")
    assert _enum(src, "Int") == (*trace.INTS, "kInts")
    assert _enum(src, "Real") == (*trace.REALS, "kReals")
    header = (SRC.parent / "hit_finish.cuh").read_text()  # the finish the commit shares
    assert _enum(header + src, "Finish") == ("kDense", "kBvh", "kInstanced")
    assert _enum(src, "Permute") == ("kGather", "kScatter", "kCopy")
    assert tuple(m.capitalize() for m in trace.FINISH_MODES) == ("Dense", "Bvh", "Instanced")
    assert "trace.cu" in {p.name for p in _ext.SOURCES}
    assert '#include "hit_finish.cuh"' in src and '#include "lane_math.cuh"' in header
    for k in ("hit_finish", "instance_step", "coherence_key", "permute"):
        grid = "permute_grid" if k == "permute" else "lane_grid"
        assert f"TRACE_LAUNCHER({k}_launch, {k}_kernel, {grid})" in src
        assert _ext._SIGNATURES[f"{k}_launch"] == [_ext._I] + [_ext._P] * 4
    assert tint.LAUNCH_COUNTERS["trace"] is trace.LAUNCHES


def _constants(src: str) -> dict:
    """The ``constexpr int`` constants of a source, evaluated in order."""
    out = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        out[name] = eval(expr, {}, dict(out))  # noqa: S307  (the source's own arithmetic)
    return out


def test_permute_layout_is_the_kernel_source_constants():
    """ops/trace.py's permutation layout (a copy's chunk, 16 bytes a
    thread; a copy's blocks an SM; columns) is csrc/trace.cu's, with the
    kernel's launch bounds and its grids."""
    src = SRC.read_text()
    c = _constants(src)
    assert (c["kCopyChunk"], c["kPermBlocksPerSm"], c["kCols"]) == (
        trace.COPY_CHUNK, trace.PERMUTE_BLOCKS_PER_SM, trace.MAX_COLS)
    assert c["kCopyChunk"] == 16 * c["kThreads"]
    assert "__launch_bounds__(kThreads, kPermBlocksPerSm)" in src
    assert "static_cast<long long>(sms[device]) * kPermBlocksPerSm" in src
    assert "if (args.i[I_MODE] != kCopy) return lane_grid(args, device, blocks);" in src


def _kernel_columns(src: str) -> dict:
    """kernel -> the lane columns its body and the functions it calls name
    (``ray_o`` / ``ray_d`` standing for their three)."""
    src = re.sub(r"//[^\n]*", "", src)
    bodies = {}
    for m in re.finditer(r"\b(\w+)\s*\((?:[^;{}()]|\([^;{}()]*\))*\)\s*(?:const\s*)?\{", src):
        depth, end = 0, m.end() - 1
        for end in range(m.end() - 1, len(src)):
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            if depth == 0:
                break
        if m.group(1) not in ("if", "for", "while", "switch"):
            bodies.setdefault(m.group(1), src[m.end():end])
    lane = {x for x in trace.SLOTS if x.split("_")[0] in ("W", "H", "O", "S", "N", "P")
            or x in ("X_ACTIVE", "X_TMAX", "K_ACTIVE", "K_KEY")}
    out = {}
    for kernel in trace.MOVES:
        seen, todo, found = set(), [f"{kernel}_kernel"], set()
        while todo:
            body = bodies[todo.pop()]
            for w in set(re.findall(r"\b\w+\b", body)):
                if w in bodies and w not in seen:
                    seen.add(w)
                    todo.append(w)
                if w in lane:
                    found.add(w)
        out[kernel] = found
    return out


def test_moved_columns_are_the_kernel_source_loads():
    """The lane columns ops/trace.py counts in each kernel's bytes bound
    (MOVES) are those the kernel names in csrc/trace.cu; the counts add up
    as each byte count's docstring says."""
    assert {k: set(v) for k, v in trace.MOVES.items()} == _kernel_columns(SRC.read_text())
    hit = torch.tensor([3, -1, 0, -1], dtype=torch.int32)
    assert trace.hit_finish_bytes(hit) == 4 * 20 + 2 * 28
    # the table rows a finish loads (csrc/hit_finish.cuh), each counted once
    header = (SRC.parent / "hit_finish.cuh").read_text()
    body = header[header.index("__device__ __forceinline__ int finish_hit("):]
    assert header.count("finish_vertex(f, ") == 3 and "f.v[first + 2][t]" in header
    assert "f.tri_id[hit]" in body and "k < 12; ++k) m[k] = f.inv_flat[" in body
    assert trace.FINISH_ROW_BYTES == {"vertices": 9 * 4, "slot": 4, "instance": 12 * 4}
    assert '#include "hit_finish.cuh"' in SRC.read_text()
    tables = cornell_box_scene().upload("cpu", traversal="bvh")
    hits = torch.tensor([3, -1, 3, 0, 5], dtype=torch.int32)
    assert trace.finish_table_bytes(tables, hits, "dense") == 3 * 36
    slots = tables.pbvh.tri_id.long()
    twins = [i for i in range(len(slots)) if slots[i] == slots[0]]
    hits = torch.tensor([twins[-1], -1, 0, 0], dtype=torch.int32)
    assert trace.finish_table_bytes(tables, hits, "bvh") == 4 * len({twins[-1], 0}) + 36
    assert trace.hit_finish_bytes(hits, tables, "bvh") == (
        trace.hit_finish_bytes(hits) + trace.finish_table_bytes(tables, hits, "bvh"))
    assert trace.coherence_key_bytes(10) == 10 * 29
    cols = [torch.zeros(10), torch.zeros(10, dtype=torch.int64), torch.zeros(10, dtype=torch.bool)]
    assert trace.permute_bytes(cols, "gather") == 2 * 10 * 13 + 8 * 10
    assert trace.permute_bytes(cols, "copy") == 2 * 10 * 13
    # a middle step of the closest scan: flag, 1/d, state twice, touched
    # flags read and written, merge, next
    assert trace.instance_step_bytes(10, first=False, prev=True, nxt=True, shadow=False,
                                     t_max_lanes=False, t_lo=False) == 10 * (
        1 + 12 + 16 + 2 + 8 + 24 + 28)
    # the merge reads the last launch only where a lane touched its box
    assert trace.instance_step_bytes(10, first=False, prev=True, nxt=True, shadow=False,
                                     t_max_lanes=False, t_lo=False, touched=3) == (
        10 * (1 + 12 + 16 + 2 + 24 + 28) + 3 * 8)


# ---------------------------------------------------------------------------
# Routed to the kernels: what runs beside them, and a failed launch
# ---------------------------------------------------------------------------


class _Ops(TorchDispatchMode):
    """aten ops outside the wrappers and the traversal kernels' plain
    versions (views and allocations aside)."""

    QUIET = {"empty", "empty_strided", "unbind", "select", "slice", "view", "alias", "detach",
             "expand", "as_strided", "lift_fresh", "_to_copy", "copy", "empty_like",
             "scalar_tensor"}

    def __init__(self):
        super().__init__()
        self.paused, self.ops = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if not self.paused and name not in self.QUIET:
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def _routed(monkeypatch, mode, fail=None):
    """The trace wrappers routed to their kernels on CPU tensors with the
    launch stubbed (a no-op, or raising ``fail``), and the traversal kernels'
    plain versions opaque to ``mode``.  Returns the launches."""
    launched = []

    def launch(fn, device, *args):
        if fail is not None:
            raise fail
        launched.append(fn)

    monkeypatch.setattr(trace, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_ext, "launch", launch)
    monkeypatch.setattr(trace, "instance_state",
                        lambda n, device, **kw: _cuda_state(n, **kw))
    for mod, name in ((dense, "closest_sweep"), (dense, "shadow_sweep"), (traverse, "walk"),
                      (instanced, "closest_sweep"), (instanced, "shadow_sweep"),
                      (instanced, "walk")):
        fn = getattr(mod, name)

        def opaque(*a, _fn=fn, **k):
            mode.paused += 1
            try:
                return _fn(*a, **k)
            finally:
                mode.paused -= 1
        monkeypatch.setattr(mod, name, opaque)
    return launched


def _cuda_state(n, *, shadow, t_lo):
    """:func:`trace.instance_state`'s buffers as a card gets them, on the CPU."""
    rows = torch.empty((8 + t_lo, n)).unbind(0)
    st = {"inv": torch.empty((n, 3)), "rays": tuple(rows[:6]), "t_init": rows[6],
          "touches": torch.empty(n, dtype=torch.bool)}
    if shadow:
        st.update(occ=torch.empty(n, dtype=torch.bool))
    else:
        st.update(t_best=rows[7], enc=torch.empty(n, dtype=torch.int32))
    if t_lo:
        st["t_lo"] = rows[-1]
    return st


@pytest.mark.parametrize("scene", ["dense", "bvh", "instanced"])
def test_closest_runs_few_aten_ops_beside_its_kernels(scene, monkeypatch):
    """With the wrappers routed to their (stubbed) kernels and the traversal
    opaque, a closest hit at a scalar t_min and an alpha pass (per-lane
    t_min) run at most 3 aten ops of their own (the bounds around the
    launch), a shadow query at most 4 (the bounds, the flag), and an
    instance scan none: each step is one launch."""
    from test_torch_instancing import instanced_scene

    if scene == "instanced":
        monkeypatch.setattr(dense, "DENSE_MAX_TRIS", 50)
        tables = instanced_scene(tsg, n_soup_instances=3).upload("cpu", instancing=True)
    else:
        tables = cornell_box_scene().upload("cpu", traversal="bvh" if scene == "bvh" else "auto")
    if scene == "dense":
        assert tables.tri_table is not None  # built on first use, outside the count
    o, d, t_min, act = _rays(64, seed=1)
    o, d = _v3(o, "torch"), _v3(d, "torch")
    active, t_lo = torch.as_tensor(act), torch.as_tensor(t_min)
    t_hi = t_lo + 1.0
    mode = _Ops()
    launched = _routed(monkeypatch, mode)
    trace.reset_launches()
    with mode:
        tint._closest_opaque(tables, o, d, t_min=1e-7, t_max=1e32, active=active)
        closest = list(mode.ops)
        tint._closest_opaque(tables, o, d, t_min=t_lo, t_max=1e32, active=active)
        alpha = mode.ops[len(closest):]
        mode.ops.clear()
        tint._shadow_unsorted(tables, o, d, t_max=t_hi, active=active, seed=None)
    assert len(closest) <= 3 and len(alpha) <= 3 and len(mode.ops) <= 4, (closest, alpha,
                                                                        mode.ops)
    steps = 0 if scene != "instanced" else 3 * (tables.inst.num_instances + 1)
    assert trace.LAUNCHES == {"hit_finish": 2, "instance_step": steps,
                              "coherence_key": 0, "permute": 0, "permute_copy": 0}
    assert launched.count("hit_finish_launch") == 2


@pytest.mark.parametrize("scene", ["dense", "bvh", "instanced"])
def test_alpha_pass_is_its_traversal_and_one_kernel(scene, monkeypatch):
    """An alpha pass routed to the kernels (the traversal's kernels opaque):
    its traversal (on an instanced scene, the scan's steps) and one
    ``alpha_commit_launch``, which reads the raw hit: no ``hit_finish``
    launch, no count to zero, and at most 3 aten ops of its own (the bounds
    around the traversal)."""
    from test_torch_instancing import instanced_scene

    from vulkan_raytracer_tpu_torch.ops import wave

    if scene == "instanced":
        monkeypatch.setattr(dense, "DENSE_MAX_TRIS", 50)
        tables = instanced_scene(tsg, n_soup_instances=3).upload("cpu", instancing=True)
    else:
        tables = cornell_box_scene().upload("cpu", traversal="bvh" if scene == "bvh" else "auto")
    if scene == "dense":
        assert tables.tri_table is not None  # built on first use, outside the count
    for name in ("alpha", "tri_mat", "uv", "materials", "tex"):  # the commit's tables
        assert getattr(tables, name) is not None, name
    n = 64
    o, d, _, act = _rays(n, seed=2)
    o, d = _v3(o, "torch"), _v3(d, "torch")
    st = dict(t_lo=torch.zeros(n), pending=torch.as_tensor(act),
              t=torch.full((n,), torch.inf), tri=torch.full((n,), -1, dtype=torch.int32),
              u=torch.zeros(n), v=torch.zeros(n), seed=torch.zeros(n, dtype=torch.int64))
    mode = _Ops()
    launched = _routed(monkeypatch, mode)
    monkeypatch.setattr(wave, "_on_cuda", lambda t: True)
    loop = wave.loop_block("cpu")
    trace.reset_launches()
    wave.reset_launches()
    with mode:
        tint._alpha_pass(tables, o, d, 1e32, st, loop)
    steps = 0 if scene != "instanced" else tables.inst.num_instances + 1
    assert launched == ["instance_step_launch"] * steps + ["alpha_commit_launch"]
    assert trace.LAUNCHES["hit_finish"] == 0 and wave.LAUNCHES["alpha_commit"] == 1
    assert len(mode.ops) <= 3 and "fill" not in mode.ops and "zero" not in mode.ops, mode.ops


@pytest.mark.parametrize("scene", ["bvh", "instanced"])
def test_resort_is_a_key_a_sort_and_one_gather(scene, monkeypatch):
    """A re-sort routed to the kernels: the key (one launch and no op
    around it, on an instanced scene too: its box is the tables'), the
    library argsort and one permute launch for all 21 columns; a program's
    copy back one more, counted apart."""
    from test_torch_instancing import instanced_scene

    if scene == "instanced":
        tables = instanced_scene(tsg, n_soup_instances=3).upload("cpu", instancing=True)
    else:
        tables = cornell_box_scene().upload("cpu", traversal="bvh")
    s = _state(64, seed=4)
    mode = _Ops()
    launched = _routed(monkeypatch, mode)
    trace.reset_launches()
    with mode:
        sorted_ = tint._sort_wavefront(tables, s)
        graphs._copy_state(s, sorted_)
    assert launched == ["coherence_key_launch", "permute_launch", "permute_launch"]
    assert [op for op in mode.ops if op not in ("sort",)] == [], mode.ops
    # the copy is a program's own: the counts every side shares leave it out
    assert trace.LAUNCHES["permute"] == trace.LAUNCHES["permute_copy"] == 1
    assert tint.launch_counts()["trace"]["permute_copy"] == 1
    assert "permute_copy" not in tint.launch_counts(loops=False)["trace"]


@pytest.mark.parametrize("config", ["cfg1", "gallery"])
def test_check_tool_finds_no_lane_on_the_cpu(config):
    """tools/check_torch_trace.py with both sides plain (the CPU): the
    flattened finish, and the instanced scan, finish, key and permutation."""
    import check_torch_trace
    import check_torch_wave

    with tempfile.TemporaryDirectory() as tmp:
        build, cam, _, _, _, depth = check_torch_wave.configs(Path(tmp))[config]
        line = check_torch_trace.check_config(config, (build, cam, 16, 16, 2, depth),
                                              torch.device("cpu"))
    assert line["differing_lanes"] == 0 and line["finite"]
    assert line["calls"]["hit_finish"] >= 3
    if config == "gallery":
        assert min(line["calls"].values()) > 0


def test_check_tool_times_on_copies_beyond_the_l2():
    """The timing's copies of a call's inputs: fresh tensors, the named
    tuples (V3, an instance) kept, the scene tables shared, and enough of
    them that their bytes span four times the L2."""
    import check_torch_trace

    tables = object()
    o = V3(*torch.zeros((3, 4)))
    inst = instanced.Instance(None, torch.zeros(12), torch.tensor(0), torch.zeros(3),
                              torch.zeros(3))
    args = (tables, o, [torch.ones(4)], (inst, torch.ones(4)), "gather")
    copies = check_torch_trace._copies(args, 10**6)
    assert len(copies) * 10**6 >= check_torch_trace.COLD_BYTES >= 4 * 50 * 10**6
    assert len(check_torch_trace._copies(args, 10**9)) == 2
    for c in copies[1:]:
        assert c[0] is tables and c[4] == "gather"
        assert type(c[1]) is V3 and type(c[3][0]) is instanced.Instance
        assert c[1].x.data_ptr() != o.x.data_ptr() and torch.equal(c[1].x, o.x)
        assert isinstance(c[2], list) and c[2][0].data_ptr() != args[2][0].data_ptr()


@pytest.mark.parametrize("kernel", ["hit_finish", "instance_step", "coherence_key", "permute"])
def test_failed_launch_raises(kernel, monkeypatch):
    """A wrapper routed to its kernel whose launch fails raises, and never
    runs its plain version."""
    from test_torch_instancing import instanced_scene

    plain = []
    for name in ("hit_finish_reference", "instance_step_reference", "coherence_key_reference",
                 "permute_reference"):
        monkeypatch.setattr(trace, name, lambda *a, _n=name, **k: plain.append(_n))
    _routed(monkeypatch, _Ops(), fail=RuntimeError("trace: CUDA error 700"))
    before = dict(trace.LAUNCHES)
    tables = instanced_scene(tsg, n_soup_instances=2).upload("cpu", instancing=True)
    o, d, _, act = _rays(32, seed=2)
    o, d, active = _v3(o, "torch"), _v3(d, "torch"), torch.as_tensor(act)
    rays = dense.ray_columns(o, d)
    calls = {
        "hit_finish": lambda: trace.hit_finish(tables, rays, torch.ones(32),
                                               torch.zeros(32, dtype=torch.int32), "instanced"),
        "instance_step": lambda: instanced.instanced_shadow(tables, o, d, t_max=1e32,
                                                            active=active),
        "coherence_key": lambda: trace.coherence_key(tables, o, d, active),
        "permute": lambda: trace.permute([o.x, active], torch.arange(32)),
    }
    with pytest.raises(RuntimeError, match="CUDA error"):
        calls[kernel]()
    assert plain == [] and trace.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _plain(monkeypatch):
    """Patch the wrappers to their plain versions (the traversal kernels stay)."""
    for name in ("hit_finish", "instance_step", "coherence_key", "permute"):
        monkeypatch.setattr(trace, name, getattr(trace, f"{name}_reference"))
    monkeypatch.setattr(trace, "instance_state", lambda n, device, **kw: {})


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["dense", "bvh", "instanced_dense", "instanced_blas"])
def test_kernels_bit_equal_on_the_card(scene, monkeypatch):
    """The closest hit, the shadow query and the re-sort on the card through
    the kernels against the same calls with the wrappers patched to their
    plain versions (the traversal kernels on both sides): every output
    bit-equal, each kernel launched."""
    _card()
    from test_torch_instancing import _shell_rays, instanced_scene

    if scene.startswith("instanced"):
        if scene.endswith("blas"):
            monkeypatch.setattr(dense, "DENSE_MAX_TRIS", 50)
        tables = instanced_scene(tsg, n_soup_instances=4).upload("cuda", instancing=True)
        o, d, t_min, t_sh, act = _shell_rays(100_003, seed=6)
    else:
        tables = cornell_box_scene().upload("cuda", traversal="bvh" if scene == "bvh" else "auto")
        o, d, t_min, act = _rays(100_003, seed=6)
        t_sh = t_min + 2.0
    o, d = (V3(*(torch.as_tensor(a[:, k].copy(), device="cuda") for k in range(3))) for a in (o, d))
    active = torch.as_tensor(act, device="cuda")
    t_lo, t_hi = (torch.as_tensor(a, device="cuda") for a in (t_min, t_sh))

    def run():
        out = [*tint._closest_opaque(tables, o, d, t_min=1e-7, t_max=1e32, active=active),
               *tint._closest_opaque(tables, o, d, t_min=t_lo, t_max=1e32, active=active),
               tint._shadow_unsorted(tables, o, d, t_max=t_hi, active=active, seed=None)[0]]
        if tables.pbvh is not None or tables.inst is not None:
            key = trace.coherence_key(tables, o, d, active)
            perm = torch.argsort(key, stable=True)
            cols = trace.permute([*o, *d, active, t_lo], perm)
            out += [key, *cols, *trace.permute(cols, perm, "scatter")]
        return out

    trace.reset_launches()
    got = run()
    launched = dict(trace.LAUNCHES)
    with monkeypatch.context() as m:
        _plain(m)
        want = run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert launched["hit_finish"] == 2
    assert bool(launched["instance_step"]) == scene.startswith("instanced")
    if scene != "dense":
        assert launched["coherence_key"] == 1 and launched["permute"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("made_by", ["upload", "refit"])
def test_gallery_key_is_one_launch_on_the_card(made_by, monkeypatch):
    """A re-sort's key on a gallery of 4 dragons (a BLAS each) beside the
    dense floor and panels, uploaded instanced on the card and refitted
    with a dragon moved past the box: one ``coherence_key`` launch and no
    aten op around it but the key's allocation (the box is the tables'),
    bit-equal to the plain key, which reduces the instance boxes."""
    _card()
    import chip_smoke

    monkeypatch.setattr(dense, "DENSE_MAX_TRIS", 500)
    scene = chip_smoke.gallery_scene(detail=12, n_dragons=4)
    tables = scene.upload("cuda", instancing=True)
    assert [g.pblas is not None for g in tables.inst.groups] == [True, False, False]
    if made_by == "refit":
        node = next(n for n in scene.iter_depth_first() if n.mesh >= 0)
        node.world_transform = node.world_transform.copy()
        node.world_transform[1, 3] += 40.0
        moved = scene.refit(tables)
        assert not torch.equal(moved.inst.box, tables.inst.box)
        tables = moved
    lo, hi = trace.root_bounds(tables)
    o, d, _, act = _rays(100_003, seed=9, lo=float(lo.min()), hi=float(hi.max()), dy=0.0)
    o, d = _v3(o, "torch"), _v3(d, "torch")
    o, d = (V3(*(c.cuda() for c in v)) for v in (o, d))
    active = torch.as_tensor(act, device="cuda")
    mode = _Ops()
    before = trace.LAUNCHES["coherence_key"]
    with mode:
        key = trace.coherence_key(tables, o, d, active)
    torch.cuda.synchronize()
    assert trace.LAUNCHES["coherence_key"] - before == 1 and mode.ops == [], mode.ops
    assert torch.equal(key, trace.coherence_key_reference(tables, o, d, active))
    assert len(torch.unique(key)) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PERM_KINDS)
@pytest.mark.parametrize("n", [1, 3, 1025, 4099, 524_287])
def test_permute_kernel_bit_equal_on_synthetic_permutations(kind, n):
    """The permutation kernel against its plain version on the card: a
    wave state's 21 columns, and columns at odd offsets (no 4- or 16-byte
    alignment), gathered, scattered and copied by each synthetic
    permutation, every lane bit-equal, each gather and scatter launched."""
    _card()
    import check_torch_trace as ctt

    dev = torch.device("cuda")
    cols = ctt._state_columns(n, dev, seed=n)
    odd = [torch.empty(n + 1, dtype=c.dtype, device=dev)[1:].copy_(c) for c in cols[12:16]]
    perm = _permutation(kind, n, seed=n + 1).to(dev)
    for cs in (cols, odd):
        before = trace.LAUNCHES["permute"]
        for mode in trace.PERMUTE_MODES:
            p = None if mode == "copy" else perm
            got = ctt._permute_out(cs, p, mode)
            want = ctt._library_out(cs, p, mode)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (mode, a.dtype)
        assert trace.LAUNCHES["permute"] == before + 2
