"""The captured bounce of the torch port (``render/graphs.py``).

On CUDA tables each bounce is captured as CUDA graphs: one for a scene
without alpha; on a scene with alpha a segment up to each resample loop of
``integrator._closest``, one graph for a pass of the loop, and a last
segment.  That only works if nothing in a segment or a pass reads the
device on the host.  Held here on the CPU: a ``TorchDispatchMode`` around
each step of the bounce loop (``integrator._step``: the re-sort where
asked, then ``_bounce``), run as ``GraphCache`` captures it with stand-in
graphs that run the code once, finds no op that synchronises on a card —
a scalar read (``_local_scalar_dense``), an op whose output shape depends
on the data (``nonzero``, a boolean index) or a tensor made from host data
(``lift_fresh``, a copy to the card) — on the dense Cornell box, on a
repacked BVH scene at the ladder's three widths, on a small instanced
gallery with a BVH and two dense prototypes, and with alpha on the
textured glb, on the same glb on the BVH path and on an instanced alpha
scene.  The kernels' wrappers count as one opaque launch each: their plain
CPU versions are not inspected.  A replay's own reads (one pending count a
pass, the occlusion loop's first count being the next live count) are held
on stand-in parts.  The cache is keyed by the tables' signature, as
``jit`` keys by shapes, and a step with other tables of the signature
copies them into the cache's mirror: the signature and the mirror are held
here too.

Marked ``cuda`` (they skip without a card): graph-replayed renders against
eager ones bit for bit, with equal rays and counters, with alpha and
without, and a refit's new tables replaying the graphs already captured
while the old tables still render the old scene.
"""

import dataclasses
import gc
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import profile_torch_wave  # noqa: E402
import torch_glb_assets  # noqa: E402
from test_torch_instancing import alpha_instanced_scene, instanced_scene  # noqa: E402
from vulkan_raytracer_tpu_torch.ops import dense, instanced, traverse  # noqa: E402
from vulkan_raytracer_tpu_torch.render import graphs, integrator, renderer  # noqa: E402
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.camera import Camera  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.procedural import sky_hdr  # noqa: E402

aten = torch.ops.aten
_INDEX_OPS = {aten.index.Tensor, aten.index_put.default, aten.index_put_.default,
              aten._index_put_impl_.default}
_HOST_DATA = {aten.lift_fresh.default, aten.lift_fresh_copy.default}
#: the kernels' plain versions, which a card never runs on the main path
_PLAIN = [(dense, "closest_sweep_reference"), (dense, "shadow_sweep_reference"),
          (dense, "pdf_sweep_reference"), (traverse, "bvh_walk_reference"),
          (traverse, "treelet_walk_reference"), (traverse, "emissive_pdf_walk_reference")]


def _synchronises(func, args) -> bool:
    if func in _INDEX_OPS:  # a boolean index is a nonzero inside
        return any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1] if i is not None)
    return (func in _HOST_DATA or torch.Tag.data_dependent_output in func.tags
            or torch.Tag.dynamic_output_shape in func.tags)


class HostReads(TorchDispatchMode):
    """Every op that would make the card wait for the host or the host for
    the card, outside the kernels' plain versions (``opaque``)."""

    def __init__(self):
        super().__init__()
        self.opaque = 0
        self.ops = 0
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.opaque:
            self.ops += 1
            if _synchronises(func, args):
                self.found.append(str(func))
        return func(*args, **(kwargs or {}))


class _StandIn:
    """A CUDA graph on the CPU: "capturing" runs the code once, eagerly."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass


def _watched_steps(monkeypatch):
    """Patch ``integrator._step``: after one unwatched run of the step (the
    eager warm-up before a capture, which builds the lazy tables), the step
    again as ``GraphCache`` captures it, its resample loops split into parts
    by a ``graphs._Capture`` of stand-in graphs, under :class:`HostReads`
    with the plain versions opaque.  The render goes on with the unwatched
    run's state, and the watched run's counts are dropped.  Returns the
    list of (width, mode, parts) per step."""
    steps = []
    step = integrator._step
    current = []

    def opaque(fn):
        def call(*args, **kw):
            mode = current[-1] if current else None
            if mode is not None:
                mode.opaque += 1
            try:
                return fn(*args, **kw)
            finally:
                if mode is not None:
                    mode.opaque -= 1
        return call

    for mod, name in _PLAIN:
        monkeypatch.setattr(mod, name, opaque(getattr(mod, name)))

    def watched(tables, s, *args):
        out = step(tables, s, *args)
        kept = graphs._snapshot(integrator._COUNTERS)
        cap = graphs._Capture(None, integrator._COUNTERS, graph=_StandIn)
        mode = HostReads()
        current.append(mode)
        try:
            with graphs.capturing(cap), mode:
                cap.begin()
                step(tables, s, *args)
                cap.end()
        finally:
            current.pop()
            graphs._restore(integrator._COUNTERS, kept)
        steps.append((s["active"].shape[0], mode, cap.parts))
        return out

    monkeypatch.setattr(integrator, "_step", watched)
    return steps


def _uniforms(pos, direction, w, h):
    cam = Camera(position=np.array(pos), direction=np.array(direction), aspect=w / h)
    return renderer.camera_uniforms(cam)


def _gallery_tables(monkeypatch, device="cpu"):
    """tests/test_torch_instancing.py's gallery with 3 soup instances: the
    120-triangle soup walks its own BLAS (the dense cap lowered to 64 for the
    upload), the floor and the panels take the dense sweeps."""
    with monkeypatch.context() as m:
        m.setattr(dense, "DENSE_MAX_TRIS", 64)
        tables = instanced_scene(tsg, n_soup_instances=3).upload(device, instancing=True)
    groups = tables.inst.groups
    assert groups[0].pblas is not None and all(g.table is not None for g in groups[1:])
    return tables


def _open_tables(device="cpu"):
    """tests/test_torch_repack.py's width-ladder scene: the Cornell box under
    a sky, on BVH streams."""
    s = cornell_box_scene()
    s.skybox = sky_hdr(h=16, w=32)
    s.skybox_strength = 1.0
    return s.upload(device, traversal="bvh")


def _glb_tables(device="cpu", traversal="auto", big=False):
    """The textured glb of tests/test_textured_glb.py (12 triangles, MASK and
    BLEND, textures), or the 147,136-triangle glb of
    tests/test_bigasset_glb.py, written by tools/torch_glb_assets.py."""
    scene = tsg.Scene()
    with tempfile.TemporaryDirectory() as tmp:
        if big:
            scene.load_model(torch_glb_assets.write_bigasset_glb(tmp, big=True))
        else:
            scene.load_model(torch_glb_assets.write_textured_glb(tmp))
    return scene.upload(device, traversal=traversal)


TEXTURED = ([0.0, 0.0, 2.8], [0.0, 0.0, -1.0])  # tests/test_textured_glb.py:245
BIGASSET = ([0.0, 1.7, 4.6], [0.0, -0.28, -1.0])  # tests/test_bigasset_glb.py:324
ALPHA_CASES = ("textured_glb", "alpha_bvh", "alpha_instanced")


def _case(case, monkeypatch, device="cpu"):
    """(tables, (camera position, direction, width, height), widths the
    steps must run at) of a test scene."""
    if case == "cornell_dense":
        return cornell_box_scene().upload(device), ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0], 16, 16), {
            256}
    if case == "ladder_bvh":
        monkeypatch.setattr(integrator, "_repack_preferred", lambda t: True)
        return _open_tables(device), ([0.0, 1.0, 3.0], [0.0, 0.0, -1.0], 32, 32), {
            1024, 512, 256}
    if case == "gallery_instanced":
        tables = _gallery_tables(monkeypatch, device)
        assert integrator._repack_preferred(tables)
        return tables, ([0.0, 1.2, 5.0], [0.0, -0.25, -1.0], 16, 16), {256}
    if case in ("textured_glb", "alpha_bvh"):
        tables = _glb_tables(device, "bvh" if case == "alpha_bvh" else "auto")
        assert (tables.pbvh is not None) == (case == "alpha_bvh")
        return tables, (*TEXTURED, 16, 16), {256}
    scene, cam = alpha_instanced_scene()
    tables = scene.upload(device, instancing=True)
    return tables, (list(cam.position), list(cam.direction), 16, 16), {256}


@pytest.mark.parametrize("case", ["cornell_dense", "ladder_bvh", "gallery_instanced",
                                  *ALPHA_CASES])
def test_bounce_reads_nothing_on_the_host(case, monkeypatch):
    """Each step of a wave, captured, is free of host synchronisation: one
    part without alpha; with alpha a segment, the bounce ray's pass, a
    segment, the occlusion ray's pass and a last segment, none of which
    reads the device on the host."""
    tables, args, widths = _case(case, monkeypatch)
    assert tables.has_alpha == (case in ALPHA_CASES)
    steps = _watched_steps(monkeypatch)
    w, h = args[2], args[3]
    value, rays = integrator.render_sample(tables, *_uniforms(*args), w, h, 2, 4)
    assert torch.isfinite(value).all() and int(rays) > 0
    assert widths <= {n for n, _, _ in steps}, [n for n, _, _ in steps]
    assert all(mode.ops > 100 for _, mode, _ in steps)
    found = sorted({op for _, mode, _ in steps for op in mode.found})
    assert not found, found
    for _, _, parts in steps:
        loops = [(p.loop.first, p.loop.live) for p in parts if p.loop is not None]
        if tables.has_alpha:
            assert [p.loop is not None for p in parts] == [False, True, False, True, False]
            assert loops == [(True, False), (False, True)]
        else:
            assert len(parts) == 1 and not loops


def test_host_reads_sees_a_synchronisation():
    """The mode's own check: each kind of op it must catch."""
    x = torch.arange(8.0)
    for fn in (lambda: int(x.sum()), lambda: x[x > 3], lambda: torch.nonzero(x),
               lambda: torch.as_tensor(1e-7, dtype=torch.float32)):
        with HostReads() as mode:
            fn()
        assert mode.found, fn
    with HostReads() as mode:
        torch.where(x > 3, x, 0.0)[torch.arange(2)]
        dense._lanes(1e-7, 8, x.device)
    assert not mode.found, mode.found


class _Scripted:
    """A part's graph whose replay runs ``fn``."""

    def __init__(self, fn):
        self.replay = fn


def test_replay_reads_one_count_a_pass():
    """A program's replay: each segment once; a loop's pass while its count
    of pending lanes is not 0, read on the host after each pass, before the
    first only where the loop does not start on known live lanes; the
    occlusion loop's first count comes back as the next live count.  Each
    replay adds its part's counts, and the passes are counted per loop."""
    a = torch.zeros((), dtype=torch.int64)
    b = torch.zeros((), dtype=torch.int64)
    done = []
    parts = [
        graphs._Part(_Scripted(lambda: a.fill_(3)), [{"seg": 1}], None),
        graphs._Part(_Scripted(lambda: a.sub_(1)), [{"pass": 1}],
                     graphs._Loop(a, True, False, done.append, None)),
        graphs._Part(_Scripted(lambda: b.fill_(2)), [{"seg": 1}], None),
        graphs._Part(_Scripted(lambda: b.sub_(1)), [{"pass": 10}],
                     graphs._Loop(b, False, True, done.append, None)),
        graphs._Part(_Scripted(lambda: None), [{"seg": 1}], None),
    ]
    counter = {}
    graphs.reset_stats()
    with HostReads() as mode:
        live = graphs._Program(parts, None, None).replay([counter])
    assert done == [3, 2] and live == 2
    assert counter == {"seg": 3, "pass": 3 + 2 * 10}
    assert graphs.STATS["passes"] == 5
    # one read a pass, and the occlusion loop's first: the next live count
    assert mode.found == ["aten._local_scalar_dense.default"] * 6


def test_graphs_preferred_rule():
    """Graphs on CUDA tables, with alpha or without (a stand-in for CUDA
    tables: no card here); never on CPU tables."""
    assert not graphs._graphs_preferred(cornell_box_scene().upload("cpu"))
    for has_alpha in (False, True):
        stand_in = types.SimpleNamespace(device=torch.device("cuda", 0), has_alpha=has_alpha)
        assert graphs._graphs_preferred(stand_in) is True
    stand_in = types.SimpleNamespace(device=torch.device("cpu"), has_alpha=False)
    assert graphs._graphs_preferred(stand_in) is False


def test_cache_is_per_tables_and_dies_with_them():
    """Tables of one signature share a cache (a refit's tables replay the
    graphs captured before it), other tables have their own, and a cache
    lives as long as a tables object of its signature does."""
    tables, same = cornell_box_scene().upload("cpu"), cornell_box_scene().upload("cpu")
    other = cornell_box_scene().upload("cpu", traversal="bvh")
    c = graphs.cache(tables)
    assert graphs.cache(same) is c and graphs.cache(other) is not c and c.users == 2
    sig = graphs.signature(tables)
    del tables
    gc.collect()
    assert graphs._CACHES[sig] is c and c.users == 1
    del same
    gc.collect()
    assert sig not in graphs._CACHES and graphs.signature(other) in graphs._CACHES


def _move(scene, node, dx):
    node.local_transform = node.local_transform.copy()
    node.local_transform[0, 3] += dx
    for n in scene.iter_depth_first():
        if n.parent is not None:
            n.world_transform = (n.parent.world_transform @ n.local_transform).astype(np.float32)


@pytest.mark.parametrize("instancing", [False, True])
def test_refit_keeps_the_signature(instancing, monkeypatch):
    """A refit changes the tables' values, never what a bounce branches on:
    flattened on the BVH path (the streams rebuilt with the upload's cut)
    and instanced (a BLAS and dense prototypes)."""
    with monkeypatch.context() as m:
        m.setattr(dense, "DENSE_MAX_TRIS", 64)
        scene = instanced_scene(tsg, n_soup_instances=3)
        tables = scene.upload("cpu", instancing=instancing,
                              traversal="auto" if instancing else "bvh")
    assert (tables.inst is not None) == instancing and (tables.pbvh is None) == instancing
    _move(scene, scene.root.children[0], 0.4)
    moved = scene.refit(tables)
    assert graphs.signature(moved) == graphs.signature(tables)
    assert graphs.cache(moved) is graphs.cache(tables)
    changed = [a for a, b in zip(graphs._tensors(moved), graphs._tensors(tables))
               if not torch.equal(a, b)]
    assert changed


@pytest.mark.parametrize("change", ["topology", "traversal", "instancing"])
def test_signature_changes_with(change):
    """Another triangle count, another traversal or another instancing is
    another program: a cache of its own."""
    base = instanced_scene(tsg, n_soup_instances=3).upload("cpu", instancing=False)
    if change == "topology":
        other = instanced_scene(tsg, n_soup_instances=4).upload("cpu", instancing=False)
    elif change == "traversal":
        other = instanced_scene(tsg, n_soup_instances=3).upload("cpu", instancing=False,
                                                                 traversal="bvh")
    else:
        other = instanced_scene(tsg, n_soup_instances=3).upload("cpu", instancing=True)
    same = instanced_scene(tsg, n_soup_instances=3).upload("cpu", instancing=False)
    assert graphs.signature(same) == graphs.signature(base)
    assert graphs.signature(other) != graphs.signature(base)
    assert graphs.cache(other) is not graphs.cache(base)


def _dataclass_types(x, seen=None) -> set:
    seen = set() if seen is None else seen
    if isinstance(x, tuple):
        for c in x:
            _dataclass_types(c, seen)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        seen.add(type(x))
        for f in dataclasses.fields(x):
            _dataclass_types(getattr(x, f.name), seen)
    return seen


def test_mirror_holds_the_bound_tables_and_their_derived_tables():
    """The mirror is a copy of the tables a step ran with last.  Another
    tables object of the signature is copied in once, with the tables a
    bounce derives on first use (``SceneTables``' cached properties) built
    on it, never on the mirror, so no stale geometry replays; derived tables
    the mirror never built are neither built nor copied; the old tables are
    left as they were.  No other dataclass of the tables derives a table."""
    scene = cornell_box_scene()
    t0 = scene.upload("cpu")
    assert [t for t in _dataclass_types(t0) if graphs._derived(t.__new__(t))] == [type(t0)]
    assert set(graphs._derived(t0)) == {"tri_table", "em_table", "em_stream"}
    v0_was = t0.v0.x.clone()
    c = graphs.cache(t0)
    graphs.reset_stats()
    mirror = c.bind(t0)
    nbytes = sum(t.numel() * t.element_size() for t in graphs._tensors(t0))
    assert graphs.STATS["copies"] == 1 and graphs.STATS["copy_bytes"] == nbytes
    for m, t in zip(graphs._tensors(mirror), graphs._tensors(t0)):
        assert torch.equal(m, t) and m.data_ptr() != t.data_ptr()
    table, stream = mirror.tri_table, mirror.em_stream  # as a capture's warm-up builds them
    for node in scene.root.children:
        _move(scene, node, 0.3)
    t1 = scene.refit(t0)
    assert graphs.cache(t1) is c
    assert c.bind(t1) is mirror and graphs.STATS["copies"] == 2
    assert c.bind(t1) is mirror and graphs.STATS["copies"] == 2  # once per change of tables
    for m, t in zip(graphs._tensors(mirror), graphs._tensors(t1)):
        assert torch.equal(m, t)
    assert mirror.tri_table is table and mirror.em_stream is stream  # copied into
    assert torch.equal(table, t1.tri_table) and not torch.equal(table, t0.tri_table)
    assert torch.equal(stream.rows, t1.em_stream.rows)
    assert "em_table" not in vars(mirror) and "em_table" not in vars(t1)
    assert torch.equal(t0.v0.x, v0_was) and not torch.equal(t1.v0.x, v0_was)
    derived = [table, stream.nodes, stream.rows]
    assert c.mirror_bytes() == nbytes + sum(t.numel() * t.element_size() for t in derived)
    assert graphs.STATS["copy_bytes"] == 2 * nbytes + c.mirror_bytes() - nbytes


@pytest.mark.parametrize("replayed", ["all", "one_missing"])
def test_traced_launches_are_held_against_the_counters(replayed):
    """The check that shows a replay launched what its capture counted: every
    launch counter maps to a hand-written kernel the trace names, and a trace
    short of one launch fails."""
    counters = {**dense.LAUNCHES, **traverse.LAUNCHES}
    assert set(profile_torch_wave.KERNEL_OF) == set(counters)
    assert set(profile_torch_wave.KERNEL_OF.values()) == set(profile_torch_wave.PORT_KERNELS)
    counted = dict.fromkeys(counters, 0)
    counted.update(closest=5, shadow=5, pdf=10, treelet_closest=320, treelet_shadow=320)
    traced = {"closest_kernel": 5, "shadow_kernel": 5, "pdf_kernel": 10,
              "treelet_walk_kernel": 640}
    if replayed == "all":
        got = profile_torch_wave.check_traced_launches(
            {"port_kernel_launches": traced}, counted, "gallery graphs")
        assert got == traced
    else:
        traced["treelet_walk_kernel"] -= 1
        with pytest.raises(AssertionError, match="the counters say"):
            profile_torch_wave.check_traced_launches(
                {"port_kernel_launches": traced}, counted, "gallery graphs")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _counts():
    return (dict(dense.LAUNCHES), dict(traverse.LAUNCHES), dict(instanced.STATS),
            dict(integrator.BOUNCE_WIDTHS), dict(integrator.ALPHA_LOOP))


def _reset():
    dense.reset_launches()
    traverse.reset_launches()
    instanced.reset_stats()
    integrator.reset_bounce_widths()
    integrator.reset_alpha_loop()


def _render_both(tables, pos, direction, size, spp, depth, monkeypatch):
    """``render_image`` replayed from graphs and eager, in turns (graphs,
    eager, eager, graphs): (image, rays, counters) of each run."""
    cam = Camera(position=np.array(pos), direction=np.array(direction))
    rule = graphs._graphs_preferred
    out = []
    for side in ("graphs", "eager", "eager", "graphs"):
        monkeypatch.setattr(graphs, "_graphs_preferred",
                            rule if side == "graphs" else (lambda t: False))
        _reset()
        img, rays = renderer.render_image(tables, cam, size, size, spp, max_depth=depth,
                                          tonemap=False)
        out.append((side, img, rays, _counts()))
    return out


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA card")
@pytest.mark.parametrize("case", ["cornell_dense", "ladder_bvh", "gallery_instanced",
                                  *ALPHA_CASES, "gltf_147k"])
def test_graphs_bit_equal_to_eager(case, monkeypatch):
    """Images, rays, launches per kernel, instance steps, bounce widths and
    the alpha loop's passes bit-equal, graphs against eager; with alpha, the
    textured glb (K1), the same glb on the BVH path (K4'), the instanced
    alpha scene and the 147,136-triangle glb (K5', repacked)."""
    if case == "gltf_147k":
        tables, (pos, direction) = _glb_tables("cuda", big=True), BIGASSET
        assert integrator._repack_preferred(tables)
    else:
        tables, (pos, direction, _, _), _ = _case(case, monkeypatch, "cuda")
    assert graphs._graphs_preferred(tables)
    graphs.reset_stats()
    runs = _render_both(tables, pos, direction, 32, 4, 4, monkeypatch)
    _, img, rays, counts = runs[0]
    for side, img_s, rays_s, counts_s in runs[1:]:
        assert np.array_equal(img_s, img), side
        assert rays_s == rays and counts_s == counts, (side, counts_s, counts)
    assert graphs.STATS["captured"] > 0
    assert graphs.STATS["replays"] == 2 * sum(counts[3].values())
    assert (counts[4]["calls"] > 0) == tables.has_alpha
    assert graphs.STATS["passes"] == 2 * counts[4]["iterations"]
    assert np.isfinite(img).all() and img.mean() > 0.0


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA card")
def test_refit_tables_capture_anew(monkeypatch):
    """A refit's tables have the signature of the tables before it: their
    frame replays the graphs already captured (none captured anew) and is
    the eager frame of the new tables bit for bit, and the old tables still
    render their own image bit for bit."""
    scene = instanced_scene(tsg, n_soup_instances=3)
    cam = Camera(position=np.array([0.0, 1.2, 5.0]), direction=np.array([0.0, -0.25, -1.0]))
    tables = scene.upload("cuda", instancing=True)
    before, _ = renderer.render_image(tables, cam, 32, 32, 2, max_depth=3, tonemap=False)
    captured = len(graphs.cache(tables).graphs)
    assert captured > 0
    node = next(n for n in scene.iter_depth_first() if n.mesh == 0)
    node.world_transform = node.world_transform.copy()
    node.world_transform[0, 3] += 0.4
    moved = scene.refit(tables)
    assert moved is not tables and graphs.cache(moved) is graphs.cache(tables)
    graphs.reset_stats()
    got, _ = renderer.render_image(moved, cam, 32, 32, 2, max_depth=3, tonemap=False)
    assert graphs.STATS["captured"] == 0 and graphs.STATS["replays"] > 0
    assert graphs.STATS["copies"] == 1 and len(graphs.cache(moved).graphs) == captured
    again, _ = renderer.render_image(tables, cam, 32, 32, 2, max_depth=3, tonemap=False)
    assert graphs.STATS["captured"] == 0 and graphs.STATS["copies"] == 2
    assert np.array_equal(again, before)
    monkeypatch.setattr(graphs, "_graphs_preferred", lambda t: False)
    want, _ = renderer.render_image(moved, cam, 32, 32, 2, max_depth=3, tonemap=False)
    assert np.array_equal(got, want) and not np.array_equal(got, before)
