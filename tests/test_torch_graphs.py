"""The captured bounce of the torch port (``render/graphs.py``).

On CUDA tables of an alpha-free scene each bounce is a captured CUDA graph,
which only works if nothing in the bounce reads the device on the host.
Held here on the CPU: a ``TorchDispatchMode`` around each step of the bounce
loop (``integrator._step``: the re-sort where asked, then ``_bounce``) finds
no op that synchronises on a card — a scalar read (``_local_scalar_dense``),
an op whose output shape depends on the data (``nonzero``, a boolean index)
or a tensor made from host data (``lift_fresh``, a copy to the card) — on
the dense Cornell box, on a repacked BVH scene at the ladder's three widths
and on a small instanced gallery with a BVH and two dense prototypes.  The
kernels' wrappers count as one opaque launch each: their plain CPU versions
are not inspected.

Marked ``cuda`` (they skip without a card): graph-replayed renders against
eager ones bit for bit, with equal rays and launch counts, and a refit's
new tables capturing their own graphs.
"""

import gc
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import profile_torch_wave  # noqa: E402
from test_torch_instancing import instanced_scene  # noqa: E402
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


def _watched_steps(monkeypatch):
    """Patch ``integrator._step`` to run under :class:`HostReads`, the
    plain versions opaque, after one unwatched run of the same step (the
    eager warm-up before a capture, which builds the lazy tables); returns
    the list of (width, mode) per step."""
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
        step(tables, s, *args)
        mode = HostReads()
        current.append(mode)
        try:
            with mode:
                out = step(tables, s, *args)
        finally:
            current.pop()
        steps.append((s["active"].shape[0], mode))
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


@pytest.mark.parametrize("case", ["cornell_dense", "ladder_bvh", "gallery_instanced"])
def test_bounce_reads_nothing_on_the_host(case, monkeypatch):
    """Each step of an alpha-free wave is free of host synchronisation."""
    if case == "cornell_dense":
        tables = cornell_box_scene().upload("cpu")
        args, widths = ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0], 16, 16), {256}
    elif case == "ladder_bvh":
        tables = _open_tables()
        monkeypatch.setattr(integrator, "_repack_preferred", lambda t: True)
        args, widths = ([0.0, 1.0, 3.0], [0.0, 0.0, -1.0], 32, 32), {1024, 512, 256}
    else:
        tables = _gallery_tables(monkeypatch)
        args, widths = ([0.0, 1.2, 5.0], [0.0, -0.25, -1.0], 16, 16), {256}
        assert integrator._repack_preferred(tables)
    assert not tables.has_alpha
    steps = _watched_steps(monkeypatch)
    w, h = args[2], args[3]
    value, rays = integrator.render_sample(tables, *_uniforms(*args), w, h, 2, 4)
    assert torch.isfinite(value).all() and int(rays) > 0
    assert widths <= {n for n, _ in steps}, [n for n, _ in steps]
    assert all(mode.ops > 100 for _, mode in steps)
    found = sorted({op for _, mode in steps for op in mode.found})
    assert not found, found


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


def test_graphs_preferred_rule():
    """Graphs only on CUDA tables of scenes without alpha (a stand-in for
    CUDA tables: no card here)."""
    assert not graphs._graphs_preferred(cornell_box_scene().upload("cpu"))
    for has_alpha, want in ((False, True), (True, False)):
        stand_in = types.SimpleNamespace(device=torch.device("cuda", 0), has_alpha=has_alpha)
        assert graphs._graphs_preferred(stand_in) is want


def test_cache_is_per_tables_and_dies_with_them():
    """Each tables object has a cache of its own (a refit's new tables never
    replay the old ones' graphs), kept for as long as the tables live."""
    tables, other = cornell_box_scene().upload("cpu"), cornell_box_scene().upload("cpu")
    c = graphs.cache(tables)
    assert graphs.cache(tables) is c and graphs.cache(other) is not c
    key = id(tables)
    del tables
    gc.collect()
    assert key not in graphs._CACHES and id(other) in graphs._CACHES


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
            dict(integrator.BOUNCE_WIDTHS))


def _reset():
    dense.reset_launches()
    traverse.reset_launches()
    instanced.reset_stats()
    integrator.reset_bounce_widths()


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
@pytest.mark.parametrize("case", ["cornell_dense", "ladder_bvh", "gallery_instanced"])
def test_graphs_bit_equal_to_eager(case, monkeypatch):
    if case == "cornell_dense":
        tables = cornell_box_scene().upload("cuda")
        pos, direction = [0.0, 1.0, 2.4], [0.0, 0.0, -1.0]
    elif case == "ladder_bvh":
        tables = _open_tables("cuda")
        monkeypatch.setattr(integrator, "_repack_preferred", lambda t: True)
        pos, direction = [0.0, 1.0, 3.0], [0.0, 0.0, -1.0]
    else:
        tables = _gallery_tables(monkeypatch, "cuda")
        pos, direction = [0.0, 1.2, 5.0], [0.0, -0.25, -1.0]
    assert graphs._graphs_preferred(tables)
    graphs.reset_stats()
    runs = _render_both(tables, pos, direction, 32, 4, 4, monkeypatch)
    _, img, rays, counts = runs[0]
    for side, img_s, rays_s, counts_s in runs[1:]:
        assert np.array_equal(img_s, img), side
        assert rays_s == rays and counts_s == counts, (side, counts_s, counts)
    assert graphs.STATS["captured"] > 0
    assert graphs.STATS["replays"] == 2 * sum(counts[3].values())
    assert np.isfinite(img).all() and img.mean() > 0.0


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA card")
def test_refit_tables_capture_anew(monkeypatch):
    """A refit's tables are a new object with a cache of their own: the
    moved instance shows in the graph-replayed image as in the eager one."""
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
    assert moved is not tables and not graphs.cache(moved).graphs
    got, _ = renderer.render_image(moved, cam, 32, 32, 2, max_depth=3, tonemap=False)
    assert len(graphs.cache(moved).graphs) > 0 and len(graphs.cache(tables).graphs) == captured
    monkeypatch.setattr(graphs, "_graphs_preferred", lambda t: False)
    want, _ = renderer.render_image(moved, cam, 32, 32, 2, max_depth=3, tonemap=False)
    assert np.array_equal(got, want) and not np.array_equal(got, before)
