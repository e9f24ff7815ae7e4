"""The captured wave of the torch port (``render/graphs.py``).

On CUDA tables a wave, from its initial state to its radiance, is one
program: its straight code captured as CUDA graphs (parts), its bounce
loop, the width ladder's phases and the alpha resample loops as conditional
WHILE nodes and its re-sorts as IF nodes, whose conditions a hand-written
kernel sets on the card.  That only works if no part reads the device on
the host.  Held here on the CPU with stand-in graphs (``_Recorded``: a
capture runs the code once and records its aten ops, each kernel's plain
version as one call, as a launch on the card; a replay runs them again on
the same tensors): a ``TorchDispatchMode`` around the whole-wave capture
finds no op that synchronises on a card — a scalar read
(``_local_scalar_dense``), an op whose output shape depends on the data
(``nonzero``, a boolean index) or a tensor made from host data
(``lift_fresh``, a copy to the card) — on the dense Cornell box, on a
repacked BVH scene (the ladder's three phases), on a small instanced
gallery with a BVH and two dense prototypes, and with alpha on the
textured glb, on the same glb on the BVH path and on an instanced alpha
scene; the program's tree has the shape the module documents.  The
host-read replay, the plain version of the device loops, runs the stand-in
program with a device bounce index ``b``: images, rays, bounce widths, the
alpha loop's counts and the plain versions' calls bit-equal to the eager
loop, the counts coming from each part's captured counts times the runs of
its body.  Its reads (one a test of a condition) and the fold of the
device loops' rows (:func:`graphs.settle`) are held on scripted parts.
The cache is keyed by the tables' signature, as ``jit`` keys by shapes,
and a wave with other tables of the signature copies them into the cache's
mirror: the signature and the mirror are held here too.

Marked ``cuda`` (they skip without a card): renders through the device
loops against the host-read replay and eager ones bit for bit, with equal
rays and counters, with alpha and without, and a refit's new tables
replaying the programs already captured while the old tables still render
the old scene.
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
from vulkan_raytracer_tpu_torch.ops import dense, instanced, trace, traverse, wave  # noqa: E402
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
          (traverse, "treelet_walk_reference"), (traverse, "emissive_pdf_walk_reference"),
          (wave, "primary_rays_reference"), (wave, "alpha_commit_reference")]


def _synchronises(func, args) -> bool:
    if func in _INDEX_OPS:  # a boolean index is a nonzero inside
        return any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1] if i is not None)
    return (func in _HOST_DATA or torch.Tag.data_dependent_output in func.tags
            or torch.Tag.dynamic_output_shape in func.tags)


class HostReads(TorchDispatchMode):
    """Every op that would make the card wait for the host or the host for
    the card (none while ``paused``)."""

    def __init__(self):
        super().__init__()
        self.found = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and _synchronises(func, args):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def _outside_launches(monkeypatch, mode: HostReads) -> None:
    """Pause ``mode`` while a program launches: on the CPU a launch is the
    host-read replay, whose condition reads and plain versions stand for
    what the card does inside a wave."""
    launch = graphs._Program.launch

    def paused(self, *args, **kw):
        mode.paused += 1
        try:
            return launch(self, *args, **kw)
        finally:
            mode.paused -= 1

    monkeypatch.setattr(graphs._Program, "launch", paused)


def _write(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _write(d, s)
    elif isinstance(dst, dict):
        for k, d in dst.items():
            _write(d, src[k])


class _Recorded(TorchDispatchMode):
    """A CUDA graph on the CPU.  "Capturing" runs the code once and records
    its aten ops, each kernel's plain version as one call (a launch on the
    card, :func:`_plain_calls`); a replay runs them again on the same
    tensors and writes each op's result into the tensors the capture's run
    made, as a graph's kernels write the addresses they were captured with.
    Views and uninitialised allocations are not run again."""

    active: list = []  # the recordings in progress, innermost last

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = 0

    def capture_begin(self, pool=None):
        self.__enter__()
        _Recorded.active.append(self)

    def capture_end(self):
        _Recorded.active.remove(self)
        self.__exit__(None, None, None)

    def nodes(self) -> int:
        return len(self.ops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            self.ops.append((func, args, kwargs, out))
        return out

    def replay(self):
        for fn, args, kwargs, out in self.ops:
            if isinstance(fn, torch._ops.OpOverload):
                if fn.is_view or fn._schema.name.startswith("aten::empty"):
                    continue
                if fn._schema.is_mutable:
                    fn(*args, **kwargs)
                    continue
            _write(out, fn(*args, **kwargs))


#: calls of each kernel's plain version, counted as a launch counter
PLAIN_CALLS: dict = {}


def _plain_calls(monkeypatch):
    """Patch each kernel's plain version into one opaque call: counted in
    :data:`PLAIN_CALLS` (added to the integrator's counters, so a program
    folds it as it folds the launch counters) and recorded by a
    :class:`_Recorded` as one call rather than its ops (a card runs the
    kernel there, and the plain version's loops end on the data)."""
    PLAIN_CALLS.clear()
    monkeypatch.setattr(integrator, "_COUNTERS", (*integrator._COUNTERS, PLAIN_CALLS))
    for mod, name in _PLAIN:
        fn = getattr(mod, name)

        def call(*args, _fn=fn, _name=name, **kw):
            PLAIN_CALLS[_name] = PLAIN_CALLS.get(_name, 0) + 1
            rec = _Recorded.active[-1] if _Recorded.active else None
            if rec is not None:
                rec.paused += 1
            try:
                out = _fn(*args, **kw)
            finally:
                if rec is not None:
                    rec.paused -= 1
            if rec is not None:
                rec.ops.append((_fn, args, kw, out))
            return out

        monkeypatch.setattr(mod, name, call)


def _stand_in_programs(monkeypatch):
    """Waves on CPU tables as programs of :class:`_Recorded` parts, run by
    the host-read replay (the device loops need a card): patches
    ``graphs._graphs_preferred`` on and the part's graph type (after
    :func:`_plain_calls`).  Returns the list of (width, capture) of each
    whole-wave capture, filled as they happen."""
    assert PLAIN_CALLS in integrator._COUNTERS
    monkeypatch.setattr(graphs, "_graphs_preferred", lambda t: True)
    monkeypatch.setattr(graphs, "_TorchGraph", _Recorded)
    captures = []
    build = integrator._wave_program

    def watched(tables, io, cap, **kw):
        captures.append((io["lanes"].shape[0] * io["samples"].shape[0], cap))
        return build(tables, io, cap, **kw)

    monkeypatch.setattr(integrator, "_wave_program", watched)
    return captures


def _parts(nodes):
    for node in nodes:
        if isinstance(node, graphs._Part):
            yield node
        else:
            yield from _parts(node.body)


def _host_reads(nodes) -> tuple:
    """(aten ops, the ops among them that would synchronise on a card) the
    parts of a stand-in program recorded, the plain versions' calls aside."""
    ops = [(op, args) for part in _parts(nodes) for op, args, _, _ in part.graph.ops
           if isinstance(op, torch._ops.OpOverload)]
    return len(ops), sorted({str(op) for op, args in ops if _synchronises(op, args)})


def _shape(nodes) -> str:
    """A program's tree as text: ``p`` a part, ``kind:role(body)`` a node."""
    return " ".join("p" if isinstance(n, graphs._Part) else f"{n.kind}:{n.role}({_shape(n.body)})"
                    for n in nodes)


def _want_shape(tables, n: int) -> str:
    """The tree ``render/graphs.py`` documents for a wave of ``n`` lanes."""
    bounce = "p while:alpha(p) p while:alpha(p) p" if tables.has_alpha else "p"
    repack = integrator._repack_preferred(tables)
    phase = f"while:phase({'if:sort(p) ' if repack else ''}{bounce})"
    if repack and n % 4 == 0:
        return f"p {phase} if:sort(p) p {phase} if:sort(p) p {phase} p"
    return f"p {phase} p"


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
    """A whole wave, captured, is free of host synchronisation, its bounces
    and resample loops included, and its program has the documented tree: a
    WHILE per phase (the ladder's three on a repacked wave, the re-sorts as
    IFs) and, with alpha, a WHILE per resample loop inside the bounce."""
    tables, args, widths = _case(case, monkeypatch)
    assert tables.has_alpha == (case in ALPHA_CASES)
    _plain_calls(monkeypatch)
    captures = _stand_in_programs(monkeypatch)
    w, h = args[2], args[3]
    integrator.reset_bounce_widths()
    value, rays = integrator.render_sample(tables, *_uniforms(*args), w, h, 2, 4)
    assert torch.isfinite(value).all() and int(rays) > 0
    (n, cap), = captures
    ops, found = _host_reads(cap.nodes)
    assert n == w * h and ops > 100 and not found, found
    assert _shape(cap.nodes) == _want_shape(tables, n)
    loops = [node.role for node in cap.conds if node.kind == "while"]
    phases = 3 if integrator._repack_preferred(tables) and n % 4 == 0 else 1
    assert loops.count("phase") == phases
    assert loops.count("alpha") == (2 * phases if tables.has_alpha else 0)
    assert widths <= set(integrator.BOUNCE_WIDTHS), integrator.BOUNCE_WIDTHS


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
        trace.lanes(1e-7, 8, x.device)
    assert not mode.found, mode.found


class _Scripted:
    """A part's graph whose replay runs ``fn``."""

    def __init__(self, fn):
        self.replay = fn


def _scripted_program(counter: dict, done: list):
    """A program of scripted parts: ``phase`` WHILE live > 0 and b <= 2 {
    pending = b + 1; WHILE pending { pending -= 1 }; b += 1; live -= 1 },
    after a part that sets b = 0 and live = 5."""
    b = torch.zeros((), dtype=torch.int32)
    live = torch.zeros((), dtype=torch.int64)
    pending = torch.zeros((), dtype=torch.int64)

    def part(fn, delta):
        return graphs._Part(_Scripted(fn), [delta])

    phase = graphs._Node("while", graphs.Cond(live, 0, b, 2), 0, "phase")
    loop = graphs._Node("while", graphs.Cond(pending), 1, "alpha", lambda *a: done.append(a))
    loop.body = [part(lambda: pending.sub_(1), {"pass": 1})]
    phase.body = [part(lambda: pending.copy_(b + 1), {"seg": 1}), loop,
                  part(lambda: (b.add_(1), live.sub_(1)), {"seg": 10})]
    nodes = [part(lambda: (b.zero_(), live.fill_(5)), {"init": 1}), phase]
    return graphs._Program(nodes, [phase, loop], {"active": torch.zeros(1, dtype=torch.bool)},
                           (), [counter])


def test_replay_reads_one_count_a_pass():
    """The host-read replay of a program: each part once per run of its
    body; a node's condition read on the host at each test, before its first
    run and after each (the count, and ``b`` where the count passes); a
    resample loop's passes counted per call (calls, passes, the most in one
    call); each part's counts times the runs of its body; the rows kept as
    ``loop_cond_kernel`` keeps them; no ``loop_cond_kernel`` launch."""
    counter, done = {}, []
    program = _scripted_program(counter, done)
    graphs.reset_stats()
    with HostReads() as mode:
        program.launch(device_loops=False)
    # b = 0, 1, 2 run the phase; the resample loop then runs 1, 2, 3 passes
    assert counter == {"init": 1, "seg": 3 * 11, "pass": 1 + 2 + 3}
    assert done == [(6, 3, 3)]
    assert graphs.STATS["passes"] == 6 and graphs.STATS["replays"] == 3
    assert graphs.STATS["launches"] == 1 and graphs.LAUNCHES["loop_cond"] == 0
    # 4 phase tests (count and b), 2 + 3 + 4 resample tests (the count)
    assert mode.found == ["aten._local_scalar_dense.default"] * (4 * 2 + 2 + 3 + 4)
    rows = [[0, 0, 0, 0] for _ in program.conds]
    program.interpret(program.nodes, rows)
    assert rows == [[3, 1, 3, 3], [6, 3, 3, 3]]


def test_settle_folds_the_device_rows():
    """A program launched on the card counts nothing on the host until
    :func:`graphs.settle`: one read of the scalars asked for with every
    pending program's rows, whose counts it adds (each part's counts times
    the runs of its body over the launches since the last settle;
    ``loop_cond_kernel``'s launches: every entry test and every WHILE
    body's closing test), and the rows start again from 0."""
    counter, done = {}, []
    program = _scripted_program(counter, done)
    graphs.reset_stats()
    # two launches' worth of the rows the card keeps (test_replay_reads_one_count_a_pass)
    program.stats.copy_(torch.tensor([[6, 2, 3, 3], [12, 6, 3, 3]]))
    program.pending = 2
    graphs._PENDING[program] = None
    assert counter == {}
    assert graphs.settle(torch.tensor(7), torch.tensor(8)) == [7, 8]
    assert counter == {"init": 2, "seg": 6 * 11, "pass": 12} and done == [(12, 6, 3)]
    assert graphs.LAUNCHES["loop_cond"] == (2 + 6) + (6 + 12)
    assert graphs.STATS["launches"] == 2 and graphs.STATS["replays"] == 6
    assert not program.stats.any() and program.pending == 0 and not graphs._PENDING
    assert graphs.settle() == [] and counter["pass"] == 12
    # a launch whose bounce loop ran no body: the top level counts, no 0 appears
    other = {}
    program = _scripted_program(other, done)
    program.stats.copy_(torch.tensor([[0, 1, 0, 0], [0, 0, 0, 0]]))
    program.pending = 1
    graphs._PENDING[program] = None
    assert graphs.settle() == [] and other == {"init": 1}


@pytest.mark.parametrize("case", ["cornell_dense", "ladder_bvh", "gallery_instanced",
                                  *ALPHA_CASES])
def test_stand_in_program_bit_equal_to_eager(case, monkeypatch):
    """``render_image`` at 32x32, 2 spp, depth 3 (one wave) as the host-read
    replay of a stand-in program, with the bounce index on the device,
    against the eager loop: images and rays bit-equal, and the bounce
    widths, the alpha loop's calls, passes and most passes a call, the
    instance steps and the plain versions' calls equal, the program's from
    each part's captured counts times the runs of its body.  One program a
    wave shape, keyed without a bounce; the second frame captures nothing."""
    gc.collect()  # no cache of an earlier test's tables of the signature
    tables, (pos, direction, _, _), _ = _case(case, monkeypatch)
    cam = Camera(position=np.array(pos), direction=np.array(direction))
    _plain_calls(monkeypatch)

    def frame():
        _reset()
        PLAIN_CALLS.clear()
        graphs.reset_stats()
        img, rays = renderer.render_image(tables, cam, 32, 32, 2, max_depth=3, tonemap=False)
        return img, rays, (_counts(), dict(PLAIN_CALLS))

    img, rays, counts = frame()
    assert sum(counts[1].values()) > 0
    assert (counts[0][3]["calls"] > 0) == tables.has_alpha
    _stand_in_programs(monkeypatch)
    for captured in (1, 0):
        got = frame()
        assert np.array_equal(got[0], img) and got[1] == rays
        assert got[2] == counts, (got[2], counts)
        assert graphs.STATS["captured"] == captured and graphs.STATS["launches"] == 1
        assert graphs.STATS["replays"] == sum(integrator.BOUNCE_WIDTHS.values())
        assert graphs.STATS["passes"] == integrator.ALPHA_LOOP["iterations"]
    programs = graphs.cache(tables).graphs
    repack = integrator._repack_preferred(tables)
    # (pixels, samples, width, height, pixel order, depth, NEE weighting, repack)
    assert list(programs) == [(1024, 2, 32, 32, False, 3, "reference", repack)]
    program, = programs.values()
    assert list(program.io) == ["samples", "lanes", "cam", "sum", "rays"]


@pytest.mark.parametrize("plan", ["whole", "banded"])
def test_render_lanes_reads_nothing_inside_its_waves(plan, monkeypatch):
    """``render_lanes`` over stand-in programs makes no tensor of host data
    and reads nothing back inside its wave loops (the camera, its one
    tensor of host data, goes to the device once, a band's lanes device to
    device, a wave's sample numbers by an ``arange`` there; the launches,
    the host-read replay here, aside): whole (32x32, 2 spp: one wave of 2 samples),
    and banded under a lowered cap (32x32, 10 spp: chunks of 8 + 2 over
    12 bands of 86 pixels, the last a ragged 78: four programs).  Its sum and rays are the
    eager loop's bit for bit, and a second frame captures nothing."""
    gc.collect()
    tables = cornell_box_scene().upload("cpu")
    vi, pi = _uniforms([0.0, 1.0, 2.4], [0.0, 0.0, -1.0], 32, 32)
    spp, kw = (2, {}) if plan == "whole" else (10, {"max_lanes": 700, "banded": True})
    lanes = integrator.block_lanes(32, 32, torch.device("cpu"))

    def frame():
        return renderer.render_lanes(tables, vi, pi, 32, 32, 3, spp, 1, lanes, **kw)

    _plain_calls(monkeypatch)
    want = frame()
    _stand_in_programs(monkeypatch)
    graphs.reset_stats()
    first = frame()
    captured = graphs.STATS["captured"]
    mode = HostReads()
    _outside_launches(monkeypatch, mode)
    with mode:
        got = frame()
    # the frame's one tensor of host data: its camera, copied once
    assert mode.found == ["aten.lift_fresh.default"], mode.found
    assert graphs.STATS["captured"] == captured == (1 if plan == "whole" else 4)
    for other in (first, got):
        assert torch.equal(other[0], want[0]) and int(other[1]) == int(want[1])
        assert other[2:] == want[2:]
    assert want[2:] == ((0, 1) if plan == "whole" else (12, 24))


@pytest.mark.parametrize("case", ["cornell_dense", "ladder_bvh"])
def test_progressive_frame_through_the_program(case, monkeypatch):
    """The progressive ``_frame_step`` (the preview frame, then two samples)
    through a stand-in program bit-equal to eager: one sample of the whole
    frame, on the repacked scene in block order with its radiance back in
    pixel order; the sample number written on the device; no host read
    in a frame outside its launch, and no tensor of host data but its
    camera."""
    gc.collect()
    tables, (pos, direction, _, _), _ = _case(case, monkeypatch)
    vi, pi = _uniforms(pos, direction, 32, 32)

    def frames():
        accum = torch.zeros((32 * 32, 3))
        return [renderer._frame_step(tables, vi, pi, 32, 32, accum, 3, 32, 32, k)
                for k in range(3)], accum

    _plain_calls(monkeypatch)
    want = frames()
    captures = _stand_in_programs(monkeypatch)
    got = frames()
    mode = HostReads()
    _outside_launches(monkeypatch, mode)
    with mode:
        again = frames()
    assert mode.found == ["aten.lift_fresh.default"] * 3, mode.found  # each frame's camera
    for frames_, accum in (got, again):
        assert torch.equal(accum, want[1]) and float(accum.sum()) > 0.0
        for (img, rays), (img_w, rays_w) in zip(frames_, want[0]):
            assert torch.equal(img, img_w) and int(rays) == int(rays_w)
    (n, _), = captures
    repack = integrator._repack_preferred(tables)
    assert n == 32 * 32
    assert list(graphs.cache(tables).graphs) == [(1024, 1, 32, 32, repack, 3, "reference",
                                                  repack)]


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
    assert torch.equal(stream.wide, t1.em_stream.wide)  # the wide nodes' refitted boxes
    assert "em_table" not in vars(mirror) and "em_table" not in vars(t1)
    assert torch.equal(t0.v0.x, v0_was) and not torch.equal(t1.v0.x, v0_was)
    derived = [table, stream.nodes, stream.rows, stream.wide]
    assert c.mirror_bytes() == nbytes + sum(t.numel() * t.element_size() for t in derived)
    assert graphs.STATS["copy_bytes"] == 2 * nbytes + c.mirror_bytes() - nbytes


@pytest.mark.parametrize("replayed", ["all", "one_missing"])
def test_traced_launches_are_held_against_the_counters(replayed):
    """The check that shows a replay launched what its capture counted: every
    launch counter maps to a hand-written kernel the trace names, and a trace
    short of one launch fails."""
    counters = {k: n for d in integrator.launch_counts().values() for k, n in d.items()}
    assert set(profile_torch_wave.KERNEL_OF) == set(counters)
    assert set(profile_torch_wave.KERNEL_OF.values()) == set(profile_torch_wave.PORT_KERNELS)
    counted = dict.fromkeys(counters, 0)
    counted.update(closest=5, shadow=5, pdf=10, treelet_closest=320, treelet_shadow=320, hit=5,
                   scatter=5, resolve=5)
    traced = {"closest_kernel": 5, "shadow_kernel": 5, "pdf_kernel": 10,
              "treelet_walk_kernel": 640, "shade_hit_kernel": 5, "shade_scatter_kernel": 5,
              "shade_resolve_kernel": 5}
    if replayed == "all":
        got = profile_torch_wave.check_traced_launches(
            {"port_kernel_launches": traced}, counted, "gallery graphs")
        assert got == traced
    else:
        traced["treelet_walk_kernel"] -= 1
        with pytest.raises(AssertionError, match="the counters say"):
            profile_torch_wave.check_traced_launches(
                {"port_kernel_launches": traced}, counted, "gallery graphs")


@pytest.mark.parametrize("traced", ["within", "missing", "more"])
def test_device_trace_is_held_within_the_counters(traced):
    """A run through the device loops: CUPTI misses most reruns of a
    conditional body's nodes, so its trace may hold fewer launches than the
    counters, but every kernel counted must appear and none more often than
    counted."""
    counted = {k: 0 for d in integrator.LAUNCH_COUNTERS.values() for k in d}
    counted.update(treelet_closest=10, treelet_shadow=10, pdf=10, loop_cond=40)
    trace = {"treelet_walk_kernel": 4, "pdf_kernel": 2, "loop_cond_kernel": 9}
    if traced == "within":
        got = profile_torch_wave.check_device_trace(
            {"port_kernel_launches": trace}, counted, "cfg2 device")
        assert got == {"treelet_walk_kernel": [4, 20], "pdf_kernel": [2, 10],
                       "loop_cond_kernel": [9, 40]}
        return
    if traced == "missing":
        del trace["pdf_kernel"]
    else:
        trace["pdf_kernel"] = 11
    with pytest.raises(AssertionError, match="the counters say"):
        profile_torch_wave.check_device_trace({"port_kernel_launches": trace}, counted,
                                              "cfg2 device")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _counts():
    """(launches by module, instance steps, bounce widths, alpha loop)."""
    return (integrator.launch_counts(loops=False), dict(instanced.STATS),
            dict(integrator.BOUNCE_WIDTHS), dict(integrator.ALPHA_LOOP))


def _reset():
    integrator.reset_counters()  # the device loops' counts so far folded in first


#: side -> (graphs._graphs_preferred, graphs._device_loops_preferred) patched in
_SIDES = {"device": (graphs._graphs_preferred, graphs._device_loops_preferred),
          "replay": (graphs._graphs_preferred, lambda t: False),
          "eager": (lambda t: False, lambda t: False)}


def _render_sides(tables, pos, direction, size, spp, depth, monkeypatch):
    """``render_image`` through the device loops, the host-read replay and
    eager, in turns (device, replay, eager, eager, replay, device): (side,
    image, rays, counters) of each run."""
    cam = Camera(position=np.array(pos), direction=np.array(direction))
    out = []
    for side in ("device", "replay", "eager", "eager", "replay", "device"):
        graphs_rule, loops_rule = _SIDES[side]
        monkeypatch.setattr(graphs, "_graphs_preferred", graphs_rule)
        monkeypatch.setattr(graphs, "_device_loops_preferred", loops_rule)
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
    the alpha loop's passes bit-equal, the device loops against the
    host-read replay and eager; with alpha, the textured glb (K1), the same
    glb on the BVH path (K4'), the instanced alpha scene and the
    147,136-triangle glb (K5', repacked).  One program a wave shape; the
    device sides launch ``loop_cond_kernel``."""
    if case == "gltf_147k":
        tables, (pos, direction) = _glb_tables("cuda", big=True), BIGASSET
        assert integrator._repack_preferred(tables)
    else:
        tables, (pos, direction, _, _), _ = _case(case, monkeypatch, "cuda")
    assert graphs._graphs_preferred(tables) and graphs._device_loops_preferred(tables)
    graphs.settle()
    graphs.reset_stats()
    runs = _render_sides(tables, pos, direction, 32, 4, 4, monkeypatch)
    _, img, rays, counts = runs[0]
    for side, img_s, rays_s, counts_s in runs[1:]:
        assert np.array_equal(img_s, img), side
        assert rays_s == rays and counts_s == counts, (side, counts_s, counts)
    assert graphs.STATS["captured"] == len(graphs.cache(tables).graphs) == 1
    assert graphs.STATS["replays"] == 4 * sum(counts[2].values())
    assert (counts[3]["calls"] > 0) == tables.has_alpha
    assert graphs.STATS["passes"] == 4 * counts[3]["iterations"]
    assert graphs.LAUNCHES["loop_cond"] > 0
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
