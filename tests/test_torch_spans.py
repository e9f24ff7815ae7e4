"""The port's spans and the live lanes of its bounces
(``utils/spans.py``, ``integrator.BOUNCE_LIVE``), and the benchmark's
readers of them.

Held here on the CPU with the stand-in graphs of
``tests/test_torch_graphs.py`` (the host-read replay of each program):

* with no profiler running, a frame enters no ``record_function``, makes no
  CUDA event and keeps no launch;
* under a CPU ``torch.profiler`` session, ``render_image`` (whole and
  banded) and three pipelined ``Renderer.draw_frame`` calls name their
  host path in spans nested as ``utils/spans.py`` documents, every span of
  a frame carrying that frame's number;
* the live lanes entering each bounce, counted by the eager loop's reads
  and by the replay's tests, agree on the Cornell box and on a repacked
  scene, a bounce 0 lets its whole width in and no width takes more lanes
  than it ran;
* each reader of ``benchmark/metrics`` on a hand-made record and store, and
  None outside its mode or on a port without the store.

Marked ``cuda`` (they skip without a card): a frame program's event-timed
launches against the profiler's device extent of the same launches, and
the device rows' live lanes against the eager loop's on the same frame.
"""

import gc
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_torch_graphs as tg  # noqa: E402
from benchmark.spec import Spec  # noqa: E402
from vulkan_raytracer_tpu_torch.render import graphs, integrator, renderer  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene  # noqa: E402
from vulkan_raytracer_tpu_torch.scene.camera import Camera  # noqa: E402
from vulkan_raytracer_tpu_torch.utils import spans  # noqa: E402

W = H = 32
CAM = ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0])  # bench cfg1
_SPAN = re.compile(r"^([a-z_.]+)#(\d+)$")

#: each span -> the span it sits in (None: the frame's own span, ``frame``,
#: which sits in the harness's ``render_image`` or ``draw_frame``)
PARENTS = {
    "whole": {"plan": None, "camera": None, "wave": None, "program.bind": "wave",
              "program.launch": "wave", "fetch": None, "settle": None},
    "banded": {"plan": None, "camera": None, "band": None, "wave": "band",
               "program.bind": "wave", "program.launch": "wave", "image": None, "fetch": None,
               "settle": None},
    "progressive": {"plan": None, "camera": None, "program.bind": None,
                    "program.launch": None, "fetch": None, "present_wait": None},
}


def _cam():
    return Camera(position=np.array(CAM[0]), direction=np.array(CAM[1]))


def _frames(tables, plan: str, wrap) -> None:
    """Three frames of ``plan`` (32x32, depth 3), each inside ``wrap``,
    the harness's ``record_function`` around a frame."""
    if plan == "progressive":
        player = renderer.Renderer(tables, _cam(), W, H, 3)
        for _ in range(3):
            with wrap("draw_frame"):
                player.draw_frame(pipeline=True)
        return
    for i in range(3):
        with wrap("render_image"):
            renderer.render_image(tables, _cam(), W, H, 2, max_depth=3, start_sample=1 + 2 * i,
                                  as_uint8=True)


def _setup(plan: str, monkeypatch):
    """Cornell tables with stand-in programs; ``banded`` lowers the cap so
    a 32x32 frame at 2 spp renders in 3 bands."""
    gc.collect()  # no cache of an earlier test's tables of the signature
    tables = cornell_box_scene().upload("cpu")
    tg._plain_calls(monkeypatch)
    tg._stand_in_programs(monkeypatch)
    if plan == "banded":
        monkeypatch.setattr(renderer, "MAX_LANES_PER_PASS", 700)
        assert renderer._banded_preferred(tables, W, H, 2)
    graphs.reset_stats()
    return tables


@pytest.mark.parametrize("plan", ["whole", "banded", "progressive"])
def test_spans_off_record_nothing(plan, monkeypatch):
    """Without a profiler session a frame's sites are the null context: no
    ``record_function`` is entered, no CUDA event made, no launch kept."""
    tables = _setup(plan, monkeypatch)

    def forbidden(*args, **kw):
        raise AssertionError("a span or an event was made with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    _frames(tables, plan, lambda name: spans.span(name))
    assert not spans._on and spans.launches() == []
    assert spans.timed(None) is spans.span("wave") is spans._NULL


@pytest.mark.parametrize("plan", ["whole", "banded", "progressive"])
def test_spans_nest_as_documented(plan, monkeypatch):
    """Under a CPU profiler session each frame names its host path in the
    spans ``utils/spans.py`` lists, each inside the span it belongs to
    (the frame's own span ``frame`` inside the harness's ``render_image``
    or ``draw_frame``), all of a frame with one number, one number a frame;
    the first frame fills the mirror (``program.bind``) and captures; the
    host-read replay launches nothing on a card, so no launch is timed."""
    tables = _setup(plan, monkeypatch)
    top = "draw_frame" if plan == "progressive" else "render_image"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _frames(tables, plan, torch.profiler.record_function)
    assert not spans._on and spans.launches() == []
    frames = [e for e in prof.events() if e.name == top]
    assert len(frames) == 3
    by_frame = {}  # the harness's frame event -> [(start, span, number)]
    for e in prof.events():
        m = _SPAN.match(e.name)
        if m is None:
            continue
        name, number = m.group(1), int(m.group(2))
        assert name in PARENTS[plan] or name == "frame", e.name
        parent, want = e.cpu_parent, PARENTS[plan].get(name)
        want = top if name == "frame" else f"{want or 'frame'}#{number}"
        assert parent is not None and parent.name == want, (e.name, parent and parent.name)
        while parent.cpu_parent is not None:
            parent = parent.cpu_parent
        assert parent.name == top
        by_frame.setdefault(parent.id, []).append((e.time_range.start, name, number))
    groups = sorted(sorted(g) for g in by_frame.values())
    numbers = [g[0][2] for g in groups]
    assert len(groups) == 3 and all(n == g[0][2] for g in groups for _, _, n in g)
    assert numbers == list(range(numbers[0], numbers[0] + 3))
    assert all([name for _, name, _ in g].count("frame") == 1 for g in groups)
    first, *later = [[name for _, name, _ in g if name != "frame"] for g in groups]
    assert "program.bind" in first and all("program.bind" not in n for n in later)
    if plan == "progressive":
        assert first == ["plan", "camera", "program.bind", "program.launch", "fetch"]
        assert all(n == ["plan", "camera", "program.launch", "fetch", "present_wait"]
                   for n in later)
    elif plan == "whole":
        assert later[0] == ["plan", "camera", "wave", "program.launch", "fetch", "settle"]
    else:
        n = later[0]
        assert n[:2] == ["plan", "camera"] and n[-3:] == ["image", "fetch", "settle"]
        assert n.count("band") == 3 and n.count("wave") == n.count("program.launch") == 3


@pytest.mark.parametrize("case", ["cornell_dense", "ladder_bvh"])
def test_bounce_live_replay_equals_eager(case, monkeypatch):
    """``integrator.BOUNCE_LIVE``: the live lanes the replay's bounce tests
    let through equal the eager loop's reads, width by width; at depth 0 a
    frame's one bounce a wave lets every lane in, and at depth 3 no width
    took more live lanes than its width times its bounces, and the full
    width at least its bounce 0's."""
    tables, (pos, direction, w, h), _ = tg._case(case, monkeypatch)
    cam = Camera(position=np.array(pos), direction=np.array(direction))
    tg._plain_calls(monkeypatch)

    def frame(depth):
        integrator.reset_counters()
        renderer.render_image(tables, cam, w, h, 2, max_depth=depth, tonemap=False)
        return dict(integrator.BOUNCE_LIVE), dict(integrator.BOUNCE_WIDTHS)

    want = {depth: frame(depth) for depth in (0, 3)}
    tg._stand_in_programs(monkeypatch)
    got = {depth: frame(depth) for depth in (0, 3)}
    assert got == want
    n = w * h * 2  # one wave of 2 samples
    assert want[0] == ({n: n}, {n: 1})
    live, widths = want[3]
    assert set(live) <= set(widths) and live[n] >= n
    assert all(live[k] <= k * widths[k] for k in live)
    if case == "ladder_bvh":  # the ladder stepped: lanes died
        assert len(widths) > 1 and sum(live.values()) < sum(k * c for k, c in widths.items())


# ---------------------------------------------------------------------------
# The benchmark's readers
# ---------------------------------------------------------------------------


def _reader(name):
    return Spec().reader(name)


def _run(mode, rendered=2, widths=None):
    return {"mode": mode, "rendered": rendered, "frames": rendered,
            "bounce_widths": {100: 4, 50: 2} if widths is None else widths}


@pytest.mark.parametrize("mode", ["batch", "progressive"])
def test_program_and_gap_readers(mode, monkeypatch):
    """``program_ms``: the launches' lengths summed over the frames
    rendered; ``launch_gap_ms``: the mean gap between launches times the
    launches over the frames; None in the other mode, with no launch kept
    (or one, for the gap), or on a port without ``utils/spans.py``."""
    other = "progressive" if mode == "batch" else "batch"
    store = [(1, 0.0, 3.0), (1, 4.0, 6.0), (2, 7.5, 9.5)]  # gaps 1.0 and 1.5
    monkeypatch.setattr(spans, "launches", lambda: list(store))
    program, gap = _reader(f"program_ms.{mode}"), _reader(f"launch_gap_ms.{mode}")
    assert program(_run(mode)) == pytest.approx(7.0 / 2)
    assert gap(_run(mode)) == pytest.approx(1.25 * 3 / 2)
    assert program(_run(other)) is None and gap(_run(other)) is None
    assert program(_run(mode, rendered=0)) is None
    store[1:] = []
    assert program(_run(mode)) == pytest.approx(1.5) and gap(_run(mode)) is None
    store.clear()
    assert program(_run(mode)) is None and gap(_run(mode)) is None
    store.append((1, 0.0, 1.0))
    monkeypatch.setitem(sys.modules, "vulkan_raytracer_tpu_torch.utils.spans", None)
    monkeypatch.delattr(sys.modules["vulkan_raytracer_tpu_torch.utils"], "spans")
    assert program(_run(mode)) is None and gap(_run(mode)) is None


@pytest.mark.parametrize("mode", ["batch", "progressive"])
def test_bounce_live_reader(mode, monkeypatch):
    """``bounce_live_pct``: 100 x the live lanes over width x bounces; None
    in the other mode, with nothing counted, or on a port without
    ``integrator.BOUNCE_LIVE``."""
    other = "progressive" if mode == "batch" else "batch"
    read = _reader(f"bounce_live_pct.{mode}")
    monkeypatch.setattr(integrator, "BOUNCE_LIVE", {100: 300, 50: 50})
    assert read(_run(mode)) == pytest.approx(100.0 * 350 / 500)
    assert read(_run(other)) is None and read(_run(mode, widths={})) is None
    monkeypatch.setattr(integrator, "BOUNCE_LIVE", {})
    assert read(_run(mode)) is None
    monkeypatch.delattr(integrator, "BOUNCE_LIVE")
    assert read(_run(mode)) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_launch_events_match_the_profiler():
    """A 512x512 Cornell frame program of 8 spp at depth 4, launched three
    times alone under the profiler, each launch behind a spin of the card
    so the stream is busy while the host launches: each launch's
    event-timed length lies within 5% of the profiler's device extent of
    the same launch (its kernels' first start to last end, the spin
    aside)."""
    dev = _card()
    # CUPTI misses reruns of a conditional body's nodes in programs
    # instantiated before the first profiler session (benchmark/harness.py)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)
    gc.collect()
    tables = cornell_box_scene().upload(dev)
    renderer.render_image(tables, _cam(), 512, 512, 8, max_depth=4, as_uint8=True)
    program, = graphs.cache(tables).graphs.values()
    graphs.reset_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            torch.cuda.synchronize(dev)
            with torch.profiler.record_function("launch"), spans.frame:
                torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock
                program.launch(device_loops=True)
            torch.cuda.synchronize(dev)
    graphs.settle()
    launches = spans.launches()
    assert len(launches) == 3 and len({f for f, _, _ in launches}) == 3
    hosts = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == "launch" and e.device_type == DeviceType.CPU)
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
               and not getattr(e, "is_user_annotation", False)]
    assert len(hosts) == 3
    bounds = [lo for lo, _ in hosts] + [float("inf")]
    for (_, start, end), lo, hi in zip(launches, bounds, bounds[1:]):
        inside = [k for k in kernels if lo <= k[0] < hi]  # the card waited before the next
        extent_ms = (max(e for _, e in inside) - min(s for s, _ in inside)) / 1e3
        assert abs((end - start) - extent_ms) <= 0.05 * extent_ms, (end - start, extent_ms)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell_dense", "ladder_bvh"])
def test_bounce_live_device_rows_equal_eager(case, monkeypatch):
    """The live lanes the device loops' tests counted into their rows equal
    the eager loop's reads on the same 2 spp frame at depth 4, width by
    width (the Cornell box, and the ladder scene's three widths)."""
    dev = _card()
    gc.collect()
    tables, (pos, direction, w, h), _ = tg._case(case, monkeypatch, device=dev)
    cam = Camera(position=np.array(pos), direction=np.array(direction))
    got = {}
    for side in ("program", "eager"):
        with monkeypatch.context() as m:
            if side == "eager":
                m.setattr(graphs, "_graphs_preferred", lambda t: False)
            integrator.reset_counters()
            renderer.render_image(tables, cam, w, h, 2, max_depth=4, tonemap=False)
            got[side] = dict(integrator.BOUNCE_LIVE), dict(integrator.BOUNCE_WIDTHS)
    assert got["program"] == got["eager"]
    assert got["program"][0][w * h * 2] >= w * h * 2
