"""The window's arithmetic: whole frames only, a p95 over all intervals,
the idle union of overlapping intervals."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, window
from benchmark.spec import Spec


def test_percentile_is_the_nearest_rank_over_all_values():
    values = list(range(1, 101))  # 1..100
    assert window.percentile(values, 95) == 95
    assert window.percentile(values[::-1], 95) == 95
    assert window.percentile([3.0], 95) == 3.0
    assert window.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 100], 95) == 100


def test_union_counts_overlaps_once():
    assert window.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert window.union_seconds([]) == 0.0
    assert window.gaps([(0, 2), (1, 3), (5, 6)], 0, 8) == [(3, 5), (6, 8)]


def test_readers_take_rates_over_the_whole_window():
    spec = Spec()
    run = dict(mode="batch", frames=4, pixels=100, spp=8, window_s=2.0, intervals=[],
               setup_s=1.5)
    assert spec.reader("Msamples_per_s")(run) == pytest.approx(4 * 100 * 8 / 2.0 / 1e6)
    assert spec.reader("frames_per_s")(run) is None
    prog = dict(mode="progressive", frames=5, window_s=0.5,
                intervals=[0.1, 0.1, 0.1, 0.3], setup_s=1.0)
    assert spec.reader("frames_per_s")(prog) == pytest.approx(10.0)
    assert spec.reader("frame_ms_p95")(prog) == pytest.approx(300.0)
    assert spec.reader("Msamples_per_s")(prog) is None
    trace = dict(mode="batch", frames=2, rendered=2, busy_s=0.9, trace_window_s=1.0,
                 kernel_seconds={"shade.cu": 0.4, "bvh_walk.cu": 0.2})
    assert spec.reader("device_idle_pct.batch")(trace) == pytest.approx(10.0)
    assert spec.reader("kernel_ms.shade.batch")(trace) == pytest.approx(200.0)
    assert spec.reader("kernel_ms.traverse.batch")(trace) == pytest.approx(100.0)
    assert spec.reader("kernel_ms.traverse.progressive")(trace) is None
    assert spec.reader("kernel_ms.shade.batch")(dict(trace, kernel_seconds={})) is None
    # a traced progressive window of 200 calls handed out 199 frames and
    # holds the device work of 200: per-frame readings divide by 200
    prog_trace = dict(trace, mode="progressive", frames=199, rendered=200,
                      bounce_widths={1000: 6, 500: 2})
    assert spec.reader("kernel_ms.shade.progressive")(prog_trace) == pytest.approx(2.0)
    assert spec.reader("bounce_Mlanes.progressive")(prog_trace) == pytest.approx(7000 / 200 / 1e6)


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_batch_window_ends_on_a_whole_frame(tiny_root, monkeypatch):
    """Frames of 0.3 s on a fake clock and a 1 s window: four whole frames
    over 1.2 s, not a fraction of the fourth."""
    from vulkan_raytracer_tpu_torch.render import renderer

    clock = _Clock()
    real = renderer.render_image
    calls = []

    def timed(*args, **kw):
        out = real(*args, **kw)
        clock.now += 0.3
        calls.append(clock.now)
        return out

    monkeypatch.setattr(renderer, "render_image", timed)
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    result = harness.run("tiny_cornell.batch", 5, 1.0, False, root=tiny_root, device="cpu",
                         started=clock.now)
    assert result["correct"] and result["attempted"] == 4
    work = 4 * 16 * 12 * 4
    assert result["metrics"]["Msamples_per_s"]["value"] == pytest.approx(work / 1.2 / 1e6)


def test_progressive_p95_is_over_every_interval(tiny_root, monkeypatch):
    from vulkan_raytracer_tpu_torch.render import renderer

    clock = _Clock()
    real = renderer.Renderer.draw_frame
    steps = iter(np.tile([0.01] * 19 + [0.05], 50))

    def timed(self, *args, **kw):
        out = real(self, *args, **kw)
        clock.now += float(next(steps))
        return out

    monkeypatch.setattr(renderer.Renderer, "draw_frame", timed)
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    result = harness.run("tiny_cornell.progressive", 5, 1.0, False, root=tiny_root,
                         device="cpu", started=clock.now)
    assert result["correct"]
    # one interval in twenty is 50 ms: the 95th percentile is 10 ms, the
    # 96th would be 50
    assert result["metrics"]["frame_ms_p95"]["value"] == pytest.approx(10.0)
    assert result["metrics"]["frames_per_s"]["value"] == pytest.approx(
        result["attempted"] / (clock.now - 100.0 - 0.0), rel=0.05)
