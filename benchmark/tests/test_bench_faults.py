"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and a run whose timed path is broken
underneath, each under the committed limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.spec import Spec


@pytest.mark.parametrize("cell", ["tiny_cornell.batch", "tiny_hall.batch",
                                  "tiny_cornell.progressive"])
def test_control_fails_the_limit(tiny_root, cell):
    spec = Spec(tiny_root)
    limit = spec.limits(cell)["u8_mean_abs"]
    for seed in (1, 2, 3):
        value = control.reading(spec, cell, seed, 12, torch.device("cpu"), torch.bfloat16)
        assert value > limit, (seed, value, limit)
    assert control.reading(spec, cell, 1, 12, torch.device("cpu"), torch.float32) == 0.0


def _run(root, cell, seconds=0.5):
    return harness.run(cell, 11, seconds, False, root=root, device="cpu", log=lambda *a: None)


def test_sound_runs_pass(tiny_root):
    for cell in ("tiny_cornell.batch", "tiny_hall.batch", "tiny_cornell.progressive"):
        assert _run(tiny_root, cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny_cornell.batch", "tiny_hall.batch"])
def test_batch_frame_that_returns_its_state_unchanged_fails(tiny_root, monkeypatch, cell):
    from vulkan_raytracer_tpu_torch.render import renderer

    real, first = renderer.render_image, []

    def stuck(*args, **kw):
        out = real(*args, **kw)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(renderer, "render_image", stuck)
    result = _run(tiny_root, cell, seconds=3.0)
    assert result["attempted"] >= 2 and not result["correct"]


@pytest.mark.parametrize("cell", ["tiny_cornell.batch", "tiny_hall.batch"])
def test_batch_frame_of_half_its_samples_fails(tiny_root, monkeypatch, cell):
    from vulkan_raytracer_tpu_torch.render import renderer

    real = renderer.render_image

    def half(tables, camera, width, height, spp, *args, **kw):
        return real(tables, camera, width, height, spp // 2, *args, **kw)

    monkeypatch.setattr(renderer, "render_image", half)
    assert not _run(tiny_root, cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny_cornell.batch", "tiny_hall.batch"])
def test_batch_answer_altered_where_it_is_made_fails(tiny_root, monkeypatch, cell):
    from vulkan_raytracer_tpu_torch.render import renderer

    real = renderer.render_image

    def shifted(*args, **kw):
        img, rays = real(*args, **kw)
        return np.roll(img, 1, axis=1), rays

    monkeypatch.setattr(renderer, "render_image", shifted)
    assert not _run(tiny_root, cell)["correct"]


def test_progressive_frame_that_keeps_its_state_fails(tiny_root, monkeypatch):
    from vulkan_raytracer_tpu_torch.render import renderer

    real, kept = renderer.Renderer.draw_frame, {}

    def stuck(self, *args, **kw):
        out = real(self, *args, **kw)
        if out is not None and self.sample_count >= 4:
            kept.setdefault(id(self), out)
            return kept[id(self)]
        return out

    monkeypatch.setattr(renderer.Renderer, "draw_frame", stuck)
    assert not _run(tiny_root, "tiny_cornell.progressive")["correct"]


def test_progressive_mean_over_half_the_samples_fails(tiny_root, monkeypatch):
    from vulkan_raytracer_tpu_torch.ops import wave

    real = wave.frame_progressive

    def half(radiance, accum, sample, *args, **kw):
        if isinstance(sample, int) and sample > 0:
            radiance = radiance * 2.0 if sample % 2 == 0 else torch.zeros_like(radiance)
        return real(radiance, accum, sample, *args, **kw)

    monkeypatch.setattr(wave, "frame_progressive", half)
    assert not _run(tiny_root, "tiny_cornell.progressive")["correct"]


def test_progressive_answer_altered_where_it_is_made_fails(tiny_root, monkeypatch):
    from vulkan_raytracer_tpu_torch.render import renderer

    real = renderer.Renderer.draw_frame

    def shifted(self, *args, **kw):
        out = real(self, *args, **kw)
        return None if out is None else np.roll(out, 1, axis=1)

    monkeypatch.setattr(renderer.Renderer, "draw_frame", shifted)
    assert not _run(tiny_root, "tiny_cornell.progressive")["correct"]


@pytest.mark.cuda
def test_cell_on_the_card(tiny_root, card):
    result = harness.run("tiny_cornell.batch", 5, 0.5, False, root=tiny_root, device="cuda")
    assert result["correct"] and result["device"]["platform"] == "gpu"
