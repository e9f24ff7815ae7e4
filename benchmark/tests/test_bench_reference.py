"""The reference against the port at a tiny size on the CPU: the same
samples give the same uint8 pixels."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import camera, compare
from benchmark.harness import port_scene
from benchmark.reference import pathtracer
from benchmark.scenes import cornell, hall
from vulkan_raytracer_tpu_torch.render.renderer import Renderer, render_image
from vulkan_raytracer_tpu_torch.scene.camera import Camera

CASES = {"cornell": (cornell.build, [0.0, 1.0, 2.4], [0.0, 0.0, -1.0]),
         "hall": (hall.build, [-9.0, 1.8, 0.0], [1.0, 0.0, 0.0])}


@pytest.mark.parametrize("name,w,h,spp,depth", [("cornell", 16, 12, 4, 4),
                                                ("hall", 12, 8, 2, 4)])
def test_reference_renders_the_ports_batch_pixels(name, w, h, spp, depth):
    build, pos, direction = CASES[name]
    data = build()
    tables = port_scene(data).upload("cpu")
    cam = Camera(position=np.array(pos, np.float64), direction=np.array(direction, np.float64))
    img, _ = render_image(tables, cam, w, h, spp, depth, start_sample=7, as_uint8=True)
    vi, pi = camera.matrices(pos, direction, w, h)
    assert np.array_equal(vi, cam.view_inverse()) and np.array_equal(pi, cam.projection_inverse())
    scene = pathtracer.RefScene(data, "cpu")
    mean = pathtracer.pixel_means(scene, vi, pi, w, h, torch.arange(w * h), 7, spp, depth)
    ref = pathtracer.tonemap_u8(mean).numpy()
    assert compare.u8_mean_abs(img.reshape(-1, 3), ref) <= 0.01


def test_reference_renders_the_ports_progressive_frame():
    build, pos, direction = CASES["cornell"]
    data = build()
    w, h, depth, frames = 16, 12, 5, 9
    cam = Camera(position=np.array(pos, np.float64), direction=np.array(direction, np.float64))
    r = Renderer(port_scene(data).upload("cpu"), cam, w, h, depth)
    for _ in range(frames):
        img = r.draw_frame()
    vi, pi = camera.matrices(pos, direction, w, h)
    scene = pathtracer.RefScene(data, "cpu")
    mean = pathtracer.pixel_means(scene, vi, pi, w, h, torch.arange(w * h), 1, frames - 1,
                                  depth)
    ref = pathtracer.tonemap_u8(mean).numpy()
    assert compare.u8_mean_abs(img.reshape(-1, 3), ref) <= 0.01


def test_clusters_find_the_brute_force_hits():
    """The hall's clustered search against a sweep of every triangle."""
    scene = pathtracer.RefScene(hall.build(detail=8), "cpu")
    assert scene.box_lo is not None
    g = torch.Generator().manual_seed(0)
    o = torch.rand((300, 3), generator=g) * torch.tensor([18.0, 5.0, 7.0]) - torch.tensor(
        [9.0, -0.5, 3.5])
    d = pathtracer.normalize(torch.randn((300, 3), generator=g))
    t, tri, _, _ = scene.closest(o, d, pathtracer.EPS, pathtracer.INF)
    best_t = torch.full((300,), float("inf"))
    best = torch.full((300,), -1, dtype=torch.int64)
    for j in range(scene.n_tris):
        tj, _, _, hit = scene._test(o, d, torch.full((300,), j), pathtracer.EPS, pathtracer.INF)
        take = hit & (tj < best_t)
        best_t, best = torch.where(take, tj, best_t), torch.where(take, j, best)
    assert torch.equal(tri, best) and torch.equal(t, best_t)
    assert (tri >= 0).float().mean() > 0.5
