"""Headless renderer: sample waves, accumulation and the tonemapped image.

Port of :mod:`vulkan_raytracer_tpu.render.renderer` (renderer.py:34-251) for
frames of at most ``MAX_LANES_PER_PASS`` pixels: :func:`render_image` sums
``spp`` samples in waves of up to ``MAX_LANES_PER_PASS`` lanes (lane =
(pixel, sample)) in the JAX package's order — samples are grouped
``s_batch`` to a wave and the waves summed in sample order — into one
accumulation buffer updated in place.  Lanes run in the 32x32-block pixel
order of the JAX renderer and are scattered back to pixel order once.

Not ported yet: the banded renderer for larger frames and the progressive
:class:`Renderer` (ROADMAP.md Queue 1 #10 and #13).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.tonemap import reinhard_jodie
from ..scene.camera import Camera
from .integrator import render_sample

#: Max lanes (pixel samples) per wave; cfg1 (512x512, 64 spp) runs 32 waves
#: of 2 samples x 262,144 pixels.
MAX_LANES_PER_PASS = 1 << 19


@functools.lru_cache(maxsize=8)
def block_order(width: int, height: int, block: int = 32):
    """Pixel permutation grouping 32x32 image blocks into consecutive lanes
    (integrator.py:376-395).  Returns (order, inverse) numpy int32 arrays;
    cached, so callers must not mutate them."""
    idx = np.arange(width * height)
    px, py = idx % width, idx // width
    nbx = -(-width // block)
    key = ((py // block) * nbx + (px // block)) * (block * block) + (py % block) * block + (
        px % block
    )
    order = np.argsort(key, kind="stable").astype(np.int32)
    inverse = np.argsort(order, kind="stable").astype(np.int32)
    return order, inverse


def samples_per_wave(width: int, height: int, spp: int) -> int:
    """The JAX renderer's s_batch rule (renderer.py:69-71)."""
    s_batch = min(spp, max(1, MAX_LANES_PER_PASS // (width * height)))
    while spp % s_batch:
        s_batch -= 1
    return s_batch


def _render_wave(tables, view_inv, proj_inv, width, height, max_depth, samples, lanes,
                 nee_weighting):
    """One multi-sample wave: lane = (sample, pixel), samples-major.  Returns
    radiance aligned with ``lanes`` and the wave's ray count."""
    n = lanes.shape[0]
    if len(samples) == 1:
        return render_sample(tables, view_inv, proj_inv, width, height, samples[0],
                             max_depth, lane_idx=lanes, nee_weighting=nee_weighting)
    lane_t = lanes.repeat(len(samples))
    samp = torch.tensor(samples, dtype=torch.int64, device=lanes.device).repeat_interleave(n)
    radiance, rays = render_sample(tables, view_inv, proj_inv, width, height, samp, max_depth,
                                   lane_idx=lane_t, nee_weighting=nee_weighting)
    return radiance.reshape(len(samples), n, 3).sum(dim=0), rays


def _render_batch(tables, view_inv, proj_inv, width, height, max_depth, spp, start_sample,
                  nee_weighting="reference"):
    """Sum ``spp`` samples starting at ``start_sample`` in fixed wave order;
    returns ((W*H, 3) pixel-ordered sum, rays traced)."""
    n = width * height
    if n > MAX_LANES_PER_PASS:
        raise NotImplementedError(
            f"{width}x{height} exceeds {MAX_LANES_PER_PASS} pixels; the banded renderer "
            "is not ported to the torch package yet (ROADMAP.md Queue 1 #10)"
        )
    dev = tables.device
    s_batch = samples_per_wave(width, height, spp)
    lanes = torch.as_tensor(block_order(width, height)[0], device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for w0 in range(0, spp, s_batch):
        samples = [start_sample + w0 + k for k in range(s_batch)]
        radiance, r = _render_wave(tables, view_inv, proj_inv, width, height, max_depth,
                                   samples, lanes, nee_weighting)
        acc.add_(radiance)
        rays += r
    out = torch.zeros_like(acc)
    out[lanes.long()] = acc
    return out, rays


def camera_uniforms(camera: Camera):
    """CameraProperties equivalent (raytracer.h:18-20): float32 (4, 4)
    inverse view and projection matrices."""
    return (
        np.asarray(camera.view_inverse(), np.float32),
        np.asarray(camera.projection_inverse(), np.float32),
    )


def _postprocess(acc, spp, tonemap, as_uint8):
    img = acc / float(spp)
    if tonemap:
        img = reinhard_jodie(img)
    if as_uint8:
        img = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return img


def render_image(
    tables,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_depth: int = 5,
    start_sample: int = 1,
    tonemap: bool = True,
    nee_weighting: str = "reference",
    as_uint8: bool = False,
):
    """Headless render on the tables' device: returns ((H, W, 3) numpy
    array, total rays).  ``start_sample`` defaults to 1 (sample 0 is the
    preview frame and is excluded from accumulation, raygen.rgen:95-96)."""
    camera.aspect = width / height
    view_inv, proj_inv = camera_uniforms(camera)
    with torch.inference_mode():
        acc, rays = _render_batch(tables, view_inv, proj_inv, width, height, max_depth, spp,
                                  start_sample, nee_weighting=nee_weighting)
        img = _postprocess(acc, spp, tonemap, as_uint8)
        img = img.cpu().numpy().reshape(height, width, 3)
        total_rays = int(rays)
    return img, total_rays
