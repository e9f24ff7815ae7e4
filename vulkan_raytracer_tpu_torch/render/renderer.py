"""Renderer: sample waves, progressive accumulation and the tonemapped image.

Port of :mod:`vulkan_raytracer_tpu.render.renderer`.  Two entry points, as
there: :class:`Renderer` is progressive, one sample per
:meth:`Renderer.draw_frame`, like the reference's render loop
(raytracer.cpp:501-535); :func:`render_image` is the headless batch.

:func:`render_image` (renderer.py:34-251) sums ``spp`` samples in waves of up to
``MAX_LANES_PER_PASS`` lanes (lane = (pixel, sample)) into one accumulation
buffer on the device, updated in place.  Lanes run in the 32x32-block pixel
order of the JAX renderer and are scattered back to pixel order once.

Both are :func:`render_lanes` over the whole block order (the shards of
``parallel/sharding.py`` run it over their runs of it):

* A frame of at most ``MAX_LANES_PER_PASS`` pixels renders whole (the JAX
  ``_render_batch``): samples are grouped ``s_batch`` to a wave and the
  waves summed in sample order, as in the JAX package.
* A larger frame renders in bands (the JAX ``_render_batch_banded`` :137):
  consecutive slices of the block order,
  each traced ``SPP_CHUNK`` samples to a wave, with the JAX band arithmetic
  (:func:`band_plan`), a ragged last band and no padded lanes, so the rays
  traced are the JAX renderer's.  The JAX renderer fetches every (band,
  chunk) to the host and reads its chunk size from ``VKRT_SPP_CHUNK``, both
  for a TPU worker fault (:115-117); here the sum stays on the device and
  the chunk is the constant 8.

Below the cap, :func:`render_image` bands a frame all the same where the
JAX rule prefers it (:func:`_banded_preferred`, renderer.py:173-196): a
flattened scene on the repacked wavefront whose frame cannot hold
``min(spp, SPP_CHUNK)`` samples in one wave traces more samples of fewer
pixels per wave, which packs the coherence re-sort's bins tighter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tonemap import reinhard_jodie
from ..scene.camera import Camera
from . import graphs, integrator
from .integrator import Waves, block_lanes, render_sample
from .integrator import block_order  # noqa: F401  (the sharded renderer's import)

#: Max lanes (pixel samples) per wave; cfg1 (512x512, 64 spp) runs 32 waves
#: of 2 samples x 262,144 pixels.
MAX_LANES_PER_PASS = 1 << 19
#: Samples per wave of the banded renderer (``default_spp_chunk``, :126).
SPP_CHUNK = 8

#: The last :func:`render_image` call: its ``waves`` and, for a banded
#: render, its ``bands`` (0 for a frame rendered whole).
LAST_RENDER = {"bands": 0, "waves": 0}


def samples_per_wave(lanes: int, spp: int) -> int:
    """The JAX renderer's s_batch rule (renderer.py:69-71) for a wave over
    ``lanes`` pixels: the most samples, dividing ``spp``, that keep the wave
    within ``MAX_LANES_PER_PASS`` lanes (at least one)."""
    s_batch = min(spp, max(1, MAX_LANES_PER_PASS // lanes))
    while spp % s_batch:
        s_batch -= 1
    return s_batch


def _render_wave(tables, view_inv, proj_inv, width, height, max_depth, samples, lanes,
                 nee_weighting):
    """One multi-sample wave on its own, as :func:`render_lanes` runs it
    (tools and tests): the consecutive ``samples`` of the pixel ``lanes``.
    Returns (the radiance summed over the samples, aligned with ``lanes``;
    the wave's rays), tensors of their own."""
    first, k = samples[0], len(samples)
    if list(samples) != list(range(first, first + k)):
        raise ValueError(f"a wave's samples are consecutive, not {list(samples)}")
    waves = Waves(tables, view_inv, proj_inv, width, height, max_depth, nee_weighting)
    waves.band(lanes)
    waves.run(first, k)
    return waves.sum.clone(), waves.rays.clone()


def band_plan(width: int, height: int, spp: int):
    """The JAX band arithmetic (renderer.py:145-154) for a frame: (samples
    per wave, pixels per band, bands)."""
    return _band_plan(width * height, spp, MAX_LANES_PER_PASS)


def _band_plan(lanes: int, spp: int, max_lanes: int):
    """(samples per wave, pixels per band, bands) of ``lanes`` pixels: each
    wave traces one band's pixels x ``min(spp, SPP_CHUNK)`` samples, at most
    ``max_lanes`` lanes; the last band may be shorter."""
    spp_chunk = min(spp, SPP_CHUNK)
    n_bands = -(-lanes * spp_chunk // max_lanes)
    per = -(-lanes // n_bands)
    return spp_chunk, per, -(-lanes // per)


def render_lanes(tables, view_inv, proj_inv, width, height, max_depth, spp, start_sample,
                 lanes, nee_weighting="reference", max_lanes=None, banded=False):
    """Sum ``spp`` samples starting at ``start_sample`` of the pixel ``lanes``
    on the tables' device, in a fixed wave order.  At most ``max_lanes``
    (default ``MAX_LANES_PER_PASS``) lanes render whole, in waves of
    :func:`samples_per_wave` samples, unless ``banded``; more render in bands
    (:func:`_band_plan`).  Returns ((len(lanes), 3) sum aligned with
    ``lanes``, rays traced, bands (0 whole), waves).

    The waves are :class:`integrator.Waves`' (the JAX ``lax.scan`` over
    them, renderer.py:52-88): the camera goes to the device once, a band's
    lanes when the band starts, a wave's sample numbers are written there,
    and each band's sum is copied out of the waves' sum once it is done, so
    the loops make no tensor of host data and read nothing back."""
    if max_lanes is None:
        max_lanes = MAX_LANES_PER_PASS
    n = lanes.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=lanes.device)
    if n <= max_lanes and not banded:
        chunk, per, bands = samples_per_wave(n, spp), n, 0
    else:
        chunk, per, bands = _band_plan(n, spp, max_lanes)
    frame = Waves(tables, view_inv, proj_inv, width, height, max_depth, nee_weighting)
    waves = 0
    for lo in range(0, n, per):
        frame.band(lanes[lo:lo + per])
        for done in range(0, spp, chunk):
            frame.run(start_sample + done, min(chunk, spp - done))
            waves += 1
        acc[lo:lo + per].copy_(frame.sum)
    return acc, frame.rays.clone(), bands, waves


def _banded_preferred(tables, width: int, height: int, spp: int) -> bool:
    """Does :func:`render_image` band this frame (renderer.py:173-196)?
    Always above ``MAX_LANES_PER_PASS`` pixels; below it, for a flattened
    scene on the repacked wavefront with at least 2 spp whose frame cannot
    hold ``min(spp, SPP_CHUNK)`` samples in one wave.  Dense scenes keep
    whole-frame waves: every lane costs them the same, whatever its order."""
    n = width * height
    if n > MAX_LANES_PER_PASS:
        return True
    return (spp >= 2 and tables.inst is None and integrator._repack_preferred(tables)
            and n * min(spp, SPP_CHUNK) > MAX_LANES_PER_PASS)


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
    array, total rays).  Frames above ``MAX_LANES_PER_PASS`` pixels render in
    bands, and so do the smaller frames :func:`_banded_preferred` picks.
    ``start_sample`` defaults to 1 (sample 0 is the
    preview frame and is excluded from accumulation, raygen.rgen:95-96)."""
    camera.aspect = width / height
    view_inv, proj_inv = camera_uniforms(camera)
    with torch.inference_mode():
        lanes = block_lanes(width, height, tables.device)
        acc, rays, bands, waves = render_lanes(tables, view_inv, proj_inv, width, height,
                                               max_depth, spp, start_sample, lanes,
                                               nee_weighting=nee_weighting,
                                               banded=_banded_preferred(tables, width, height,
                                                                        spp))
        LAST_RENDER.update(bands=bands, waves=waves)
        img = torch.zeros_like(acc)
        img[lanes] = acc
        host = _fetch(_postprocess(img, spp, tonemap, as_uint8))
        # the frame's one read: it waits for the stream, the image's copy
        # with it, and brings in the counts of the waves' device loops
        total_rays, = graphs.settle(rays)
    return host.numpy().reshape(height, width, 3), total_rays


def _fetch(img: torch.Tensor) -> torch.Tensor:
    """``img`` on the host: on a card a copy into pinned memory that does
    not wait (read it after the stream has run), else ``img``."""
    if not img.is_cuda:
        return img
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    return host.copy_(img, non_blocking=True)


def _frame_step(tables, view_inv, proj_inv, width, height, accum, max_depth, disp_h, disp_w,
                sample_count: int):
    """One interactive frame on the tables' device (renderer.py:259-292):
    render sample ``sample_count``, accumulate into ``accum`` **in place**,
    tonemap ``accum / max(sample_count, 1)``, quantise to uint8 and mean-pool
    to the display size.  The preview sample 0 is left out of the
    accumulation (raygen.rgen:95-96): it zeroes the buffer and is shown
    directly.  Returns (uint8 (disp_h, disp_w, 3) image, rays traced), both
    still on the device.  The sample renders through the same program as
    :func:`render_image`'s waves on CUDA tables, its number written on the
    device (:func:`render_sample`)."""
    with torch.inference_mode():
        radiance, rays = render_sample(tables, view_inv, proj_inv, width, height, sample_count,
                                       max_depth)
        if sample_count == 0:
            accum.zero_()
            shown = radiance
        else:
            accum.add_(radiance)
            shown = accum / float(sample_count)
        img8 = _postprocess(shown, 1, True, True).reshape(height, width, 3)
        if (disp_h, disp_w) != (height, width):
            # decimate to the display's cell grid on the device, so that only
            # disp_h * disp_w cells are fetched (the present blit)
            fy, fx = height // disp_h, width // disp_w
            cells = img8[:disp_h * fy, :disp_w * fx].reshape(disp_h, fy, disp_w, fx, 3)
            img8 = (cells.to(torch.int32).sum(dim=(1, 3)) // (fy * fx)).to(torch.uint8)
    return img8, rays


class Renderer:
    """Progressive renderer with the reference's frame-loop semantics
    (renderer.py:295-376).

    drawFrame (raytracer.cpp:501-535): reset the sample counter when the
    camera moved, render one sample, accumulate (samples >= 1), tonemap
    ``accumulated / sampleCount`` for display.  After a scene refit, assign
    the new tables and restart: ``renderer.tables = scene.refit(renderer.tables);
    renderer.reset_accumulation()``."""

    def __init__(self, tables, camera: Camera, width: int, height: int, max_depth: int = 5):
        self.tables = tables
        self.camera = camera
        self.width = width
        self.height = height
        self.max_depth = max_depth
        self.sample_count = 0
        self.accum = torch.zeros((width * height, 3), dtype=torch.float32, device=tables.device)
        self.total_rays = 0
        self._rays_pending = []  # device counters, folded lazily
        self._inflight = None  # the pipelined frame: (host image, its copy's event)
        self._host = {}  # display shape -> two pinned host images, used in turn
        camera.aspect = width / height

    def handle_resize(self, width: int, height: int) -> None:
        """raytracer.cpp:493-499: new images, reset accumulation.  A
        pipelined frame still in flight is dropped too: it was rendered for
        the old present target."""
        self.width, self.height = width, height
        self.camera.aspect = width / height
        self.accum = torch.zeros((width * height, 3), dtype=torch.float32,
                                 device=self.tables.device)
        self.sample_count = 0
        self._inflight = None

    def reset_accumulation(self) -> None:
        self.sample_count = 0

    @property
    def rays_traced(self) -> int:
        """Rays traced so far; the per-frame counters, and the counts of the
        frames' device loops (``graphs.settle``), stay on the device until
        this is read."""
        if self._rays_pending:
            self.total_rays += graphs.settle(torch.stack(self._rays_pending).sum())[0]
            self._rays_pending = []
        return self.total_rays

    def _start_fetch(self, img8):
        """Begin the copy of a display image to the host.  On a card the
        copy into pinned memory is asynchronous and an event marks its end;
        returns (host tensor, event or None)."""
        if img8.device.type != "cuda":
            return img8, None
        pair = self._host.setdefault(
            tuple(img8.shape),
            [torch.empty(img8.shape, dtype=torch.uint8, pin_memory=True) for _ in range(2)])
        pair.reverse()  # the buffer of two frames ago; its image was copied out
        pair[0].copy_(img8, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return pair[0], event

    @staticmethod
    def _finish_fetch(fetch) -> np.ndarray:
        host, event = fetch
        if event is not None:
            event.synchronize()  # never hand out a frame before its copy has ended
        return host.numpy().copy()

    def draw_frame(self, display_size=None, pipeline: bool = False):
        """Render one progressive sample; returns the tonemapped uint8
        display image: (H, W, 3), or ``display_size`` = (disp_h, disp_w)
        mean-pooled on the device (the interactive present path).

        ``pipeline=True`` is the swapchain-latency mode: the call enqueues
        frame N and returns frame N-1's display image (None on the very
        first call), so the fetch of one frame overlaps the next frame's
        work on the device (raytracer.cpp:518-533)."""
        if self.camera.position_changed or self.camera.direction_changed:
            self.sample_count = 0  # raytracer.cpp:503
            self.camera.position_changed = False
            self.camera.direction_changed = False
        view_inv, proj_inv = camera_uniforms(self.camera)
        disp_h, disp_w = display_size or (self.height, self.width)
        img8, rays = _frame_step(self.tables, view_inv, proj_inv, self.width, self.height,
                                 self.accum, self.max_depth, disp_h, disp_w, self.sample_count)
        self._rays_pending.append(rays)
        self.sample_count += 1
        if not pipeline:
            return img8.cpu().numpy()
        prev, self._inflight = self._inflight, self._start_fetch(img8)
        return self._finish_fetch(prev) if prev is not None else None
