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
``parallel/sharding.py`` run it over their runs of it), but where a frame
renders whole on CUDA tables:

* A frame of at most ``MAX_LANES_PER_PASS`` pixels renders whole (the JAX
  ``_render_batch``): samples are grouped ``s_batch`` to a wave and the
  waves summed in sample order, as in the JAX package.  On CUDA tables the
  whole frame, its waves and its image, is ONE program launch, as JAX
  compiles it into one ``jit`` (``integrator.Waves.frame``: its waves under
  one WHILE node, then the image), keyed by the wave count; the progressive
  frame is one program launch too (:class:`Renderer`).
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

import functools
import itertools
import weakref

import numpy as np
import torch

from ..ops import wave
from ..scene.camera import Camera
from . import graphs, integrator
from .integrator import Waves, block_lanes
from .integrator import block_order  # noqa: F401  (the sharded renderer's import)

#: Max lanes (pixel samples) per wave; cfg1 (512x512, 64 spp) runs 32 waves
#: of 2 samples x 262,144 pixels.
MAX_LANES_PER_PASS = 1 << 19
#: Samples per wave of the banded renderer (``default_spp_chunk``, :126).
SPP_CHUNK = 8

#: The last :func:`render_image` call: its ``waves`` and, for a banded
#: render, its ``bands`` (0 for a frame rendered whole).  A frame program's
#: waves are counted from its loop's row when its counts come in.
LAST_RENDER = {"bands": 0, "waves": 0}
#: The last :func:`render_image` call's linear ``sum`` over its samples
#: ((n, 3) on the tables' device, aligned with the block order; a buffer
#: the next frame may overwrite).
LAST_SUM = {"sum": None}


def _count_waves(runs: int, entries: int, most: int) -> None:
    """The fold of a frame program's loop over its waves
    (``graphs.settle``): the waves it ran."""
    LAST_RENDER["waves"] += runs


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
    preview frame and is excluded from accumulation, raygen.rgen:95-96).
    The sum's scatter to pixel order and its post-processing are one
    :func:`..ops.wave.frame_image` (one launch on a card).  On CUDA tables
    a frame that renders whole is one program, its waves and its image
    (``integrator.Waves.frame``); a banded one a program a wave, then the
    image, as the JAX renderer dispatches a (band, chunk) at a time."""
    camera.aspect = width / height
    view_inv, proj_inv = camera_uniforms(camera)
    with torch.inference_mode():
        lanes = block_lanes(width, height, tables.device)
        banded = _banded_preferred(tables, width, height, spp)
        if graphs._graphs_preferred(tables) and not banded:
            frame = Waves(tables, view_inv, proj_inv, width, height, max_depth, nee_weighting)
            k = samples_per_wave(lanes.shape[0], spp)
            LAST_RENDER.update(bands=0, waves=0)  # the waves come in with the counts
            img = frame.frame(lanes, start_sample, k, spp // k, tonemap, as_uint8,
                              _count_waves)
            acc, rays = frame.sum, frame.rays
        else:
            acc, rays, bands, waves = render_lanes(tables, view_inv, proj_inv, width, height,
                                                   max_depth, spp, start_sample, lanes,
                                                   nee_weighting=nee_weighting, banded=banded)
            LAST_RENDER.update(bands=bands, waves=waves)
            img = wave.frame_image(acc, lanes, spp, tonemap, as_uint8)
        LAST_SUM["sum"] = acc
        host = _fetch(img)
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
    device (one :class:`Waves` wave of one sample, in pixel order, as
    ``render_sample`` runs it); the rest of the frame is one
    :func:`..ops.wave.frame_progressive`, which on a card reads the sample's
    number where the wave's program read it.  (:class:`Renderer` runs the
    same frame as one program on CUDA tables, :func:`_frame_program`.)"""
    with torch.inference_mode():
        waves = Waves(tables, view_inv, proj_inv, width, height, max_depth)
        if waves.repack:
            lanes = block_lanes(width, height, tables.device)
        else:
            lanes = torch.arange(width * height, dtype=torch.int64, device=tables.device)
        waves.band(lanes)
        radiance, rays = waves.run(sample_count, 1, pixel_order=waves.repack, radiance=True)
        sample = waves.samples if radiance.is_cuda else sample_count
        img8 = wave.frame_progressive(radiance, accum, sample, width, height, disp_h, disp_w)
    return img8, rays.clone()


def _frame_program(tables, io: dict, cap, *, disp_h: int, disp_w: int, **opts):
    """The progressive frame as one program (the JAX ``_frame_step``,
    renderer.py:253-292, one ``jit``)::

        wave (one sample, its radiance in pixel order); tail

    the wave ``integrator._wave_program``'s node tree over ``io`` (no band
    sum; its rays into ``io["rays"]``), the tail
    :func:`..ops.wave.frame_progressive` of its radiance into
    ``io["accum"]`` and ``io["image"]``, reading the sample's number in
    ``io["samples"]``, where the wave read it.  Returns the image."""
    radiance, _ = integrator._wave_program(tables, io, cap, **opts)
    return wave.frame_progressive(radiance, io["accum"], io["samples"], opts["width"],
                                  opts["height"], disp_h, disp_w, out=io["image"])


class _FrameState:
    """The buffers a progressive renderer's frame programs read and write on
    CUDA tables, the renderer's own while it lives: its accumulation, its
    camera, its sample number and its ray count, and for each display size
    and lane order the pixel lanes and the display image (:meth:`io`).  A
    program reads them at fixed addresses, so it is keyed by its state's
    serial number: two live renderers of one size keep their accumulations
    apart.  When a renderer goes, its state goes back to a pool of its
    device and size (:func:`_take_state`), and the next renderer of that
    size launches the programs already captured on it."""

    def __init__(self, device, width: int, height: int):
        with torch.inference_mode(False):
            self.accum = torch.zeros((width * height, 3), dtype=torch.float32, device=device)
            self.cam = torch.zeros(32, dtype=torch.float32, device=device)
            self.samples = torch.zeros(1, dtype=torch.int64, device=device)
            self.rays = torch.zeros((), dtype=torch.int64, device=device)
        self.key = (device, width, height)
        self.serial = next(_STATE_SERIAL)
        self.cam_host = None  # the camera last written to ``cam``
        self._ios: dict = {}

    def io(self, disp_h: int, disp_w: int, repack: bool) -> dict:
        """A program's buffers for this display size and lane order (block
        order on the repacked wavefront, else pixel order)."""
        io = self._ios.get((disp_h, disp_w, repack))
        if io is None:
            device, width, height = self.key
            with torch.inference_mode(False):
                lanes = (block_lanes(width, height, device) if repack
                         else torch.arange(width * height, dtype=torch.int64, device=device))
                image = torch.empty((disp_h, disp_w, 3), dtype=torch.uint8, device=device)
            io = self._ios[(disp_h, disp_w, repack)] = dict(
                samples=self.samples, lanes=lanes, cam=self.cam, rays=self.rays,
                accum=self.accum, image=image)
        return io


_STATE_SERIAL = itertools.count()
_FREE_STATES: dict = {}  # (device, width, height) -> the frame states no renderer holds


def _take_state(device, width: int, height: int) -> _FrameState:
    """A frame state of this size, from the pool where one is free, with a
    zero accumulation and ray count."""
    free = _FREE_STATES.get((device, width, height))
    state = free.pop() if free else _FrameState(device, width, height)
    state.accum.zero_()
    state.rays.zero_()
    state.cam_host = None
    return state


def _give_back(state: _FrameState) -> None:
    _FREE_STATES.setdefault(state.key, []).append(state)


class Renderer:
    """Progressive renderer with the reference's frame-loop semantics
    (renderer.py:295-376).

    drawFrame (raytracer.cpp:501-535): reset the sample counter when the
    camera moved, render one sample, accumulate (samples >= 1), tonemap
    ``accumulated / sampleCount`` for display.  After a scene refit, assign
    the new tables and restart: ``renderer.tables = scene.refit(renderer.tables);
    renderer.reset_accumulation()``.

    On CUDA tables a frame is one program launch (:func:`_frame_program`)
    over buffers of the renderer's own while it lives (:class:`_FrameState`,
    its accumulation among them): the host writes the camera when it moved
    and the sample number, launches, and fetches the image; elsewhere a
    frame is :func:`_frame_step`."""

    def __init__(self, tables, camera: Camera, width: int, height: int, max_depth: int = 5):
        self.tables = tables
        self.camera = camera
        self.width = width
        self.height = height
        self.max_depth = max_depth
        self.sample_count = 0
        self.total_rays = 0
        self._rays_pending = []  # device counters, folded lazily
        self._inflight = None  # the pipelined frame: (host image, its copy's event)
        self._host = {}  # display shape -> two pinned host images, used in turn
        self._state = self._release = None  # the program frames' buffers, and their return
        self.accum = self._new_accum()
        camera.aspect = width / height

    def _new_accum(self):
        """A zero accumulation of the renderer's size: on CUDA tables its
        frame state's, taken from the pool (the state it held goes back, its
        ray count kept with the frames' counters)."""
        if self._release is not None:
            self._rays_pending.append(self._state.rays.clone())
            self._release()
        self._state = self._release = None
        if not graphs._graphs_preferred(self.tables):
            return torch.zeros((self.width * self.height, 3), dtype=torch.float32,
                               device=self.tables.device)
        self._state = _take_state(self.tables.device, self.width, self.height)
        self._release = weakref.finalize(self, _give_back, self._state)
        return self._state.accum

    def handle_resize(self, width: int, height: int) -> None:
        """raytracer.cpp:493-499: new images, reset accumulation.  A
        pipelined frame still in flight is dropped too: it was rendered for
        the old present target."""
        self.width, self.height = width, height
        self.camera.aspect = width / height
        self.accum = self._new_accum()
        self.sample_count = 0
        self._inflight = None

    def reset_accumulation(self) -> None:
        self.sample_count = 0

    @property
    def rays_traced(self) -> int:
        """Rays traced so far; the per-frame counters (the program frames':
        one running count), and the counts of the frames' device loops
        (``graphs.settle``), stay on the device until this is read."""
        scalars = [torch.stack(self._rays_pending).sum()] if self._rays_pending else []
        if self._state is not None:
            scalars.append(self._state.rays)
        if not scalars:
            return self.total_rays
        values = graphs.settle(*scalars)
        if self._rays_pending:
            self.total_rays += values[0]
            self._rays_pending = []
        return self.total_rays + (values[-1] if self._state is not None else 0)

    def _draw_program(self, view_inv, proj_inv, disp_h: int, disp_w: int):
        """One frame as one launch of its program: the camera written where
        it moved, the sample number written on the device.  Returns the
        display image, the program's own buffer."""
        if self._state is None:  # made on tables the programs do not run: adopt its sum
            accum, self.accum = self.accum, self._new_accum()
            self.accum.copy_(accum)
        state, repack = self._state, integrator._repack_preferred(self.tables)
        io = state.io(disp_h, disp_w, repack)
        cam = np.concatenate([np.asarray(view_inv, np.float32).ravel(),
                              np.asarray(proj_inv, np.float32).ravel()])
        if state.cam_host is None or not np.array_equal(cam, state.cam_host):
            host = torch.as_tensor(cam)
            if io["cam"].is_cuda:
                host = host.pin_memory()  # kept by the allocator until the copy ran
            io["cam"].copy_(host, non_blocking=True)
            state.cam_host = cam
        io["samples"].fill_(self.sample_count)
        opts = dict(width=self.width, height=self.height, max_depth=self.max_depth,
                    nee_weighting="reference", repack=repack, pixel_order=repack,
                    radiance=True)
        key = ("progressive", state.serial, disp_h, disp_w, repack, self.max_depth)
        return graphs.cache(self.tables).run(
            self.tables, key, io, functools.partial(integrator._wave_eager, **opts),
            functools.partial(_frame_program, disp_h=disp_h, disp_w=disp_w, **opts),
            integrator._COUNTERS)

    def _start_fetch(self, img8):
        """Begin the copy of a display image to the host.  On a card the
        copy into pinned memory is asynchronous and an event marks its end;
        returns (host tensor, event or None)."""
        if img8.device.type != "cuda":
            return img8.clone(), None  # a program's image is overwritten by its next launch
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
        if graphs._graphs_preferred(self.tables):
            img8 = self._draw_program(view_inv, proj_inv, disp_h, disp_w)
        else:
            img8, rays = _frame_step(self.tables, view_inv, proj_inv, self.width, self.height,
                                     self.accum, self.max_depth, disp_h, disp_w,
                                     self.sample_count)
            self._rays_pending.append(rays)
        self.sample_count += 1
        if not pipeline:
            return img8.to("cpu", copy=True).numpy()
        prev, self._inflight = self._inflight, self._start_fetch(img8)
        return self._finish_fetch(prev) if prev is not None else None
