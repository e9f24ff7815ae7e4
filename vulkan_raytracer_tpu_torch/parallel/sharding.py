"""Pixel sharding: the frame's lanes split over a list of devices.

Port of :mod:`vulkan_raytracer_tpu.parallel.sharding`.  The scaling axis is
pixel parallelism, as there: every shard renders a contiguous run of the
32x32-block pixel order (``renderer.block_order``) with no halo, the scene
tables are replicated on every device, the shards' ray counters are summed
and the image is gathered once.

The mesh is an ordered list of ``torch.device``, one per shard
(:func:`make_mesh`).  A device may appear more than once; shards on one
device share one replica of the tables.  The shards of one process run **in
turn**: the host drives each wave (its rays, its state, the launch of its
program), and a Python thread per shard would only contend for the
interpreter lock.  One process per card is how the port scales out
(:mod:`.multihost`); the shards of a process only split its lanes the way
the fleet does.

Each shard runs ``renderer.render_lanes`` with its own band rule: whole
below ``MAX_LANES_PER_PASS`` lanes, as the JAX ``render_image_sharded``
(sharding.py:215) does, without ``renderer._banded_preferred``.  So a mesh
of one equals ``render_image`` bit for bit where that rule keeps the frame
whole (dense scenes, 1 spp, frames that fit ``SPP_CHUNK`` samples in a
wave); where it bands a frame below the cap, the samples are summed in
another grouping.
"""

from __future__ import annotations

import numpy as np
import torch

from ..render import graphs
from ..render.integrator import render_sample
from ..render.renderer import _postprocess, block_order, camera_uniforms, render_lanes
from ..scene.scenegraph import target_device


def make_mesh(devices=None) -> list[torch.device]:
    """The shards' devices: every visible CUDA device by default (an error
    without a card), else ``devices`` in order (names or ``torch.device``;
    ``["cpu"] * 8`` gives eight CPU shards).  A bare ``"cuda"`` names the
    current card."""
    if devices is None:
        target_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = target_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _replicas(tables, mesh) -> dict:
    """One copy of the tables per distinct device of ``mesh``."""
    return {d: tables if d == tables.device else tables.to(d) for d in dict.fromkeys(mesh)}


def render_sample_sharded(tables, view_inv, proj_inv, width, height, sample_count, max_depth,
                          mesh, nee_weighting: str = "reference"):
    """One progressive sample with the pixel lanes split over ``mesh``.

    Returns (radiance (W*H, 3) on the first shard's device, rays traced over
    all shards).  ``per = ceil(W*H / shards)`` lanes each; the last shard's
    lanes past the frame repeat the last pixel and are sliced off again (their
    rays are counted, as the JAX ``psum`` counts them)."""
    mesh = make_mesh(mesh)
    n = width * height
    per = -(-n // len(mesh))
    replicas = _replicas(tables, mesh)
    with torch.inference_mode():
        out, rays = [], torch.zeros((), dtype=torch.int64, device=mesh[0])
        for s, d in enumerate(mesh):
            lanes = torch.clamp(torch.arange(s * per, (s + 1) * per, dtype=torch.int32,
                                             device=d), max=n - 1)
            radiance, r = render_sample(replicas[d], view_inv, proj_inv, width, height,
                                        sample_count, max_depth, lane_idx=lanes,
                                        nee_weighting=nee_weighting)
            out.append(radiance.to(mesh[0]))
            rays += r.to(mesh[0])
    return torch.cat(out)[:n], rays


def _device_get(block: torch.Tensor) -> np.ndarray:
    return block.cpu().numpy()


def render_image_sharded(tables, camera, width: int, height: int, spp: int, max_depth: int,
                         mesh, start_sample: int = 1, tonemap: bool = True,
                         nee_weighting: str = "reference", gather=None,
                         max_lanes_per_pass: int | None = None, shards=None):
    """Headless render with the lanes split over ``mesh``; the contract of
    ``renderer.render_image``: returns ((H, W, 3) numpy image, rays).

    The lanes are the block order padded to ``len(mesh) * per`` lanes with
    copies of its last pixel; shard ``s`` renders ``[s * per, (s + 1) * per)``
    of it through ``renderer.render_lanes``: whole in waves of
    ``samples_per_wave(per, spp)`` samples (``_render_scan_sharded``,
    sharding.py:81-120), or, above ``max_lanes_per_pass`` lanes (default
    ``MAX_LANES_PER_PASS``), in bands of ``SPP_CHUNK``-sample waves with a
    ragged last band (sharding.py:238-263).  Padding lanes rewrite the same
    pixel with the same value, and their rays are counted, as the JAX
    ``psum`` counts them, so a frame that does not divide evenly counts more
    rays than ``render_image``.

    ``shards`` is the range of shards this process renders (default all of
    them), and ``rays`` counts their lanes.  ``gather`` takes these shards'
    radiance as one shard-major ``(len(shards) * per, 3)`` tensor and
    returns every shard's, ``(len(mesh) * per, 3)``, as a host array: by
    default a fetch to the host (``jax.device_get`` in the JAX package);
    :mod:`.multihost` all-gathers it over the fleet.  With the default
    gather and one device, the scatter to pixel order and the tonemap stay
    on that device, with one fetch at the end."""
    mesh = make_mesh(mesh)
    shards = range(len(mesh)) if shards is None else shards
    camera.aspect = width / height
    view_inv, proj_inv = camera_uniforms(camera)
    n = width * height
    per = -(-n // len(mesh))
    order = block_order(width, height)[0]
    lanes_all = np.concatenate([order, np.full(len(mesh) * per - n, order[-1], np.int32)])
    replicas = _replicas(tables, [mesh[s] for s in shards])
    dev0 = mesh[shards[0]]
    with torch.inference_mode():
        accs, rays = [], torch.zeros((), dtype=torch.int64, device=dev0)
        for s in shards:
            d = mesh[s]
            lanes = torch.as_tensor(lanes_all[s * per:(s + 1) * per], device=d)
            acc, r, _, _ = render_lanes(replicas[d], view_inv, proj_inv, width, height,
                                        max_depth, spp, start_sample, lanes, nee_weighting,
                                        max_lanes_per_pass)
            accs.append(acc.to(dev0))
            rays += r.to(dev0)
        block = torch.cat(accs)
        if gather is None and len(replicas) == 1:
            dev, rows = dev0, block
        else:
            dev = torch.device("cpu")
            rows = torch.as_tensor(np.asarray((gather or _device_get)(block), np.float32))
        img = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        img[torch.as_tensor(lanes_all, device=dev).long()] = rows
        img = _postprocess(img, spp, tonemap, False).cpu().numpy().reshape(height, width, 3)
        total_rays, = graphs.settle(rays)
    return img, total_rays
