"""Texture containers and the equirect skybox lookup.

Port of :mod:`vulkan_raytracer_tpu.ops.texture` (texture.py:41-209):

* :class:`TextureAtlas` / :func:`pack_textures` — every scene texture in one
  flat RGBA8-packed buffer with per-texture offsets.  The packed texels are
  uint32 values, carried in int64 because torch has no full uint32 type.
  Bilinear texture sampling (``sample_bilinear``) is not ported yet: the
  built-in Cornell box has no textures, and textured scenes raise in
  :meth:`~vulkan_raytracer_tpu_torch.scene.scenegraph.Scene.upload`.
* :class:`EnvMap` / :func:`pack_envmap` / :func:`sample_equirect` — the HDR
  skybox as flat float32 component columns; the lookup runs on every render
  (the deferred sky fetch after the bounce loop).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .math3 import PIINV, TWOPIINV


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """``texels[off[i] + y * w[i] + x]`` is texture i's texel (y, x), packed
    ``r | g<<8 | b<<16 | a<<24``."""

    texels: torch.Tensor  # (S,) int64 holding uint32 packed RGBA8
    off: torch.Tensor  # (NT,) int32 flat start offsets
    h: torch.Tensor  # (NT,) int32 heights
    w: torch.Tensor  # (NT,) int32 widths


def pack_textures(textures, device="cpu") -> TextureAtlas:
    """Quantise + pack a list of (H, W, 4) float32 textures (host side),
    UNORM8 round-to-nearest as the JAX package does."""
    offs, hs, ws, chunks = [], [], [], []
    off = 0
    for t in textures:
        th, tw = t.shape[0], t.shape[1]
        q = np.clip(np.round(np.asarray(t, np.float32) * 255.0), 0, 255).astype(np.uint32)
        packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
        chunks.append(packed.reshape(-1))
        offs.append(off)
        hs.append(th)
        ws.append(tw)
        off += th * tw
    if not chunks:  # degenerate 1-texel atlas, gated off by has_textures
        chunks = [np.full(1, 0xFFFFFFFF, np.uint32)]
        offs, hs, ws = [0], [1], [1]
    return TextureAtlas(
        texels=torch.as_tensor(np.concatenate(chunks).astype(np.int64), device=device),
        off=torch.as_tensor(np.array(offs, np.int32), device=device),
        h=torch.as_tensor(np.array(hs, np.int32), device=device),
        w=torch.as_tensor(np.array(ws, np.int32), device=device),
    )


@dataclasses.dataclass(frozen=True)
class EnvMap:
    """Equirect HDR environment as flat float32 component columns."""

    r: torch.Tensor  # (H*W,) f32
    g: torch.Tensor
    b: torch.Tensor
    h: int
    w: int


def pack_envmap(env, device="cpu") -> EnvMap:
    """(H, W, 3) float32 numpy -> flat EnvMap columns (host side)."""
    env = np.asarray(env, np.float32)
    h, w = env.shape[0], env.shape[1]
    flat = env.reshape(h * w, 3)
    return EnvMap(
        r=torch.as_tensor(flat[:, 0].copy(), device=device),
        g=torch.as_tensor(flat[:, 1].copy(), device=device),
        b=torch.as_tensor(flat[:, 2].copy(), device=device),
        h=h,
        w=w,
    )


def sample_equirect(env: EnvMap, direction):
    """Equirectangular environment lookup (shaders/skybox.rmiss:17-29).

    uv = (atan2(z, x)/2pi + 0.5, -(asin(y)/pi + 0.5)) with repeat
    addressing; floor-mod wrapping is ``torch.remainder`` (``jnp.mod``), not
    ``fmod``, so the negative v wraps.  ``direction`` is (N, 3); returns
    (N, 3).
    """
    h, w = env.h, env.w
    u = torch.atan2(direction[:, 2], direction[:, 0]) * TWOPIINV + 0.5
    v = -(torch.asin(torch.clamp(direction[:, 1], -1.0, 1.0)) * PIINV + 0.5)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    x0i = torch.remainder(x0i, w)
    y0i = torch.remainder(y0i, h)
    cols = torch.stack([env.r, env.g, env.b], dim=1)

    def fetch(yy, xx):
        return torch.index_select(cols, 0, yy * w + xx)

    c00 = fetch(y0i, x0i)
    c01 = fetch(y0i, x1i)
    c10 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy
