"""Texture containers, bilinear texture sampling and the equirect skybox
lookup.

Port of :mod:`vulkan_raytracer_tpu.ops.texture` (texture.py:41-209):

* :class:`TextureAtlas` / :func:`pack_textures` — every scene texture in one
  flat RGBA8-packed buffer with per-texture offsets, 4 bytes per texel as
  in the JAX atlas.  torch has no full uint32 type, so a texel's uint32 bit
  pattern is stored in int32; :func:`unpack_rgba8` reads the channels with
  ``(p >> k) & 0xFF``, which the arithmetic shift of a negative int32
  leaves right.
* :func:`sample_bilinear` — per-lane bilinear fetch with repeat addressing
  and GL texel centres (the reference's linear-filtered samplers,
  texture.cpp:5-40); the glTF material slots, normal maps, the alpha test
  and the emissive NEE texture read through it.
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

    texels: torch.Tensor  # (S,) int32 holding the uint32 bits of packed RGBA8
    off: torch.Tensor  # (NT,) int32 flat start offsets
    h: torch.Tensor  # (NT,) int32 heights
    w: torch.Tensor  # (NT,) int32 widths


def pack_textures(textures, device) -> TextureAtlas:
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
        texels=torch.as_tensor(np.concatenate(chunks).view(np.int32), device=device),
        off=torch.as_tensor(np.array(offs, np.int32), device=device),
        h=torch.as_tensor(np.array(hs, np.int32), device=device),
        w=torch.as_tensor(np.array(ws, np.int32), device=device),
    )


def unpack_rgba8(p):
    """Packed RGBA8 (int32 bit pattern) -> four float32 channels in [0, 1]."""
    f = 1.0 / 255.0
    return (
        (p & 0xFF).to(torch.float32) * f,
        ((p >> 8) & 0xFF).to(torch.float32) * f,
        ((p >> 16) & 0xFF).to(torch.float32) * f,
        ((p >> 24) & 0xFF).to(torch.float32) * f,
    )


def sample_bilinear(atlas: TextureAtlas, tex_idx, uv):
    """Sample texture ``tex_idx`` (per lane) at ``uv`` with repeat addressing
    and bilinear filtering (texture.py:97-135).

    ``tex_idx`` is (N,) int32 (callers mask out the -1 lanes), ``uv`` is
    (N, 2) float32; returns (N, 4) float32 texels.  Texel centres sit at
    (i + 0.5) / n; the wrap is a floor-mod, ``torch.remainder`` (``jnp.mod``).
    """
    ti = torch.clamp_min(tex_idx, 0)
    off = torch.index_select(atlas.off, 0, ti)
    hn = torch.index_select(atlas.h, 0, ti)
    wn = torch.index_select(atlas.w, 0, ti)
    x = uv[:, 0] * wn.to(torch.float32) - 0.5
    y = uv[:, 1] * hn.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    x1i = torch.remainder(x0i + 1, wn)
    y1i = torch.remainder(y0i + 1, hn)
    x0i = torch.remainder(x0i, wn)
    y0i = torch.remainder(y0i, hn)

    def fetch(yy, xx):
        p = torch.index_select(atlas.texels, 0, off + yy * wn + xx)
        return torch.stack(unpack_rgba8(p), dim=-1)

    c00 = fetch(y0i, x0i)
    c01 = fetch(y0i, x1i)
    c10 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


@dataclasses.dataclass(frozen=True)
class EnvMap:
    """Equirect HDR environment as flat float32 component columns."""

    r: torch.Tensor  # (H*W,) f32
    g: torch.Tensor
    b: torch.Tensor
    h: int
    w: int


def pack_envmap(env, device) -> EnvMap:
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
