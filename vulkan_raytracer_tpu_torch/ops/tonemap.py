"""Tonemapping — port of :mod:`vulkan_raytracer_tpu.ops.tonemap`
(shaders/hdr.glsl).  Operates on (..., 3) linear-RGB tensors."""

from __future__ import annotations

import torch

_LUMA = (0.2126, 0.7152, 0.0722)


def luminance(v):
    """Rec.709 luma (shaders/hdr.glsl:5-7)."""
    return v[..., 0] * _LUMA[0] + v[..., 1] * _LUMA[1] + v[..., 2] * _LUMA[2]


def reinhard(v):
    """v / (1 + v), per channel (shaders/hdr.glsl:1-3)."""
    return v / (1.0 + v)


def reinhard_jodie(v):
    """Luminance/channel-blended Reinhard (shaders/hdr.glsl:9-13)."""
    lum = luminance(v)[..., None]
    tv = reinhard(v)
    return (v / (1.0 + lum)) * (1.0 - tv) + tv * tv


def hable(x):
    """Hable filmic curve (shaders/hdr.glsl:15-25; unused by the display path)."""
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f
