"""Counter-based PRNG — bit-exact port of the reference's shader RNG.

Port of :mod:`vulkan_raytracer_tpu.ops.rng` (rng.py:40-137): 16-round TEA
seeds a per-pixel stream, an LCG draws from it, and the low 24 bits become
floats in [0, 1) (reference: shaders/random.glsl:14-42).

torch has no full uint32 arithmetic (its int32 ``>>`` is arithmetic, which
breaks ``v >> 5``), so a uint32 value is carried in an int64 tensor and
masked with ``& 0xFFFFFFFF`` after every add, multiply and left shift.  A
masked value is never negative, so ``>>`` on it is the logical shift.
Every draw advances the seed functionally: ``value, seed = rnd(seed)``;
branch-dependent draws use the select rule described in the JAX module.
"""

from __future__ import annotations

import torch

from .math3 import TWOPI

_M32 = 0xFFFFFFFF

# TEA round constants (shaders/random.glsl:21-23).
_TEA_SUM = 0x9E3779B9
_TEA_K0 = 0xA341316C
_TEA_K1 = 0xC8013EA4
_TEA_K2 = 0xAD90777D
_TEA_K3 = 0x7E95761E

# LCG constants (shaders/random.glsl:32-33).
_LCG_MUL = 1664525
_LCG_INC = 1013904223
_MANTISSA_MASK = 0x00FFFFFF
_INV_2_24 = 1.0 / float(1 << 24)


def as_u32(x, device=None) -> torch.Tensor:
    """A uint32 value (int, numpy array or tensor) as a masked int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _tea_mix(v, s, ka, kb):
    """((v << 4) + ka) ^ (v + s) ^ ((v >> 5) + kb) on uint32 lanes."""
    return (((v << 4) + ka) & _M32) ^ ((v + s) & _M32) ^ (((v >> 5) + kb) & _M32)


def tea(val0, val1):
    """16-round Tiny Encryption Algorithm hash (shaders/random.glsl:14-26)."""
    v0 = as_u32(val0)
    v1 = as_u32(val1, v0.device)
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s = 0
    for _ in range(16):
        s = (s + _TEA_SUM) & _M32
        v0 = (v0 + _tea_mix(v1, s, _TEA_K0, _TEA_K1)) & _M32
        v1 = (v1 + _tea_mix(v0, s, _TEA_K2, _TEA_K3)) & _M32
    return v0


def lcg(seed):
    """One LCG step; returns (low-24-bits, new_seed) (shaders/random.glsl:30-36)."""
    seed = (seed * _LCG_MUL + _LCG_INC) & _M32
    return seed & _MANTISSA_MASK, seed


def rnd(seed):
    """Uniform float32 in [0, 1) with 24-bit resolution (shaders/random.glsl:39-42)."""
    bits, seed = lcg(seed)
    return bits.to(torch.float32) * _INV_2_24, seed


def rnd_range(seed, lo, hi):
    """Uniform float in [lo, hi] (shaders/random.glsl:47-49)."""
    u, seed = rnd(seed)
    return lo + u * (hi - lo), seed


def rnd_int(seed, lo, hi):
    """Uniform int in [lo, hi] inclusive (shaders/random.glsl:52-54).

    ``lo``/``hi`` may be per-lane tensors; matches the reference's modulo
    construction, modulo bias included.  Returns int32 values.
    """
    bits, seed = lcg(seed)
    lo = torch.as_tensor(lo, dtype=torch.int64, device=seed.device)
    hi = torch.as_tensor(hi, dtype=torch.int64, device=seed.device)
    span = torch.clamp_min((hi - lo + 1) & _M32, 1)
    return (bits % span + lo).to(torch.int32), seed


def rnd_square(seed):
    """Two uniforms (shaders/random.glsl:62-64): returns ((u, v), seed)."""
    u, seed = rnd(seed)
    v, seed = rnd(seed)
    return (u, v), seed


def rnd_cube(seed):
    """Three uniforms (shaders/random.glsl:67-69)."""
    u, seed = rnd(seed)
    v, seed = rnd(seed)
    w, seed = rnd(seed)
    return (u, v, w), seed


def sample_uniform_hemisphere(seed):
    """Uniform point on the z+ hemisphere (shaders/random.glsl:72-76)."""
    (ux, uy), seed = rnd_square(seed)
    r = torch.sqrt(torch.clamp_min(1.0 - ux * ux, 0.0))
    phi = TWOPI * uy
    return (r * torch.cos(phi), r * torch.sin(phi), ux), seed


def sample_cosine_hemisphere(seed):
    """The reference's non-textbook "cosine" sample (shaders/random.glsl:87-94):
    ``r = u.x``, ``z = 1 - r^2``, ``(sin, cos)`` ordering, not unit length.
    Returns ((x, y, z), seed)."""
    (ux, uy), seed = rnd_square(seed)
    r = ux
    phi = TWOPI * uy
    x = r * torch.sin(phi)
    y = r * torch.cos(phi)
    z = 1.0 - (x * x + y * y)
    return (x, y, z), seed
