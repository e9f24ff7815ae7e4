"""Wavelength -> linear-sRGB conversion for spectral dispersion.

Port of :mod:`vulkan_raytracer_tpu.ops.spectral` (the CIE-1931 Gaussian
fits of shaders/spectral.glsl:48-71 composed with XYZ -> linear sRGB).
The 3x3 matrix product is written out as weighted sums per channel.
"""

from __future__ import annotations

import torch


def _gauss(wave, mu, s_lo, s_hi):
    t = (wave - mu) * torch.where(wave < mu, s_lo, s_hi)
    return torch.exp(-0.5 * t * t)


def x_fit_1931(wave):
    return (
        0.362 * _gauss(wave, 442.0, 0.0624, 0.0374)
        + 1.056 * _gauss(wave, 599.8, 0.0264, 0.0323)
        - 0.065 * _gauss(wave, 501.1, 0.0490, 0.0382)
    )


def y_fit_1931(wave):
    return 0.821 * _gauss(wave, 568.8, 0.0213, 0.0247) + 0.286 * _gauss(
        wave, 530.9, 0.0613, 0.0322
    )


def z_fit_1931(wave):
    return 1.217 * _gauss(wave, 437.0, 0.0845, 0.0278) + 0.681 * _gauss(
        wave, 459.0, 0.0385, 0.0725
    )


# Column-major mat3 in the reference (shaders/spectral.glsl:70) -> rows here.
_XYZ_TO_RGB = (
    (2.364613, -0.896541, -0.468073),
    (-0.5151166, 1.426408, 0.088758),
    (0.005203, -0.014408, 1.009204),
)


def spectral_colour_1931(wavelength):
    """RGB for a wavelength in nm; shape (N,) -> (N, 3)."""
    x, y, z = x_fit_1931(wavelength), y_fit_1931(wavelength), z_fit_1931(wavelength)
    return torch.stack([r[0] * x + r[1] * y + r[2] * z for r in _XYZ_TO_RGB], dim=-1)
