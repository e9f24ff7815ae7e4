"""A scene as plain arrays: what the port's ``Scene`` and the reference
both read.

The frozen scene generators under ``scenes/`` fill a :class:`SceneData`;
the harness hands its meshes to the port through ``Scene.add_raw_mesh``
(:func:`benchmark.harness.port_scene`) and the reference flattens them
itself (``reference/pathtracer.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Material:
    """The glTF material fields the port's ``Material`` has, with the same
    defaults (metallic and roughness 1, ior 1.5)."""

    base_colour_factor: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    alpha_mode: int = 0
    alpha_cutoff: float = 0.5
    emissive_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    transmission_factor: float = 0.0
    thickness_factor: float = 0.0
    attenuation_coefficient: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    ior: float = 1.5
    anisotropy_strength: float = 0.0
    anisotropy_rotation: float = 0.0
    dispersion: float = 0.0


@dataclass
class Mesh:
    """One triangle mesh under the root: float32 positions and normals
    (V, 3), uint32 indices (3F,), a material (shared by identity) and a
    float32 (4, 4) world transform (None: identity)."""

    positions: np.ndarray
    normals: np.ndarray
    indices: np.ndarray
    material: Material
    transform: np.ndarray | None = None


@dataclass
class SceneData:
    meshes: list = field(default_factory=list)
    skybox: np.ndarray | None = None  # (H, W, 3) float32, equirect
    skybox_strength: float = 1.0

    def add(self, positions, normals, indices, material, transform=None) -> None:
        self.meshes.append(Mesh(np.asarray(positions, np.float32),
                                np.asarray(normals, np.float32),
                                np.asarray(indices, np.uint32), material,
                                None if transform is None
                                else np.asarray(transform, np.float32)))
