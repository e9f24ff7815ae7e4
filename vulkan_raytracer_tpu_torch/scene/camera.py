"""Camera with the inverse view/projection matrices for ray generation.

Port of the headless part of ``vulkan_raytracer_tpu/scene/camera.py`` (the
reference's src/camera.cpp + include/camera.h): position/direction/up with
near/far/fov/aspect (camera.h:20-22, defaults camera.cpp:8-16), and
``view_inverse``/``projection_inverse``, which feed ray generation exactly
like CameraProperties (raytracer.h:18-20, shaders/raygen.rgen:41-43).  The
matrices follow GLM's right-handed, -1..1-depth conventions, in float64 and
then rounded to float32, as the JAX package's do.

Not ported yet: the fly-camera input handling of the interactive viewer
(ROADMAP.md Queue 1, "the progressive renderer and viewer").
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAt (right-handed)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def perspective(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glm::perspective (right-handed, clip z in [-1, 1])."""
    t = np.tan(fov_y / 2.0)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float64))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 1.0], np.float64))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float64))
    near: float = 0.1
    far: float = 1000.0
    fov: float = np.deg2rad(70.0)
    aspect: float = 1.0

    def view(self) -> np.ndarray:
        return look_at(self.position, self.position + self.direction, self.up)

    def view_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.view()).astype(np.float32)

    def projection(self) -> np.ndarray:
        return perspective(self.fov, self.aspect, self.near, self.far)

    def projection_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.projection()).astype(np.float32)
