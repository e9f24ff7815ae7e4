"""Fly camera with the inverse view/projection matrices for ray generation.

Port of ``vulkan_raytracer_tpu/scene/camera.py`` (the reference's
src/camera.cpp + include/camera.h): position/direction/up with
near/far/fov/aspect and speed/sensitivity (camera.h:20-22, defaults
camera.cpp:8-16), WASD movement with shift x3 / ctrl x0.2 multipliers
(camera.cpp:18-45), quaternion yaw/pitch panning and fov zoom clamped to
[10, 150] degrees (camera.cpp:47-60), and ``view_inverse`` /
``projection_inverse``, which feed ray generation exactly like
CameraProperties (raytracer.h:18-20, shaders/raygen.rgen:41-43).  The
matrices follow GLM's right-handed, -1..1-depth conventions, in float64 and
then rounded to float32; everything is the JAX package's NumPy arithmetic,
so both cameras stay bit-equal under the same input.

Windowing is decoupled: the interactive viewer passes key and button state
in; headless rendering uses the camera directly.
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


def _rotate_about(v: np.ndarray, axis: np.ndarray, angle: float) -> np.ndarray:
    """Quaternion rotation angleAxis(angle, axis) applied to v."""
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    return v * c + np.cross(axis, v) * s + axis * (axis @ v) * (1.0 - c)


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float64))
    direction: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 1.0], np.float64))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float64))
    near: float = 0.1
    far: float = 1000.0
    fov: float = np.deg2rad(70.0)
    aspect: float = 1.0
    speed: float = 2.0
    sensitivity: float = 0.01
    position_changed: bool = False
    direction_changed: bool = False

    def view(self) -> np.ndarray:
        return look_at(self.position, self.position + self.direction, self.up)

    def view_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.view()).astype(np.float32)

    def projection(self) -> np.ndarray:
        return perspective(self.fov, self.aspect, self.near, self.far)

    def projection_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.projection()).astype(np.float32)

    # -- input (camera.cpp:18-60) ------------------------------------------

    def process_key_input(self, keys: set[str], dt: float) -> None:
        """keys: subset of {'w', 'a', 's', 'd', 'shift', 'ctrl'}."""
        mul = 3.0 if "shift" in keys else (0.2 if "ctrl" in keys else 1.0)
        step = mul * self.speed * dt
        right = np.cross(self.direction, self.up)
        right = right / np.linalg.norm(right)
        self.position_changed = False
        if "w" in keys:
            self.position = self.position + step * self.direction
            self.position_changed = True
        if "s" in keys:
            self.position = self.position - step * self.direction
            self.position_changed = True
        if "a" in keys:
            self.position = self.position - step * right
            self.position_changed = True
        if "d" in keys:
            self.position = self.position + step * right
            self.position_changed = True

    def cursor_moved(self, dx: float, dy: float, left: bool = False, right: bool = False) -> None:
        """Left button: pan by yaw/pitch quaternions; right button: fov,
        clamped (camera.cpp:47-60)."""
        self.direction_changed = False
        if left:
            yaw = dx * self.sensitivity / (2.0 * np.pi)
            pitch = dy * self.sensitivity / (-2.0 * np.pi)
            axis = np.cross(self.direction, self.up)
            self.direction = _rotate_about(self.direction, -self.up, yaw)
            self.direction = _rotate_about(self.direction, axis / np.linalg.norm(axis), pitch)
            if dx or dy:
                self.direction_changed = True
        if right:
            self.fov = float(np.clip(self.fov + 0.01 * dy, np.deg2rad(10.0), np.deg2rad(150.0)))
            if dx or dy:
                self.direction_changed = True
