"""The camera's inverse view and projection matrices (glm's right-handed
lookAt and perspective, clip z in [-1, 1]), in float64 and then rounded to
float32: the arithmetic the reference renderer's camera uses
(src/camera.cpp, include/camera.h; fov 70 degrees, near 0.1, far 1000)."""

from __future__ import annotations

import numpy as np

FOV = np.deg2rad(70.0)
NEAR, FAR = 0.1, 1000.0
UP = np.array([0.0, 1.0, 0.0], np.float64)


def look_at(eye, center, up) -> np.ndarray:
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def perspective(fov_y, aspect, near, far) -> np.ndarray:
    t = np.tan(fov_y / 2.0)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def matrices(position, direction, width: int, height: int):
    """(inverse view, inverse projection), float32 (4, 4) each."""
    eye = np.asarray(position, np.float64)
    view = look_at(eye, eye + np.asarray(direction, np.float64), UP)
    proj = perspective(FOV, width / height, NEAR, FAR)
    return (np.linalg.inv(view).astype(np.float32),
            np.linalg.inv(proj).astype(np.float32))
