"""The Cornell box, frozen: a copy of ``cornell_box_scene`` of the port's
``scene/builtin.py`` (the reference's default scene, res/CornellBox.gltf,
as the port builds it in): room x in [-1, 1], y in [0, 2], z in [-1, 1],
the front open; red left wall, green right wall; a tall and a short
rotated box; an emissive ceiling quad.  36 triangles, 2 emissive."""

from __future__ import annotations

import numpy as np

from benchmark.scenedata import Material, SceneData


def _quad(p0, p1, p2, p3):
    """Two triangles for a quad given CCW corners; normals from winding."""
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    n = np.cross(pos[1] - pos[0], pos[3] - pos[0])
    n = (n / np.linalg.norm(n)).astype(np.float32)
    return pos, np.tile(n, (4, 1)), np.asarray([0, 1, 2, 0, 2, 3], np.uint32)


def _box(center, size, angle_y):
    """Axis box rotated about +y; returns (positions, normals, indices)."""
    sx, sy, sz = np.asarray(size) / 2.0
    c, s = np.cos(angle_y), np.sin(angle_y)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    faces = []
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]:
        u, v = [(1, 2), (0, 2), (0, 1)][axis]
        corner = np.zeros((4, 3), np.float32)
        corner[:, axis] = sign * [sx, sy, sz][axis]
        uu = [sx, sy, sz][u]
        vv = [sx, sy, sz][v]
        quad_uv = np.array([[-uu, -vv], [uu, -vv], [uu, vv], [-uu, vv]], np.float32)
        if sign < 0:
            quad_uv = quad_uv[::-1]
        corner[:, u] = quad_uv[:, 0]
        corner[:, v] = quad_uv[:, 1]
        faces.append(corner)
    pos = np.concatenate(faces) @ rot.T + np.asarray(center, np.float32)
    nrm = np.zeros_like(pos)
    idx = []
    for f in range(6):
        b = 4 * f
        idx += [b, b + 1, b + 2, b, b + 2, b + 3]
        fn = np.cross(pos[b + 1] - pos[b], pos[b + 3] - pos[b])
        nrm[b : b + 4] = fn / np.linalg.norm(fn)
    return pos.astype(np.float32), nrm.astype(np.float32), np.asarray(idx, np.uint32)


def build(light_strength: float = 10.0, rough: float = 0.9,
          metallic_box: float = 0.0) -> SceneData:
    s = SceneData()
    white = np.array([0.73, 0.71, 0.68, 1.0], np.float32)
    red = np.array([0.63, 0.065, 0.05, 1.0], np.float32)
    green = np.array([0.14, 0.45, 0.091, 1.0], np.float32)

    def mat(colour, emissive=0.0, metal=0.0):
        m = Material()
        m.base_colour_factor = np.asarray(colour, np.float32)
        m.metallic_factor = metal
        m.roughness_factor = rough
        m.emissive_factor = np.full(3, emissive, np.float32)
        return m

    # floor, ceiling, back wall, left (red), right (green)
    s.add(*_quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]), mat(white))
    s.add(*_quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]), mat(white))
    s.add(*_quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]), mat(white))
    s.add(*_quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]), mat(red))
    s.add(*_quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]), mat(green))
    # boxes
    s.add(*_box([-0.35, 0.6, -0.35], [0.6, 1.2, 0.6], np.deg2rad(17)),
          mat(white, metal=metallic_box))
    s.add(*_box([0.4, 0.3, 0.35], [0.6, 0.6, 0.6], np.deg2rad(-17)),
          mat(white, metal=metallic_box))
    # ceiling light
    s.add(*_quad([-0.25, 1.98, -0.19], [0.25, 1.98, -0.19], [0.25, 1.98, 0.19],
                 [-0.25, 1.98, 0.19]),
          mat([1, 1, 1, 1], emissive=light_strength))
    return s
