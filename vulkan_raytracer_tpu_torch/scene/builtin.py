"""The built-in scenes, built on the port's :class:`Scene`.

Port of vulkan_raytracer_tpu/scene/builtin.py: ``cornell_box_scene``
(:18-116), the default scene and bench cfg1's workload (36 triangles, 2 of
them emissive, no punctual lights, no alpha and no textures); the random
``triangle_soup_scene`` (:119) and the glass icosphere
``glass_sphere_scene`` (:147).  The geometry is the same float32
arithmetic, so the uploads of the two packages are bit-equal.
"""

from __future__ import annotations

import numpy as np

from .scenegraph import Material, Primitive, Scene


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


def _add_primitive(scene: Scene, pos, nrm, idx, material: Material) -> None:
    mat_idx = len(scene.materials)
    scene.materials.append(material)
    nv = pos.shape[0]
    prim = Primitive(
        positions=pos,
        normals=nrm,
        tangents=np.zeros((nv, 4), np.float32),
        uvs=np.zeros((nv, 2), np.float32),
        indices=idx,
        material=mat_idx,
    )
    scene.mesh_pool.append([prim])
    scene.add_node(scene.root, np.eye(4, dtype=np.float32), mesh=len(scene.mesh_pool) - 1)


def cornell_box_scene(
    light_strength: float = 10.0, rough: float = 0.9, metallic_box: float = 0.0
) -> Scene:
    """The classic Cornell box: room x in [-1, 1], y in [0, 2], z in [-1, 1]
    with the front (z=+1) open; red left wall, green right wall, white
    floor/ceiling/back; a tall and a short rotated box; an emissive ceiling
    quad."""
    s = Scene()
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
    _add_primitive(s, *_quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]), mat(white))
    _add_primitive(s, *_quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]), mat(white))
    _add_primitive(s, *_quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]), mat(white))
    _add_primitive(s, *_quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]), mat(red))
    _add_primitive(s, *_quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]), mat(green))
    # boxes
    _add_primitive(
        s, *_box([-0.35, 0.6, -0.35], [0.6, 1.2, 0.6], np.deg2rad(17)),
        mat(white, metal=metallic_box),
    )
    _add_primitive(
        s, *_box([0.4, 0.3, 0.35], [0.6, 0.6, 0.6], np.deg2rad(-17)),
        mat(white, metal=metallic_box),
    )
    # ceiling light
    _add_primitive(
        s,
        *_quad([-0.25, 1.98, -0.19], [0.25, 1.98, -0.19], [0.25, 1.98, 0.19],
               [-0.25, 1.98, 0.19]),
        mat([1, 1, 1, 1], emissive=light_strength),
    )
    return s


def triangle_soup_scene(n_tris: int = 50_000, seed: int = 0, emissive_every: int = 0) -> Scene:
    """Random triangle soup: a BVH build and traversal stress scene."""
    r = np.random.default_rng(seed)
    s = Scene()
    base = r.uniform(-10, 10, (n_tris, 3)).astype(np.float32)
    offs = r.normal(0, 0.15, (n_tris, 2, 3)).astype(np.float32)
    pos = np.concatenate(
        [base, base + offs[:, 0], base + offs[:, 1]], axis=1
    ).reshape(-1, 3)
    nrm = np.cross(offs[:, 0], offs[:, 1])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
    nrm = np.repeat(nrm, 3, axis=0).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.uint32)
    m = Material()
    m.base_colour_factor = np.array([0.7, 0.7, 0.7, 1.0], np.float32)
    m.metallic_factor = 0.2
    m.roughness_factor = 0.5
    _add_primitive(s, pos, nrm, idx, m)
    if emissive_every:
        light = Material()
        light.base_colour_factor = np.ones(4, np.float32)
        light.emissive_factor = np.full(3, 20.0, np.float32)
        lp, ln, li = _quad([-12, 12, -12], [12, 12, -12], [12, 12, 12], [-12, 12, 12])
        _add_primitive(s, lp, ln, li, light)
    return s


def glass_sphere_scene(
    subdiv: int = 3, ior: float = 1.5, dispersion: float = 0.0, thin: bool = False
) -> Scene:
    """Icosphere of glass over a diffuse floor with an area light:
    transmission, volume absorption and dispersion."""
    s = Scene()
    # icosphere
    t = (1 + 5**0.5) / 2
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    for _ in range(subdiv):
        new_faces = []
        cache: dict[tuple[int, int], int] = {}
        verts_list = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                cache[key] = len(verts_list)
                verts_list.append(m)
            return cache[key]

        for f in faces:
            a, b, c = f
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces)

    pos = (verts * 0.6 + np.array([0, 0.9, 0])).astype(np.float32)
    nrm = verts.astype(np.float32)
    glass = Material()
    glass.base_colour_factor = np.ones(4, np.float32)
    glass.metallic_factor = 0.0
    glass.roughness_factor = 0.05
    glass.transmission_factor = 1.0
    glass.thickness_factor = 0.0 if thin else 1.0
    glass.ior = ior
    glass.dispersion = dispersion
    glass.attenuation_coefficient = np.array([0.05, 0.02, 0.0], np.float32)
    _add_primitive(s, pos, nrm, faces.reshape(-1).astype(np.uint32), glass)

    floor_mat = Material()
    floor_mat.base_colour_factor = np.array([0.7, 0.7, 0.7, 1.0], np.float32)
    floor_mat.metallic_factor = 0.0
    floor_mat.roughness_factor = 0.8
    _add_primitive(
        s, *_quad([-4, 0, 4], [4, 0, 4], [4, 0, -4], [-4, 0, -4]), floor_mat
    )
    light = Material()
    light.base_colour_factor = np.ones(4, np.float32)
    light.emissive_factor = np.full(3, 15.0, np.float32)
    _add_primitive(
        s, *_quad([-1, 3.5, -1], [1, 3.5, -1], [1, 3.5, 1], [-1, 3.5, 1]), light
    )
    return s
