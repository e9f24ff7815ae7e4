"""Procedural stand-in scenes for the bench configurations 2-5.

Port of :mod:`vulkan_raytracer_tpu.scene.procedural` (NumPy only) onto the
port's :class:`Scene`: ``hall_scene`` (:98, cfg4), ``dragon_scene`` (:170,
cfg2), ``sky_hdr`` (:206, cfg4's sky), ``multi_scene`` (:235, cfg5) and
``chess_scene`` (:269, cfg3).  The reference's gallery scenes are not
redistributable, so these generators make workload-equivalent geometry
(triangle counts, materials, light transport) from the same float32
arithmetic as the JAX module; positions, indices and materials are
bit-equal to it (tests/test_torch_procedural.py).
"""

from __future__ import annotations

import numpy as np

from .scenegraph import Material, Scene


def _grid_mesh(nx: int, nz: int, scale_x=1.0, scale_z=1.0, height_fn=None):
    """Subdivided XZ plane: positions (V, 3), indices (F*3,) uint32."""
    xs = np.linspace(0.0, scale_x, nx + 1, dtype=np.float32)
    zs = np.linspace(0.0, scale_z, nz + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = (
        np.zeros_like(gx)
        if height_fn is None
        else height_fn(gx, gz).astype(np.float32)
    )
    pos = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    ii, jj = np.meshgrid(
        np.arange(nx, dtype=np.uint32), np.arange(nz, dtype=np.uint32), indexing="ij"
    )
    v00 = ii * (nz + 1) + jj
    v01 = v00 + 1
    v10 = v00 + (nz + 1)
    v11 = v10 + 1
    idx = np.stack([v00, v10, v11, v00, v11, v01], axis=-1).reshape(-1)
    return pos, idx.astype(np.uint32)


def _cylinder_mesh(n_seg: int, n_h: int, radius: float, height: float):
    """Open cylinder along +Y."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False, dtype=np.float32)
    ys = np.linspace(0, height, n_h + 1, dtype=np.float32)
    ring = np.stack([np.cos(ang) * radius, np.zeros(n_seg), np.sin(ang) * radius], -1)
    pos = np.concatenate([ring + np.array([0, y, 0], np.float32) for y in ys])
    idx = []
    for r in range(n_h):
        a = r * n_seg + np.arange(n_seg, dtype=np.uint32)
        b = (a + 1) % n_seg + r * n_seg
        c = a + n_seg
        d = (a + 1) % n_seg + (r + 1) * n_seg
        idx.append(np.stack([a, c, d, a, d, b], -1).reshape(-1))
    return pos.astype(np.float32), np.concatenate(idx).astype(np.uint32)


def _sphere_mesh(n_lat: int, n_lon: int, radius: float):
    la = np.linspace(0, np.pi, n_lat + 1, dtype=np.float32)
    lo = np.linspace(0, 2 * np.pi, n_lon, endpoint=False, dtype=np.float32)
    gl, go = np.meshgrid(la, lo, indexing="ij")
    pos = radius * np.stack(
        [np.sin(gl) * np.cos(go), np.cos(gl), np.sin(gl) * np.sin(go)], -1
    ).reshape(-1, 3)
    idx = []
    for r in range(n_lat):
        a = r * n_lon + np.arange(n_lon, dtype=np.uint32)
        b = r * n_lon + (np.arange(n_lon, dtype=np.uint32) + 1) % n_lon
        c = a + n_lon
        d = b + n_lon
        idx.append(np.stack([a, c, d, a, d, b], -1).reshape(-1))
    return pos.astype(np.float32), np.concatenate(idx).astype(np.uint32)


def _add_mesh(scene: Scene, pos, idx, material: Material, transform=None):
    """Register a raw triangle mesh + material on the scene graph."""
    nrm = _vertex_normals(pos, idx)
    scene.add_raw_mesh(pos, nrm, idx, material, transform)


def _vertex_normals(pos, idx):
    tri = idx.reshape(-1, 3)
    fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]], pos[tri[:, 2]] - pos[tri[:, 0]])
    n = np.zeros_like(pos)
    for k in range(3):
        np.add.at(n, tri[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n.astype(np.float32)


def _mat(base=(0.8, 0.8, 0.8), **kw) -> Material:
    m = Material()
    m.base_colour_factor = np.array(list(base) + [1.0], np.float32)
    for k, v in kw.items():
        setattr(m, k, v)
    return m


def hall_scene(detail: int = 80, with_emissive: bool = True) -> Scene:
    """Sponza-class colonnade hall (config 4 stand-in).

    ``detail=80`` yields ~256k triangles: subdivided floor/walls/ceiling,
    two rows of fluted columns, a vaulted sky opening with an emissive
    panel.  Structured architecture like the real atrium — coherent
    primary-beam behaviour, long secondary paths.
    """
    s = Scene()
    d = detail
    L, W, H = 20.0, 8.0, 6.0  # hall length, width, height
    bump = lambda gx, gz: 0.02 * np.sin(gx * 7.1) * np.cos(gz * 5.3)

    floor_m = _mat((0.55, 0.5, 0.45), roughness_factor=0.8)
    wall_m = _mat((0.7, 0.65, 0.6), roughness_factor=0.9)
    ceil_m = _mat((0.6, 0.6, 0.62), roughness_factor=0.9)
    col_m = _mat((0.75, 0.72, 0.68), roughness_factor=0.6)

    # floor + ceiling (bumped grids)
    pos, idx = _grid_mesh(3 * d, d, L, W, bump)
    _add_mesh(s, pos - np.array([L / 2, 0, W / 2], np.float32), idx, floor_m)
    pos, idx = _grid_mesh(3 * d, d, L, W, bump)
    p = pos - np.array([L / 2, 0, W / 2], np.float32)
    p[:, 1] = H - p[:, 1]
    _add_mesh(s, p, idx[::-1].copy(), ceil_m)

    # side walls (vertical grids)
    for zside in (-W / 2, W / 2):
        pos, idx = _grid_mesh(3 * d, d // 2, L, H, bump)
        p = np.stack(
            [pos[:, 0] - L / 2, pos[:, 2], np.full(len(pos), zside, np.float32)
             + pos[:, 1] * np.sign(zside)],
            -1,
        )
        _add_mesh(s, p, idx if zside < 0 else idx[::-1].copy(), wall_m)
    # end walls
    for xside in (-L / 2, L / 2):
        pos, idx = _grid_mesh(d, d // 2, W, H, None)
        p = np.stack(
            [np.full(len(pos), xside, np.float32), pos[:, 2], pos[:, 0] - W / 2], -1
        )
        _add_mesh(s, p, idx if xside > 0 else idx[::-1].copy(), wall_m)

    # two colonnade rows of fluted columns
    n_cols = 8
    for i in range(n_cols):
        x = -L / 2 + (i + 0.5) * (L / n_cols)
        for z in (-W / 4, W / 4):
            pos, idx = _cylinder_mesh(max(12, d // 2), d, 0.35, H)
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = [x, 0.0, z]
            _add_mesh(s, pos, idx, col_m, t)

    # central glossy sphere (secondary-bounce interest)
    pos, idx = _sphere_mesh(d, 2 * d, 1.0)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.0, 1.2, 0.0]
    _add_mesh(s, pos, idx, _mat((0.9, 0.75, 0.4), metallic_factor=0.9,
                                roughness_factor=0.25), t)

    if with_emissive:
        # emissive ceiling panel (area light -> NEE + MIS paths)
        em = _mat((0.0, 0.0, 0.0))
        em.emissive_factor = np.array([8.0, 7.5, 7.0], np.float32)
        pos, idx = _grid_mesh(4, 4, L * 0.6, W * 0.4)
        p = pos - np.array([L * 0.3, 0, W * 0.2], np.float32)
        p[:, 1] = H - 0.01
        _add_mesh(s, p, idx[::-1].copy(), em)
    return s


def dragon_scene(detail: int = 256) -> Scene:
    """Dragon-class single high-poly mesh (config 2 stand-in).

    A displaced sphere ("rock dragon"): one connected dense BLAS-style mesh,
    ~262k triangles at detail=256, on a ground plane.
    """
    s = Scene()

    def displace(pos):
        p = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-9)
        r = 1.0
        for f, a in ((3.0, 0.25), (7.0, 0.12), (13.0, 0.06), (29.0, 0.02)):
            r = r + a * np.sin(f * p[:, 0]) * np.cos(f * p[:, 1]) * np.sin(
                f * p[:, 2] + f
            )
        return p * r[:, None]

    pos, idx = _sphere_mesh(detail, 2 * detail, 1.0)
    pos = displace(pos).astype(np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.0, 1.3, 0.0]
    _add_mesh(s, pos, idx, _mat((0.35, 0.55, 0.3), roughness_factor=0.45), t)

    pos, idx = _grid_mesh(8, 8, 12.0, 12.0)
    _add_mesh(s, pos - np.array([6, 0, 6], np.float32), idx,
              _mat((0.6, 0.6, 0.6), roughness_factor=0.85))

    em = _mat((0.0, 0.0, 0.0))
    em.emissive_factor = np.array([12.0, 11.0, 10.0], np.float32)
    pos, idx = _grid_mesh(2, 2, 3.0, 3.0)
    p = pos - np.array([1.5, 0, 1.5], np.float32)
    p[:, 1] = 6.0
    _add_mesh(s, p, idx[::-1].copy(), em)
    return s


def sky_hdr(h: int = 64, w: int = 128) -> np.ndarray:
    """Procedural equirect HDR sky (stand-in for hilly_terrain_01_4k.hdr,
    which ships as a stripped blob): blue gradient + bright sun disc."""
    v = np.linspace(0, np.pi, h, dtype=np.float32)[:, None]
    u = np.linspace(0, 2 * np.pi, w, endpoint=False, dtype=np.float32)[None, :]
    horizon = np.clip(np.cos(v), 0, 1)
    sky = np.stack(
        [
            0.3 + 0.2 * horizon + 0 * u,
            0.45 + 0.3 * horizon + 0 * u,
            0.9 + 0.1 * horizon + 0 * u,
        ],
        axis=-1,
    ).astype(np.float32)
    sun_dir = np.array([0.3, 0.8, 0.52])
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    dirs = np.stack(
        [
            np.sin(v) * np.cos(u) + 0 * u,
            np.cos(v) + 0 * u,
            np.sin(v) * np.sin(u) + 0 * u,
        ],
        axis=-1,
    )
    cos_sun = dirs @ sun_dir
    sky += np.where(cos_sun > 0.9995, 800.0, 0.0)[..., None]
    return sky


def multi_scene(detail: int = 40) -> Scene:
    """Composed multi-model scene (config 5 stand-in): the colonnade hall
    with the displaced-sphere 'dragon' and a row of glass pieces placed via
    per-model transforms — the -m/-t/-o/-s composition workload."""
    s = hall_scene(detail=detail)

    def displace(pos):
        p = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-9)
        r = 1.0
        for f, a in ((3.0, 0.25), (7.0, 0.12), (13.0, 0.06)):
            r = r + a * np.sin(f * p[:, 0]) * np.cos(f * p[:, 1]) * np.sin(
                f * p[:, 2] + f
            )
        return p * r[:, None]

    pos, idx = _sphere_mesh(96, 192, 1.0)
    pos = displace(pos).astype(np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] *= 0.8
    t[:3, 3] = [4.0, 1.1, 0.0]
    _add_mesh(s, pos, idx, _mat((0.35, 0.55, 0.3), roughness_factor=0.45), t)

    glass = _mat((1.0, 1.0, 1.0), metallic_factor=0.0, roughness_factor=0.05)
    glass.transmission_factor = 1.0
    glass.ior = 1.45
    glass.thickness_factor = 1.0
    for i in range(4):
        pos, idx = _sphere_mesh(32, 64, 0.3)
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [-6.0 + 2.0 * i, 0.35, -1.2]
        _add_mesh(s, pos, idx, glass, t)
    return s


def chess_scene(detail: int = 32) -> Scene:
    """Chess-class transmissive scene (config 3 stand-in).

    Glass/rough-glass "pieces" (spheres + cylinders) with volume absorption
    on a checkered board — exercises transmission, TIR, Beer-Lambert and
    rough refraction exactly like the reference's chess gallery render.
    """
    s = Scene()
    # board: alternating lambertian squares
    dark = _mat((0.15, 0.12, 0.1), roughness_factor=0.4)
    light = _mat((0.85, 0.8, 0.7), roughness_factor=0.4)
    for i in range(8):
        for j in range(8):
            pos, idx = _grid_mesh(1, 1, 1.0, 1.0)
            p = pos + np.array([i - 4.0, 0.0, j - 4.0], np.float32)
            _add_mesh(s, p, idx, dark if (i + j) % 2 else light)

    glass = _mat((1.0, 1.0, 1.0), metallic_factor=0.0, roughness_factor=0.05)
    glass.transmission_factor = 1.0
    glass.ior = 1.45
    glass.thickness_factor = 1.0
    # Beer-Lambert absorption (sigma = -ln(colour)/distance, scene.cpp)
    glass.attenuation_coefficient = (
        -np.log(np.array([0.9, 0.95, 1.0], np.float32).clip(1e-4, 1.0)) / 2.0
    )

    rough_glass = _mat((1.0, 1.0, 1.0), roughness_factor=0.3)
    rough_glass.transmission_factor = 1.0
    rough_glass.ior = 1.45
    rough_glass.thickness_factor = 1.0

    metal = _mat((0.9, 0.85, 0.6), metallic_factor=1.0, roughness_factor=0.15)

    rng = np.random.default_rng(11)
    mats = [glass, rough_glass, metal]
    for k in range(12):
        i, j = int(rng.integers(0, 8)), int(rng.integers(0, 8))
        x, z = i - 3.5, j - 3.5
        m = mats[k % 3]
        pos, idx = _cylinder_mesh(2 * detail, detail, 0.28, 0.5)
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [x, 0.0, z]
        _add_mesh(s, pos, idx, m, t)
        pos, idx = _sphere_mesh(detail, 2 * detail, 0.3)
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = [x, 0.75, z]
        _add_mesh(s, pos, idx, m, t)

    em = _mat((0.0, 0.0, 0.0))
    em.emissive_factor = np.array([10.0, 10.0, 10.0], np.float32)
    pos, idx = _grid_mesh(2, 2, 4.0, 4.0)
    p = pos - np.array([2.0, 0, 2.0], np.float32)
    p[:, 1] = 7.0
    _add_mesh(s, p, idx[::-1].copy(), em)
    return s
