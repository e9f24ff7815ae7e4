"""The 256k-triangle colonnade hall under the procedural HDR sky, frozen:
copies of ``hall_scene`` and ``sky_hdr`` of the port's
``scene/procedural.py`` (the stand-in for Crytek Sponza and
hilly_terrain_01_4k.hdr of the bench's configuration 4).  At ``detail=80``:
256,032 triangles, 32 of them emissive.  The hall is closed on all six
sides, so no path escapes to the sky: it is uploaded and fetched, and
lights nothing.  ``build``'s defaults are the port's; the configuration
asks for the 4k map's 2048 x 4096 texels."""

from __future__ import annotations

import numpy as np

from benchmark.scenedata import Material, SceneData


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


def _vertex_normals(pos, idx):
    tri = idx.reshape(-1, 3)
    fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]], pos[tri[:, 2]] - pos[tri[:, 0]])
    n = np.zeros_like(pos)
    for k in range(3):
        np.add.at(n, tri[:, k], fn)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n.astype(np.float32)


def _add_mesh(scene: SceneData, pos, idx, material: Material, transform=None):
    scene.add(pos, _vertex_normals(pos, idx), idx, material, transform)


def _mat(base=(0.8, 0.8, 0.8), **kw) -> Material:
    m = Material()
    m.base_colour_factor = np.array(list(base) + [1.0], np.float32)
    for k, v in kw.items():
        setattr(m, k, v)
    return m


def hall(detail: int = 80, with_emissive: bool = True) -> SceneData:
    """The colonnade: subdivided floor, walls and ceiling, two rows of
    fluted columns, a glossy metal sphere and an emissive ceiling panel."""
    s = SceneData()
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


def sky_hdr(h: int = 64, w: int = 128) -> np.ndarray:
    """Equirect HDR sky: a blue gradient and a bright sun disc."""
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


def build(detail: int = 80, sky_h: int = 64, sky_w: int = 128,
          sky_strength: float = 1.0) -> SceneData:
    s = hall(detail)
    s.skybox = sky_hdr(sky_h, sky_w)
    s.skybox_strength = sky_strength
    return s
