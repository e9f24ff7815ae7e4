#!/usr/bin/env python3
"""Write the two generated glTF test containers without jax or PIL.

The JAX package's tests build a small textured .glb
(``tests/test_textured_glb.py`` ``build_textured_glb``) and a gallery-class
one (``tests/test_bigasset_glb.py`` ``build_bigasset_glb``).  This module
writes the same files byte for byte with NumPy, ``struct`` and the torch
port's PNG encoder, so they can be rendered where neither jax nor PIL is
installed.  The baseline JPEG each container embeds is read from
``tools/assets/`` (PIL's quality-95 encoding of the tests' checker pixels,
committed once); ``tests/test_torch_gltf.py`` holds both the JPEGs and the
containers against the JAX tests' build functions.

    python3 tools/torch_glb_assets.py OUT_DIR

writes ``textured.glb`` (12 triangles, 6 textures, MASK and BLEND alpha),
``bigasset.glb`` (147,136 triangles, 9 materials, 5 textures) and
``bigasset_small.glb`` (the same container features at a quarter of the
grid resolution) into OUT_DIR.
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path

import numpy as np

ASSETS = Path(__file__).resolve().parent / "assets"
TEXTURED_JPEG = ASSETS / "textured_checker.jpg"
BIGASSET_JPEG = ASSETS / "bigasset_checker.jpg"

FLOAT, USHORT, UINT = 5126, 5123, 5125


def _encode_png(arr) -> bytes:
    try:
        from vulkan_raytracer_tpu_torch.utils.image import encode_png
    except ImportError:  # run as a script from tools/
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        from vulkan_raytracer_tpu_torch.utils.image import encode_png
    return encode_png(arr)


class _Buf:
    """A binary buffer of 4-byte aligned sections, one bufferView each."""

    def __init__(self):
        self.data = b""
        self.views = []

    def add(self, raw: bytes, target=None) -> int:
        self.data += b"\x00" * (-len(self.data) % 4)
        view = {"buffer": 0, "byteOffset": len(self.data), "byteLength": len(raw)}
        if target:
            view["target"] = target
        self.views.append(view)
        self.data += raw
        return len(self.views) - 1


def _checker(n, c0, c1):
    y, x = np.mgrid[0:n, 0:n]
    return np.where(((x // 2 + y // 2) % 2)[..., None], c1, c0).astype(np.float32)


def _glb(doc_parts, buf: _Buf) -> bytes:
    doc = {"asset": {"version": "2.0"}, "scene": 0, **doc_parts,
           "bufferViews": buf.views, "buffers": [{"byteLength": len(buf.data)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob = buf.data + b"\x00" * (-len(buf.data) % 4)
    return (
        struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + 8 + len(blob))
        + struct.pack("<I4s", len(js), b"JSON") + js
        + struct.pack("<I4s", len(blob), b"BIN\x00") + blob
    )


def _doc(nodes, meshes, materials, images, accessors):
    """The document's keys in the order the JAX tests' build functions write them."""
    return {
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "images": images,
        "textures": [{"source": i} for i in range(len(images))],
        "accessors": accessors,
    }


# ---------------------------------------------------------------------------
# The small textured container (tests/test_textured_glb.py:83)
# ---------------------------------------------------------------------------


def _quad(cx, cy, z, half):
    pos = np.array(
        [[cx - half, cy - half, z], [cx + half, cy - half, z],
         [cx + half, cy + half, z], [cx - half, cy + half, z]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    tan = np.tile(np.array([[1, 0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    return pos, nrm, tan, uv, idx


def textured_glb_bytes(jpeg: bytes | None = None) -> bytes:
    """Four textured quads (PNG and JPEG base colour, a normal map on a
    TANGENT quad, MASK alpha, BLEND alpha with an emissive texture), an
    emissive light quad and a floor; the first quad's POSITION is a sparse
    accessor over an implicit zeros base."""
    jpeg = TEXTURED_JPEG.read_bytes() if jpeg is None else jpeg
    buf = _Buf()
    accessors, meshes, nodes = [], [], []

    def add_prim(quad, material, sparse_position=False):
        pos, nrm, tan, uv, idx = quad
        attrs = {}
        if sparse_position:
            iview = buf.add(np.arange(4, dtype=np.uint16).tobytes())
            vview = buf.add(pos.tobytes())
            accessors.append({
                "componentType": FLOAT, "type": "VEC3", "count": 4,
                "min": pos.min(0).tolist(), "max": pos.max(0).tolist(),
                "sparse": {
                    "count": 4,
                    "indices": {"bufferView": iview, "componentType": USHORT},
                    "values": {"bufferView": vview},
                },
            })
        else:
            view = buf.add(pos.tobytes(), target=34962)
            accessors.append({
                "bufferView": view, "componentType": FLOAT, "type": "VEC3",
                "count": 4, "min": pos.min(0).tolist(), "max": pos.max(0).tolist(),
            })
        attrs["POSITION"] = len(accessors) - 1
        for name, arr, typ in (("NORMAL", nrm, "VEC3"), ("TANGENT", tan, "VEC4"),
                               ("TEXCOORD_0", uv, "VEC2")):
            accessors.append({
                "bufferView": buf.add(arr.tobytes(), target=34962),
                "componentType": FLOAT, "type": typ, "count": 4,
            })
            attrs[name] = len(accessors) - 1
        accessors.append({
            "bufferView": buf.add(idx.tobytes(), target=34963),
            "componentType": USHORT, "type": "SCALAR", "count": idx.shape[0],
        })
        meshes.append({"primitives": [{
            "attributes": attrs, "indices": len(accessors) - 1, "material": material,
        }]})
        nodes.append({"mesh": len(meshes) - 1})

    png_base = _encode_png(_checker(8, [0.9, 0.2, 0.2], [0.2, 0.2, 0.9]))
    png_normal = _encode_png(np.tile(np.array([0.6, 0.0, 0.8], np.float32) * 0.5 + 0.5,
                                     (8, 8, 1)))
    mask_rgba = np.ones((8, 8, 4), np.float32) * [0.8, 0.8, 0.2, 0.9]
    mask_rgba[:, :4, 3] = 0.1
    png_mask = _encode_png(mask_rgba)
    png_blend = _encode_png(np.ones((8, 8, 4), np.float32) * [0.2, 0.9, 0.3, 0.5])
    em = np.zeros((8, 8, 3), np.float32)
    em[:, :, 0] = np.linspace(0.2, 1.0, 8)[None, :]
    em[:, :, 1] = 0.4
    png_em = _encode_png(em)

    images = [
        {"bufferView": buf.add(png_base), "mimeType": "image/png"},
        {"bufferView": buf.add(jpeg), "mimeType": "image/jpeg"},
        {"bufferView": buf.add(png_normal), "mimeType": "image/png"},
        {"bufferView": buf.add(png_mask), "mimeType": "image/png"},
        {"bufferView": buf.add(png_blend), "mimeType": "image/png"},
        {"bufferView": buf.add(png_em), "mimeType": "image/png"},
    ]
    materials = [
        {"name": "png_checker", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
            "roughnessFactor": 1.0}},
        {"name": "jpeg_normalmapped", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 1}, "metallicFactor": 0.0,
            "roughnessFactor": 0.8}, "normalTexture": {"index": 2}},
        {"name": "masked", "alphaMode": "MASK", "alphaCutoff": 0.5,
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 3}, "metallicFactor": 0.0}},
        {"name": "blended_emissive", "alphaMode": "BLEND",
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 4}, "metallicFactor": 0.0},
         "emissiveTexture": {"index": 5}, "emissiveFactor": [0.5, 0.5, 0.5]},
        {"name": "light", "emissiveFactor": [1, 1, 1],
         "pbrMetallicRoughness": {"metallicFactor": 0.0},
         "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 40.0}}},
        {"name": "floor", "pbrMetallicRoughness": {
            "baseColorFactor": [0.7, 0.7, 0.7, 1.0], "metallicFactor": 0.0}},
    ]

    add_prim(_quad(-0.55, 0.55, 0.0, 0.5), 0, sparse_position=True)
    add_prim(_quad(0.55, 0.55, 0.0, 0.5), 1)
    add_prim(_quad(-0.55, -0.55, 0.0, 0.5), 2)
    add_prim(_quad(0.55, -0.55, 0.0, 0.5), 3)
    # a small light quad above the others, facing down
    lp, _, lt, luv, lidx = _quad(0.0, 0.0, 0.0, 0.15)
    lq = (lp[:, [0, 2, 1]] * np.float32([1, 1, -1]) + np.float32([0.0, 1.5, 1.0]),
          np.tile(np.float32([0, -1, 0]), (4, 1)), lt, luv, lidx)
    add_prim(lq, 4)
    fp = np.float32([[-2, -1.3, -1], [2, -1.3, -1], [2, -1.3, 3], [-2, -1.3, 3]])
    add_prim((fp, np.tile(np.float32([0, 1, 0]), (4, 1)), lt, luv, lidx), 5)
    return _glb(_doc(nodes, meshes, materials, images, accessors), buf)


# ---------------------------------------------------------------------------
# The gallery-class container (tests/test_bigasset_glb.py:86)
# ---------------------------------------------------------------------------


def _grid_mesh(nu, nv, fn):
    """Parametric grid -> (pos, nrm, uv, idx) with analytic normals."""
    u = np.linspace(0.0, 1.0, nu + 1, dtype=np.float64)
    v = np.linspace(0.0, 1.0, nv + 1, dtype=np.float64)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    p = fn(uu, vv)
    eps = 1e-4
    du = (fn(uu + eps, vv) - fn(uu - eps, vv)) / (2 * eps)
    dv = (fn(uu, vv + eps) - fn(uu, vv - eps)) / (2 * eps)
    n = np.cross(du, dv)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    pos = p.reshape(-1, 3).astype(np.float32)
    nrm = n.reshape(-1, 3).astype(np.float32)
    uv = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    i0 = (np.arange(nu)[:, None] * (nv + 1) + np.arange(nv)[None, :]).ravel()
    quad = np.stack([i0, i0 + nv + 1, i0 + nv + 2, i0, i0 + nv + 2, i0 + 1], -1)
    return pos, nrm, uv, quad.reshape(-1).astype(np.uint32)


def _sphere(r):
    def fn(u, v):
        th, ph = u * np.pi, v * 2 * np.pi
        return np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                         r * np.sin(th) * np.sin(ph)], -1)
    return fn


def _torus(big_r, r):
    def fn(u, v):
        a, b = u * 2 * np.pi, v * 2 * np.pi
        w = big_r + r * np.cos(b)
        return np.stack([w * np.cos(a), r * np.sin(b), w * np.sin(a)], -1)
    return fn


def _terrain(sx, sz, h):
    def fn(u, v):
        y = h * (np.sin(3 * np.pi * u) * np.cos(4 * np.pi * v)
                 + 0.5 * np.sin(9 * np.pi * u * v + 1.0))
        return np.stack([sx * (u - 0.5), y, sz * (v - 0.5)], -1)
    return fn


def bigasset_glb_bytes(big: bool = True, jpeg: bytes | None = None) -> bytes:
    """Spheres, tori, a terrain, BLEND shells, a two-primitive pedestal,
    emissive panels, a glass sphere and a floor over 12 nodes (node reuse);
    interleaved attributes, a sparse accessor and u32 indices.  ``big=False``
    shrinks the grids to a quarter (same container features)."""
    jpeg = BIGASSET_JPEG.read_bytes() if jpeg is None else jpeg
    buf = _Buf()
    accessors, meshes, nodes = [], [], []
    s = 1.0 if big else 0.25  # grid resolution scale

    def acc(view, ctype, typ, count, **kw):
        a = {"bufferView": view, "componentType": ctype, "type": typ, "count": count}
        a.update(kw)
        accessors.append(a)
        return len(accessors) - 1

    def add_mesh(prims):
        meshes.append({"primitives": prims})
        return len(meshes) - 1

    def add_prim(pos, nrm, uv, idx, material, *, interleave=False, sparse=False,
                 force_u32=False):
        n = pos.shape[0]
        if interleave:
            # one bufferView, byteStride 32: pos(12) nrm(12) uv(8)
            inter = np.concatenate([pos, nrm, uv], axis=1).astype(np.float32)
            view = buf.add(inter.tobytes(), target=34962)
            buf.views[view]["byteStride"] = 32
            ap = acc(view, FLOAT, "VEC3", n, min=pos.min(0).tolist(), max=pos.max(0).tolist())
            an = acc(view, FLOAT, "VEC3", n, byteOffset=12)
            at = acc(view, FLOAT, "VEC2", n, byteOffset=24)
        else:
            base = pos
            if sparse:
                # a real base view + a sparse patch moving every 16th vertex
                k = max(n // 16, 1)
                sel = np.arange(0, n, 16, dtype=np.uint32)[:k]
                patched = pos[sel] * 1.15
                base = pos.copy()
                vb = buf.add(base.tobytes(), target=34962)
                iv = buf.add(sel.astype(np.uint32).tobytes())
                vv = buf.add(patched.astype(np.float32).tobytes())
                final = base.copy()
                final[sel] = patched
                accessors.append({
                    "bufferView": vb, "componentType": FLOAT, "type": "VEC3",
                    "count": n, "min": final.min(0).tolist(), "max": final.max(0).tolist(),
                    "sparse": {
                        "count": int(k),
                        "indices": {"bufferView": iv, "componentType": UINT},
                        "values": {"bufferView": vv},
                    },
                })
                ap = len(accessors) - 1
            else:
                vb = buf.add(base.tobytes(), target=34962)
                ap = acc(vb, FLOAT, "VEC3", n, min=pos.min(0).tolist(), max=pos.max(0).tolist())
            an = acc(buf.add(nrm.tobytes(), target=34962), FLOAT, "VEC3", n)
            at = acc(buf.add(uv.tobytes(), target=34962), FLOAT, "VEC2", n)
        if force_u32 or idx.max() > 65535:
            ai = acc(buf.add(idx.astype(np.uint32).tobytes(), target=34963), UINT, "SCALAR",
                     idx.shape[0])
        else:
            ai = acc(buf.add(idx.astype(np.uint16).tobytes(), target=34963), USHORT, "SCALAR",
                     idx.shape[0])
        return {"attributes": {"POSITION": ap, "NORMAL": an, "TEXCOORD_0": at},
                "indices": ai, "material": material}

    png_base = _encode_png(_checker(16, [0.85, 0.3, 0.2], [0.2, 0.3, 0.85]))
    png_normal = _encode_png(np.tile(np.float32([0.55, 0.0, 0.835]) * 0.5 + 0.5, (8, 8, 1)))
    em = np.zeros((8, 8, 3), np.float32)
    em[:, :, 0] = np.linspace(0.3, 1.0, 8)[None, :]
    em[:, :, 1] = np.linspace(1.0, 0.4, 8)[:, None]
    png_em = _encode_png(em)
    png_blend = _encode_png(np.ones((8, 8, 4), np.float32) * [0.3, 0.8, 0.9, 0.45])

    images = [
        {"bufferView": buf.add(png_base), "mimeType": "image/png"},
        {"bufferView": buf.add(jpeg), "mimeType": "image/jpeg"},
        {"bufferView": buf.add(png_normal), "mimeType": "image/png"},
        {"bufferView": buf.add(png_em), "mimeType": "image/png"},
        {"bufferView": buf.add(png_blend), "mimeType": "image/png"},
    ]
    materials = [
        {"name": "sphere_png_nrm", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
            "roughnessFactor": 0.7}, "normalTexture": {"index": 2}},
        {"name": "torus_jpeg_metal", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 1}, "metallicFactor": 0.9,
            "roughnessFactor": 0.35}},
        {"name": "terrain", "pbrMetallicRoughness": {
            "baseColorFactor": [0.45, 0.5, 0.4, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.9}},
        {"name": "blend_glassy", "alphaMode": "BLEND",
         "pbrMetallicRoughness": {"baseColorTexture": {"index": 4}, "metallicFactor": 0.0}},
        {"name": "pedestal_top", "pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.75, 0.6, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.5}},
        {"name": "pedestal_aniso", "pbrMetallicRoughness": {
            "baseColorFactor": [0.7, 0.7, 0.75, 1.0], "metallicFactor": 1.0,
            "roughnessFactor": 0.3},
         "extensions": {"KHR_materials_anisotropy": {
             "anisotropyStrength": 0.8, "anisotropyRotation": 0.6}}},
        {"name": "panel_emissive", "emissiveFactor": [1, 1, 1],
         "emissiveTexture": {"index": 3},
         "pbrMetallicRoughness": {"metallicFactor": 0.0},
         "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 60.0}}},
        {"name": "glass", "pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1], "metallicFactor": 0.0, "roughnessFactor": 0.05},
         "extensions": {
             "KHR_materials_transmission": {"transmissionFactor": 1.0},
             "KHR_materials_volume": {
                 "thicknessFactor": 0.4, "attenuationColor": [0.9, 0.95, 1.0],
                 "attenuationDistance": 2.0},
             "KHR_materials_ior": {"ior": 1.5}}},
        {"name": "floor", "pbrMetallicRoughness": {
            "baseColorFactor": [0.65, 0.65, 0.65, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 1.0}},
    ]

    def g(nu, nv):
        return max(int(nu * s), 8), max(int(nv * s), 8)

    m_sphere = add_mesh([add_prim(*_grid_mesh(*g(104, 104), _sphere(0.5)), 0, interleave=True)])
    m_torus = add_mesh([add_prim(*_grid_mesh(*g(96, 88), _torus(0.42, 0.16)), 1,
                                 force_u32=True)])
    m_terrain = add_mesh([add_prim(*_grid_mesh(*g(160, 160), _terrain(7.0, 7.0, 0.22)), 2)])
    m_blend = add_mesh([add_prim(*_grid_mesh(*g(48, 48), _sphere(0.38)), 3, sparse=True)])
    top = _grid_mesh(*g(16, 16), lambda u, v: np.stack(
        [0.6 * (u - 0.5), 0.22 + 0 * u, 0.6 * (v - 0.5)], -1))
    side = _grid_mesh(*g(24, 12), lambda u, v: np.stack(
        [0.3 * np.cos(u * 2 * np.pi), 0.22 * v, 0.3 * np.sin(u * 2 * np.pi)], -1))
    m_pedestal = add_mesh([add_prim(*top, 4), add_prim(*side, 5)])
    panel = _grid_mesh(8, 8, lambda u, v: np.stack([0.8 * (u - 0.5), 0 * u, 0.8 * (v - 0.5)], -1))
    m_panel = add_mesh([add_prim(*panel, 6)])
    m_glass = add_mesh([add_prim(*_grid_mesh(*g(64, 64), _sphere(0.42)), 7)])
    floor = _grid_mesh(8, 8, lambda u, v: np.stack([9.0 * (u - 0.5), 0 * u, 9.0 * (v - 0.5)], -1))
    m_floor = add_mesh([add_prim(*floor, 8)])

    def node(mesh, t=None, r=None, sc=None):
        nd = {"mesh": mesh}
        if t is not None:
            nd["translation"] = t
        if r is not None:
            nd["rotation"] = r
        if sc is not None:
            nd["scale"] = sc
        nodes.append(nd)

    node(m_terrain, t=[0.0, -0.05, 0.0])
    node(m_floor, t=[0.0, -0.3, 0.0])
    node(m_sphere, t=[-1.2, 0.75, 0.2])
    node(m_sphere, t=[1.25, 0.8, -0.5], sc=[1.2, 1.2, 1.2])
    node(m_torus, t=[0.0, 0.45, 0.9], r=[0.0, 0.3826834, 0.0, 0.9238795])
    node(m_torus, t=[-0.2, 0.5, -1.4], sc=[0.8, 0.8, 0.8])
    node(m_blend, t=[0.85, 0.6, 0.85])
    node(m_blend, t=[-0.9, 0.55, -0.9], sc=[0.7, 0.7, 0.7])
    node(m_pedestal, t=[0.0, 0.0, 0.0])
    node(m_glass, t=[0.0, 0.75, 0.0])
    # panel normals are -y by construction (du x dv): they face the scene
    node(m_panel, t=[-1.0, 2.6, 0.3])
    node(m_panel, t=[1.4, 2.4, -0.6], sc=[0.7, 0.7, 0.7])
    return _glb(_doc(nodes, meshes, materials, images, accessors), buf)


def write_textured_glb(out_dir) -> Path:
    p = Path(out_dir) / "textured.glb"
    p.write_bytes(textured_glb_bytes())
    return p


def write_bigasset_glb(out_dir, big: bool = True) -> Path:
    p = Path(out_dir) / ("bigasset.glb" if big else "bigasset_small.glb")
    p.write_bytes(bigasset_glb_bytes(big))
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(argv[0])
    out.mkdir(parents=True, exist_ok=True)
    for p in (write_textured_glb(out), write_bigasset_glb(out, big=True),
              write_bigasset_glb(out, big=False)):
        print(p, p.stat().st_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
