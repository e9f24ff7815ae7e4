"""glTF import in the torch port against the JAX package.

The host side (``utils/image.py`` PNG decoding, ``utils/jpeg.py``,
``scene/gltf.py``, ``Scene.load_model``, the CLI's model composition) is
NumPy in both packages, so it is held to bit-equality: equal arrays, equal
dtypes, equal bytes.  The containers are the ones the JAX tests build
(``tests/test_textured_glb.py``, ``tests/test_bigasset_glb.py``), written here
by the jax-free ``tools/torch_glb_assets.py``, whose bytes are held against
the JAX tests' build functions.  The render of the small gallery container is held to
RMSE < 2e-3 against the JAX render and the NumPy oracle (measured ~5e-7),
ray counts within 0.1%.
"""

import base64
import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest

import test_bigasset_glb
import test_textured_glb
from test_torch_scene import _assert_same_tables
from vulkan_raytracer_tpu import cli as jcli
from vulkan_raytracer_tpu.render import oracle
from vulkan_raytracer_tpu.render.renderer import render_image as jrender_image
from vulkan_raytracer_tpu.scene import gltf as jgltf
from vulkan_raytracer_tpu.scene import scenegraph as jsg
from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
from vulkan_raytracer_tpu.utils import image as jimage
from vulkan_raytracer_tpu.utils import jpeg as jjpeg
from vulkan_raytracer_tpu_torch import cli as tcli
from vulkan_raytracer_tpu_torch.render.renderer import render_image
from vulkan_raytracer_tpu_torch.scene import gltf as tgltf
from vulkan_raytracer_tpu_torch.scene import scenegraph as tsg
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.scene.convert import tables_from_numpy
from vulkan_raytracer_tpu_torch.utils import image as timage
from vulkan_raytracer_tpu_torch.utils import jpeg as tjpeg

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import torch_glb_assets  # noqa: E402

PIL_Image = pytest.importorskip("PIL.Image")
RMSE_BAR = 2e-3


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# PNG: every filter type, bit depth and colour type read_png handles
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(samples, ctype, depth, palette=None, trns=None):
    """A PNG of (H, W, C) samples whose rows cycle through filter types
    0-4 (None, Sub, Up, Average, Paeth)."""
    h, w, c = samples.shape
    dt = ">u2" if depth == 16 else np.uint8
    rows = np.ascontiguousarray(samples.astype(dt)).view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = c * depth // 8
    raw = b""
    prev = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        r, f = rows[y], y % 5
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) >> 1, _paeth(left, prev, upleft)][f]
        raw += bytes([f]) + ((r - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = r

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                             0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


_PNG_CASES = {  # name: (colour type, bit depth, channels, palette, tRNS)
    "grey8": (0, 8, 1, False, False), "grey16": (0, 16, 1, False, False),
    "rgb8": (2, 8, 3, False, False), "rgb16": (2, 16, 3, False, False),
    "palette": (3, 8, 1, True, False), "palette_trns": (3, 8, 1, True, True),
    "grey_alpha8": (4, 8, 2, False, False), "grey_alpha16": (4, 16, 2, False, False),
    "rgba8": (6, 8, 4, False, False), "rgba16": (6, 16, 4, False, False),
}


@pytest.mark.parametrize("case", sorted(_PNG_CASES))
def test_read_png_matches_jax(case):
    ctype, depth, c, has_pal, has_trns = _PNG_CASES[case]
    r = np.random.default_rng(len(case))
    h, w = 11, 7
    hi = 2**depth if not has_pal else 12
    samples = r.integers(0, hi, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)
    samples[:, :3] = samples[:, :1]  # runs, so Sub/Paeth see equal neighbours
    palette = r.integers(0, 256, (12, 3)) if has_pal else None
    trns = r.integers(0, 256, 9) if has_trns else None  # shorter than the palette
    data = _png(samples, ctype, depth, palette, trns)
    got = timage.read_png(data)
    _same(got, jimage.read_png(data), case)
    if has_pal:  # the encoder is right: the decode gives the image back
        want = palette[samples[..., 0]].astype(np.uint8)
        if has_trns:
            lut = np.full(12, 255, np.uint8)
            lut[:9] = trns
            want = np.dstack([want, lut[samples[..., 0]]])
        _same(got, want)
    else:
        _same(got, samples)
    _same(timage.decode_texture(data), jimage.decode_texture(data), case)


def test_read_png_rejects_what_jax_rejects():
    good = _png(np.zeros((2, 2, 3), np.uint8), 2, 8)
    interlaced = good.replace(struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0),
                              struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1))
    for data, match in ((b"not a png at all", "not a PNG"),
                        (good.replace(b"IHDR", b"IHDX"), "IHDR"),
                        (interlaced, "interlaced")):
        for mod in (timage, jimage):
            with pytest.raises(ValueError, match=match):
                mod.read_png(data)


# ---------------------------------------------------------------------------
# JPEG: the baseline decoder, bit for bit
# ---------------------------------------------------------------------------


def _photo():
    r = np.random.default_rng(0)
    base = np.zeros((50, 70, 3), np.uint8)
    base[..., 0] = np.linspace(0, 255, 70, dtype=np.uint8)[None, :]
    base[..., 1] = np.linspace(0, 255, 50, dtype=np.uint8)[:, None]
    base[10:30, 20:50, 2] = 200
    return base + r.integers(0, 30, base.shape, dtype=np.uint8)


_JPEG_CASES = {  # name: PIL save options
    "444_q95": dict(quality=95, subsampling=0),
    "420_q85": dict(quality=85, subsampling=2),
    "422_q75": dict(quality=75, subsampling=1),
    "420_restart2": dict(quality=90, subsampling=2, restart_marker_blocks=2),
    "grey_q90": dict(quality=90),
}


@pytest.mark.parametrize("case", sorted(_JPEG_CASES))
def test_decode_jpeg_matches_jax(case):
    img = _photo()[..., 0] if case.startswith("grey") else _photo()
    buf = io.BytesIO()
    PIL_Image.fromarray(img).save(buf, "JPEG", **_JPEG_CASES[case])
    data = buf.getvalue()
    if "restart" in case:
        assert b"\xff\xdd" in data  # a DRI segment
    got = tjpeg.decode_jpeg(data)
    _same(got, jjpeg.decode_jpeg(data), case)
    assert got.shape[:2] == img.shape[:2]
    _same(timage.decode_texture(data), jimage.decode_texture(data), case)


def test_decode_jpeg_rejects_progressive():
    buf = io.BytesIO()
    PIL_Image.fromarray(_photo()).save(buf, "JPEG", progressive=True)
    with pytest.raises(tjpeg.JPEGError, match="baseline"):
        tjpeg.decode_jpeg(buf.getvalue())


# ---------------------------------------------------------------------------
# The containers: the jax-free writer against the JAX tests' build functions
# ---------------------------------------------------------------------------


def _checker_u8(n, c0, c1):
    return (np.clip(test_textured_glb._checker(n, c0, c1), 0, 1) * 255 + 0.5).astype(np.uint8)


@pytest.mark.parametrize("asset,n,c0,c1", [
    ("textured_checker.jpg", 8, [0.1, 0.8, 0.3], [0.9, 0.9, 0.1]),  # test_textured_glb.py:133
    ("bigasset_checker.jpg", 16, [0.2, 0.7, 0.3], [0.9, 0.8, 0.2]),  # test_bigasset_glb.py:159
])
def test_committed_jpegs_are_the_jax_tests_jpegs(asset, n, c0, c1):
    """The committed JPEG is PIL's quality-95 encoding of the JAX test's
    checker pixels, i.e. what ``_jpeg_bytes`` embeds in its containers."""
    want = test_textured_glb._jpeg_bytes(_checker_u8(n, c0, c1))
    assert (ROOT / "tools" / "assets" / asset).read_bytes() == want


@pytest.fixture
def committed_jpegs(monkeypatch):
    """Make the JAX tests' build functions embed the committed JPEGs."""
    by_size = {8: torch_glb_assets.TEXTURED_JPEG.read_bytes(),
               16: torch_glb_assets.BIGASSET_JPEG.read_bytes()}

    def jpeg_bytes(arr):
        return by_size[arr.shape[0]]

    monkeypatch.setattr(test_textured_glb, "_jpeg_bytes", jpeg_bytes)
    monkeypatch.setattr(test_bigasset_glb, "_jpeg_bytes", jpeg_bytes)


@pytest.mark.parametrize("which", ["textured", "bigasset_small", "bigasset"])
def test_glb_writer_matches_jax_build_functions(which, committed_jpegs, tmp_path):
    out = tmp_path / "writer"
    out.mkdir()
    if which == "textured":
        want = test_textured_glb.build_textured_glb(tmp_path)
        got = torch_glb_assets.write_textured_glb(out)
    else:
        big = which == "bigasset"
        want = test_bigasset_glb.build_bigasset_glb(tmp_path, big=big)
        got = torch_glb_assets.write_bigasset_glb(out, big=big)
    assert got.read_bytes() == want.read_bytes()


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    d = tmp_path_factory.mktemp("glb")
    return {"textured": torch_glb_assets.write_textured_glb(d),
            "bigasset_small": torch_glb_assets.write_bigasset_glb(d, big=False),
            "bigasset": torch_glb_assets.write_bigasset_glb(d, big=True)}


# ---------------------------------------------------------------------------
# gltf.py: accessors, indices, transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["textured", "bigasset"])
def test_accessors_and_transforms_match_jax(which, containers):
    """Every accessor (sparse, interleaved, u16/u32 indices) and every
    primitive's indices, node transform and light slot, bit-equal."""
    tg, jg = tgltf.GLTF.load(containers[which]), jgltf.GLTF.load(containers[which])
    assert tg.doc == jg.doc and len(tg.buffers) == len(jg.buffers) == 1
    n_acc = len(tg.doc["accessors"])
    assert n_acc > 20
    for i in range(n_acc):
        _same(tg.accessor(i), jg.accessor(i), f"accessor {i}")
    for mesh in tg.meshes:
        for prim in mesh["primitives"]:
            _same(tg.primitive_indices(prim), jg.primitive_indices(prim))
    for node in tg.nodes:
        _same(tgltf.node_local_transform(node), jgltf.node_local_transform(node))
        assert tg.node_light(node) == jg.node_light(node)
    assert tg.scene_root_nodes() == jg.scene_root_nodes()


def test_node_transforms_and_quaternions_match_jax():
    r = np.random.default_rng(4)
    for q in [*r.normal(size=(50, 4)), (0.0, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0)]:
        _same(tgltf.quat_to_mat4(*map(float, q)), jgltf.quat_to_mat4(*map(float, q)))
    nodes = [
        {"matrix": r.normal(size=16).tolist()},
        {"translation": [1.0, -2.0, 0.5], "rotation": [0.1, 0.7, -0.2, 0.68],
         "scale": [2.0, 0.5, 1.5]},
        {"rotation": [0.0, 0.3826834, 0.0, 0.9238795]},
        {"scale": [3.0, 3.0, 3.0]},
        {},
    ]
    for node in nodes:
        _same(tgltf.node_local_transform(node), jgltf.node_local_transform(node))


# ---------------------------------------------------------------------------
# Scene.load_model: the host pools
# ---------------------------------------------------------------------------


def _assert_same_pools(ts, js):
    assert len(ts.mesh_pool) == len(js.mesh_pool)
    for tp_list, jp_list in zip(ts.mesh_pool, js.mesh_pool):
        assert len(tp_list) == len(jp_list)
        for tp, jp in zip(tp_list, jp_list):
            for f in ("positions", "normals", "tangents", "uvs", "indices"):
                _same(getattr(tp, f), getattr(jp, f), f)
            assert tp.material == jp.material
    assert len(ts.materials) == len(js.materials)
    for tm, jm in zip(ts.materials, js.materials):
        for f in dataclasses.fields(jm):
            want = getattr(jm, f.name)
            if isinstance(want, np.ndarray):
                _same(getattr(tm, f.name), want, f.name)
            else:
                assert getattr(tm, f.name) == want and type(getattr(tm, f.name)) is type(want)
    assert len(ts.textures) == len(js.textures)
    for tt, jt in zip(ts.textures, js.textures):
        _same(tt, jt, "texture")
    for kind in ("point_lights", "directional_lights"):
        assert len(getattr(ts, kind)) == len(getattr(js, kind))
        for tl, jl in zip(getattr(ts, kind), getattr(js, kind)):
            for f in dataclasses.fields(jl):
                _same(getattr(tl, f.name), getattr(jl, f.name), f"{kind}.{f.name}")
    tn, jn = list(ts.iter_depth_first()), list(js.iter_depth_first())
    assert [(n.mesh, n.depth) for n in tn] == [(n.mesh, n.depth) for n in jn]
    for a, b in zip(tn, jn):
        _same(a.local_transform, b.local_transform)
        _same(a.world_transform, b.world_transform)


def _both_scenes(path, transform=None):
    ts, js = tsg.Scene(), jsg.Scene()
    ts.load_model(path, transform)
    js.load_model(path, transform)
    return ts, js


def test_load_model_pools_match_jax_bigasset(containers):
    """The full 147,136-triangle container: meshes, 9 materials field by
    field (the five KHR extensions), 5 textures, nodes (host only)."""
    ts, js = _both_scenes(containers["bigasset"])
    _assert_same_pools(ts, js)
    assert len(ts.materials) == 9 and len(ts.textures) == 5
    assert sum(p.indices.shape[0] // 3 for n in ts.iter_depth_first() if n.mesh >= 0
               for p in ts.mesh_pool[n.mesh]) == 147136
    assert ts.materials[7].transmission_factor == 1.0 and ts.materials[5].anisotropy_strength == 0.8


def _gltf_with_lights(d: Path) -> Path:
    """A .gltf (JSON) with a data-URI buffer and an external one, an external
    PNG, a data-URI PNG and an image that fails to decode; u8-normalised
    texcoords in an interleaved view, a non-indexed primitive, a mesh with
    no material; point, directional and spot lights on nodes placed by a
    matrix, by TRS and under a parent."""
    pos = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]])
    nrm = np.tile(np.float32([0, 0, 1]), (4, 1))
    uv8 = np.uint8([[0, 255], [255, 255], [255, 0], [0, 0]])
    inter = b"".join(p.tobytes() + n.tobytes() + u.tobytes() + b"\x00\x00"
                     for p, n, u in zip(pos, nrm, uv8))  # 28-byte stride
    idx = np.uint16([0, 1, 2, 2, 1, 3]).tobytes()
    (d / "extra.bin").write_bytes(pos[:3].tobytes() + nrm[:3].tobytes())
    timage.write_png(d / "tex.png", np.random.default_rng(1).integers(0, 256, (4, 6, 4))
                     .astype(np.uint8))
    inline_png = timage.encode_png(np.full((2, 3, 3), 0.25, np.float32))
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 1, 4]}],
        "nodes": [
            {"mesh": 0, "translation": [0, 1, 0], "children": [2, 3],
             "rotation": [0, 0.3826834, 0, 0.9238795], "scale": [2, 2, 2]},
            {"mesh": 1, "matrix": [1, 0, 0, 0, 0, 0, -1, 0, 0, 1, 0, 0, 3, 0, 1, 1]},
            {"extensions": {"KHR_lights_punctual": {"light": 0}}, "translation": [0.5, 2, 0]},
            {"extensions": {"KHR_lights_punctual": {"light": 1}},
             "rotation": [0.2588190, 0, 0, 0.9659258]},
            {"extensions": {"KHR_lights_punctual": {"light": 2}}},
        ],
        "meshes": [
            {"name": "quad", "primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                            "TEXCOORD_0": 2},
                                             "indices": 3, "material": 0}]},
            {"name": "tri", "primitives": [{"attributes": {"POSITION": 4, "NORMAL": 5}}]},
        ],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicRoughnessTexture": {"index": 1}},
            "normalTexture": {"index": 2}, "alphaMode": "MASK", "alphaCutoff": 0.3,
            "extensions": {"KHR_materials_dispersion": {"dispersion": 0.2},
                           "KHR_materials_ior": {"ior": 1.33}}}],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": [{"uri": "tex.png"},
                   {"uri": "data:image/png;base64," + base64.b64encode(inline_png).decode()},
                   {"uri": "data:image/png;base64," + base64.b64encode(b"broken").decode()}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "type": "VEC3", "count": 4},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "type": "VEC3",
             "count": 4},
            {"bufferView": 0, "byteOffset": 24, "componentType": 5121, "type": "VEC2",
             "count": 4, "normalized": True},
            {"bufferView": 1, "componentType": 5123, "type": "SCALAR", "count": 6},
            {"bufferView": 2, "componentType": 5126, "type": "VEC3", "count": 3},
            {"bufferView": 2, "byteOffset": 36, "componentType": 5126, "type": "VEC3",
             "count": 3},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(inter), "byteStride": 28},
            {"buffer": 0, "byteOffset": len(inter), "byteLength": len(idx)},
            {"buffer": 1, "byteOffset": 0, "byteLength": 72},
        ],
        "buffers": [
            {"byteLength": len(inter) + len(idx),
             "uri": "data:application/octet-stream;base64,"
                    + base64.b64encode(inter + idx).decode()},
            {"byteLength": 72, "uri": "extra.bin"},
        ],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1, 0.5, 0.25], "intensity": 7.0, "range": 4.0},
            {"type": "directional", "intensity": 2.0},
            {"type": "spot", "intensity": 3.0},
        ]}},
    }
    p = d / "lights.gltf"
    p.write_text(json.dumps(doc))
    return p


def test_load_model_gltf_json_with_lights_matches_jax(tmp_path):
    transform = tcli.compose_transform((1.0, 2.0, 1.0), (0.9238795, 0.0, 0.3826834, 0.0),
                                       (0.5, 0.0, -1.0))
    ts, js = _both_scenes(_gltf_with_lights(tmp_path), transform)
    _assert_same_pools(ts, js)
    assert len(ts.point_lights) == len(ts.directional_lights) == 1
    assert ts.textures[2].shape == (1, 1, 4) and (ts.textures[2] == 1.0).all()  # broken image
    assert ts.textures[0].shape == (4, 6, 4) and ts.textures[1].shape == (2, 3, 4)
    assert len(ts.materials) == 1 and ts.mesh_pool[1][0].material == 0
    _same(ts.mesh_pool[1][0].indices, np.arange(3, dtype=np.uint32))
    # both packages upload it to the same columns
    tt = ts.upload("cpu")
    assert tt.has_alpha and tt.has_textures and tt.num_point == tt.num_directional == 1
    _assert_same_tables(tt, jax.tree_util.tree_map(np.asarray, js.upload()))


@pytest.mark.parametrize("which", ["textured", "bigasset_small"])
def test_upload_columns_match_jax(which, containers):
    """Every upload column (uv, em_uv, alpha.*, tex.* included) of the port
    equals the JAX upload's, and tables_from_numpy carries them over."""
    ts, js = _both_scenes(containers[which])
    jt = jax.tree_util.tree_map(np.asarray, js.upload())
    tt = ts.upload("cpu")
    assert tt.has_alpha and tt.has_blend and tt.has_textures and tt.num_emissive_tris > 0
    assert _assert_same_tables(tt, jt) > 70
    _assert_same_tables(tables_from_numpy(jt, "cpu"), jt)


# ---------------------------------------------------------------------------
# The CLI: models composed with -t/-o/-s
# ---------------------------------------------------------------------------

_COMPOSE = ["-m", "A", "-t", "0.5,0,-1", "-o", "0.9238795,0,0.3826834,0", "-s", "1,2,1",
            "-m", "B", "-t", "d", "-s", "0.5,0.5,0.5"]


def test_cli_composition_matches_jax(containers, tmp_path):
    """The same -m/-t/-o/-s list builds the same scene graph in both CLIs,
    with a PNG skybox (the port used to take .hdr skyboxes only)."""
    sky = tmp_path / "sky.png"
    timage.write_png(sky, np.random.default_rng(6).uniform(0, 1, (6, 12, 3)).astype(np.float32))
    argv = [containers["textured"] if a == "A" else containers["bigasset_small"] if a == "B"
            else a for a in _COMPOSE]
    argv = [str(a) for a in argv] + ["--skybox", str(sky), "--skybox-strength", "0.7"]
    ts = tcli.load_scene(tcli.build_parser().parse_args(argv))
    js = jcli.load_scene(jcli.build_parser().parse_args(argv))
    _assert_same_pools(ts, js)
    _same(ts.skybox, js.skybox, "skybox")
    assert ts.skybox.shape == (6, 12, 3) and ts.skybox_strength == js.skybox_strength == 0.7
    r = np.random.default_rng(5)
    for _ in range(20):
        s, q, t = r.normal(size=3), r.normal(size=4), r.normal(size=3)
        _same(tcli.compose_transform(s, q, t), jcli.compose_transform(s, q, t))
    with pytest.raises(SystemExit):
        tcli.load_scene(tcli.build_parser().parse_args(["-m", "cornell", "-m", argv[1]]))
    with pytest.raises(FileNotFoundError):
        tcli.load_scene(tcli.build_parser().parse_args(["-m", "missing.glb"]))


def test_cli_renders_composed_glb_without_jax(containers, tmp_path):
    """A 16x16 render of two composed .glb models through the CLI in a fresh
    interpreter that never imports jax or the JAX package."""
    out = tmp_path / "cli.png"
    glb = str(containers["textured"])
    argv = ["-m", glb, "-t", "0,0.2,0", "-o", "0.9961947,0,0.0871557,0", "-s", "0.8,0.8,0.8",
            "-m", glb, "-t", "0,0,-1.5", "-r", "16,16", "--spp", "2", "-b", "3",
            "-c", "0,0,2.8", "-d", "0,0,-1", "--device", "cpu", "--output", str(out)]
    code = (
        "import sys\n"
        "from vulkan_raytracer_tpu_torch import cli\n"
        f"stats = cli.run({argv!r})\n"
        "assert stats['upload']['triangles'] == 24, stats['upload']\n"
        "assert stats['image'].mean() > 1e-3\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'vulkan_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX" in proc.stdout and "Mrays/s" in proc.stdout
    assert timage.read_png(out.read_bytes()).shape == (16, 16, 3)


# ---------------------------------------------------------------------------
# The gallery container rendered
# ---------------------------------------------------------------------------


def test_bigasset_small_render_matches_jax_and_oracle(containers):
    """9,744 triangles: PNG and JPEG textures, a normal map without tangents,
    BLEND shells, anisotropy, transmission with volume, textured emissive
    panels (256 emissive triangles); 16x16, 2 spp, depth 3, as
    tests/test_bigasset_glb.py renders it."""
    ts, js = _both_scenes(containers["bigasset_small"])
    tt = ts.upload("cpu")

    def cam(cls):
        return cls(position=np.array([0.0, 1.7, 4.6]), direction=np.array([0.0, -0.28, -1.0]))

    img_t, rays_t = render_image(tt, cam(Camera), 16, 16, spp=2, max_depth=3, tonemap=False)
    img_j, rays_j = jrender_image(js.upload(), cam(JCamera), 16, 16, spp=2, max_depth=3,
                                  tonemap=False)
    img_o = oracle.render_image(tt, cam(Camera), 16, 16, spp=2, max_depth=3)
    for ref, name in ((img_j, "JAX"), (img_o, "oracle")):
        rmse = float(np.sqrt(np.mean((img_t - np.asarray(ref)) ** 2)))
        assert rmse < RMSE_BAR, f"port vs {name} RMSE {rmse}"
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (rays_t, rays_j)
    assert np.isfinite(img_t).all() and img_t.mean() > 1e-3
