"""The port's host helpers against the JAX package's: the camera matrices
and the image files of the headless path.  Both are NumPy, so they are held
to bit-equality (equal arrays, equal bytes)."""

import numpy as np
import pytest

from vulkan_raytracer_tpu.render.renderer import camera_uniforms as jcamera_uniforms
from vulkan_raytracer_tpu.scene.camera import Camera as JCamera
from vulkan_raytracer_tpu.utils import image as jimage
from vulkan_raytracer_tpu.utils import logging as jlogging
from vulkan_raytracer_tpu_torch.render.renderer import camera_uniforms
from vulkan_raytracer_tpu_torch.scene.camera import Camera
from vulkan_raytracer_tpu_torch.utils import image as timage
from vulkan_raytracer_tpu_torch.utils import logging as tlogging

_POSES = {  # position, direction, aspect, fov (degrees)
    "cfg1": ([0.0, 1.0, 2.4], [0.0, 0.0, -1.0], 1.0, 70.0),
    "cli_default": ([0.0, 1.0, 3.0], [0.0, 0.0, -1.0], 800 / 600, 70.0),
    "oblique": ([1.3, -0.4, 2.2], [-0.5, 0.2, -0.8], 1.5, 40.0),
}


@pytest.mark.parametrize("pose", sorted(_POSES))
def test_camera_matches_jax(pose):
    pos, d, aspect, fov = _POSES[pose]
    kw = dict(position=np.array(pos), direction=np.array(d), aspect=aspect,
              fov=np.deg2rad(fov))
    jcam, tcam = JCamera(**kw), Camera(**kw)
    for got, want in zip(camera_uniforms(tcam), jcamera_uniforms(jcam)):
        assert got.dtype == np.float32 and got.shape == (4, 4)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcam.view(), jcam.view())
    np.testing.assert_array_equal(tcam.projection(), jcam.projection())


@pytest.mark.parametrize("kind", ["float", "uint8", "rgba"])
def test_write_png_matches_jax(kind, tmp_path):
    r = np.random.default_rng(3)
    img = r.uniform(-0.2, 1.2, (7, 5, 3)).astype(np.float32)
    if kind == "uint8":
        img = r.integers(0, 256, (7, 5, 3)).astype(np.uint8)
    elif kind == "rgba":
        img = r.integers(0, 256, (4, 6, 4)).astype(np.uint8)
    timage.write_png(tmp_path / "t.png", img)
    jimage.write_png(tmp_path / "j.png", img)
    data = (tmp_path / "t.png").read_bytes()
    assert data == (tmp_path / "j.png").read_bytes()
    decoded = jimage.read_png(data)
    assert decoded.shape == img.shape


def _rle_row(rgbe_row):
    """One new-style RLE scanline: per channel, a run of its first 3 values'
    first value, then the rest as literals of at most 128."""
    w = rgbe_row.shape[0]
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        ch = rgbe_row[:, c]
        out += bytes([128 + 3, int(ch[0])])
        rest = ch[3:]
        for s in range(0, len(rest), 128):
            part = rest[s:s + 128]
            out += bytes([len(part)]) + part.tobytes()
    return bytes(out)


def _hdr_files(tmp_path):
    """A flat file, a new-style RLE file and an old-style RLE file."""
    r = np.random.default_rng(5)
    h, w = 3, 20
    rgb = r.uniform(0.0, 40.0, (h, w, 3)).astype(np.float32)
    rgb[0, 4] = 0.0
    flat = tmp_path / "flat.hdr"
    timage.write_hdr(flat, rgb)
    rgbe = r.integers(1, 256, (h, w, 4)).astype(np.uint8)
    rgbe[:, :3, :] = rgbe[:, :1, :]  # the runs of _rle_row
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    new = tmp_path / "new.hdr"
    new.write_bytes(header + b"".join(_rle_row(rgbe[y]) for y in range(h)))
    old = tmp_path / "old.hdr"
    old_rows = (bytes([40, 50, 60, 130, 1, 1, 1, 7, 10, 20, 30, 129, 70, 80, 90, 131])
                + bytes([5, 6, 7, 128, 1, 1, 1, 9]))
    old.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 10\n" + old_rows)
    return rgb, {"flat": flat, "new_rle": new, "old_rle": old}


@pytest.mark.parametrize("layout", ["flat", "new_rle", "old_rle"])
def test_hdr_matches_jax(layout, tmp_path):
    rgb, files = _hdr_files(tmp_path)
    got = timage.read_hdr(files[layout])
    np.testing.assert_array_equal(got, jimage.read_hdr(files[layout]))
    assert got.dtype == np.float32 and got.max() > 0
    np.testing.assert_array_equal(timage.load_texture(files[layout]),
                                  jimage.load_texture(files[layout]))
    if layout == "flat":  # the writer's bytes are the JAX writer's
        jimage.write_hdr(tmp_path / "j.hdr", rgb)
        assert files["flat"].read_bytes() == (tmp_path / "j.hdr").read_bytes()
        # RGBE keeps 8 mantissa bits of each pixel's largest component
        assert (np.abs(got - rgb) <= rgb.max(axis=-1, keepdims=True) / 128.0 + 1e-6).all()


def test_load_texture_refuses_unported_formats(tmp_path):
    """PNG skyboxes and textures load now, equal to the JAX package's; a
    format neither package decodes is refused."""
    p = tmp_path / "sky.png"
    jimage.write_png(p, np.random.default_rng(2).integers(0, 256, (3, 5, 3)).astype(np.uint8))
    got = timage.load_texture(p)
    assert got.shape == (3, 5, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jimage.load_texture(p))
    bad = tmp_path / "sky.bmp"
    bad.write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="unrecognised image format"):
        timage.load_texture(bad)


@pytest.mark.parametrize("args", [("plain message",), ("%d rays in %.3f s", 42, 1.5)])
def test_debug_matches_jax(args, monkeypatch, capsys):
    """``debug`` prints what the JAX package's prints at the DEBUG level
    (VKRT_LOG_LEVEL=DEBUG, read at import, so the level is set on both
    modules) and nothing at INFO."""
    for mod in (jlogging, tlogging):
        monkeypatch.setattr(mod, "_LEVEL", mod._LEVELS["DEBUG"])
    jlogging.debug(*args)
    want = capsys.readouterr()
    tlogging.debug(*args)
    got = capsys.readouterr()
    assert want.out and "[DEBUG]" in want.out
    assert (got.out, got.err) == (want.out, want.err)
    for mod in (jlogging, tlogging):
        monkeypatch.setattr(mod, "_LEVEL", mod._LEVELS["INFO"])
        mod.debug(*args)
        assert capsys.readouterr().out == ""
