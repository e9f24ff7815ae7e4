"""Image I/O: PNG read/write, Radiance HDR read/write, texture decode.

Port of ``vulkan_raytracer_tpu/utils/image.py`` (``write_png`` :29,
``read_png`` :58, ``read_hdr`` :158, ``write_hdr`` :228, ``decode_texture``
:248, ``load_texture`` :274) in Python + zlib + NumPy, with the same bytes
and arrays.  JPEG textures decode through :mod:`.jpeg`.  As in the
reference (image.cpp:44-51), 8-bit texels are UNORM: value / 255, no gamma
decode.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 (or float in [0,1]) array as PNG."""
    Path(path).write_bytes(encode_png(rgb))


def encode_png(rgb: np.ndarray) -> bytes:
    """The PNG file :func:`write_png` writes, as bytes."""
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    h, w, c = arr.shape
    colour_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        return struct.pack(">I", len(data)) + tag + data + crc

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    return (
        _PNG_MAGIC
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline's PNG filter.  Sub, Average and Paeth read the left
    neighbour from the reconstructed row, so they run in bpp-wide groups."""
    if ftype == 0:
        return line
    if ftype == 2:  # Up
        return (line.astype(np.int32) + prev).astype(np.uint8)
    if ftype not in (1, 3, 4):
        raise ValueError(f"bad PNG filter {ftype}")
    stride = line.shape[0]
    la = np.zeros(stride, np.uint8)
    lf = line.astype(np.int32)
    pv = prev.astype(np.int32)
    for x in range(0, stride, bpp):
        a = la[x - bpp:x].astype(np.int32) if x >= bpp else 0
        b = pv[x:x + bpp]
        if ftype == 1:  # Sub
            v = lf[x:x + bpp] + a
        elif ftype == 3:  # Average
            v = lf[x:x + bpp] + ((a + b) >> 1)
        else:  # Paeth
            c = pv[x - bpp:x] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            v = lf[x:x + bpp] + np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        la[x:x + bpp] = (v & 0xFF).astype(np.uint8)
    return la


def read_png(data: bytes) -> np.ndarray:
    """Decode an 8/16-bit non-interlaced PNG to (H, W, C) uint8/uint16: grey,
    grey+alpha, RGB, RGBA, and palette (with tRNS alpha) images."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    idat = b""
    ihdr = palette = trns = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG missing IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG not supported")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} not supported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = zlib.decompress(idat)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    off = 0
    for y in range(h):
        line = np.frombuffer(raw, np.uint8, stride, off + 1).copy()
        prev = out[y] = _unfilter_row(raw[off], line, prev, bpp)
        off += 1 + stride
    if depth == 16:
        arr = out.reshape(h, w, channels, 2)
        img = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        img = out.reshape(h, w, channels)
    if ctype != 3:
        return img
    if palette is None:
        raise ValueError("palette PNG missing PLTE")
    rgb = palette[img[..., 0]]
    if trns is None:
        return rgb
    lut = np.full(palette.shape[0], 255, np.uint8)
    n = min(len(trns), palette.shape[0])
    lut[:n] = trns[:n]
    return np.dstack([rgb, lut[img[..., 0]]])


def read_hdr(path: str | Path) -> np.ndarray:
    """Decode a Radiance RGBE file to (H, W, 3) float32 linear radiance:
    flat scanlines, new-style RLE and old-style (1,1,1,n) repeat records."""
    data = Path(path).read_bytes()
    rest = data.split(b"\n\n", 1)[1] if b"\n\n" in data else data
    if b"-Y" not in rest[:40]:
        raise ValueError("unsupported HDR layout")
    nl = rest.index(b"\n")
    dims = rest[:nl].split()
    h, w = int(dims[1]), int(dims[3])
    payload = rest[nl + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    off = 0
    for y in range(h):
        if (
            off + 4 <= len(payload)
            and payload[off] == 2
            and payload[off + 1] == 2
            and ((payload[off + 2] << 8) | payload[off + 3]) == w
        ):
            off += 4  # new RLE: 4 component planes per scanline
            for c in range(4):
                x = 0
                while x < w:
                    count = payload[off]
                    off += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = payload[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(payload, np.uint8, count, off)
                        off += count
                        x += count
            continue
        row = np.frombuffer(payload, np.uint8, min(w * 4, len(payload) - off), off)
        px = row[:(len(row) // 4) * 4].reshape(-1, 4)
        has_old_rle = bool(np.any((px[:, 0] == 1) & (px[:, 1] == 1) & (px[:, 2] == 1)))
        if not has_old_rle and len(row) == w * 4:
            rgbe[y] = row.reshape(w, 4)
            off += w * 4
            continue
        # sequential decode: (1,1,1,n) repeats the previous pixel n times,
        # with n left-shifted 8 bits per consecutive record
        x = 0
        shift = 0
        while x < w:
            r, g, b, e = payload[off:off + 4]
            off += 4
            if r == 1 and g == 1 and b == 1:
                if x == 0 and y == 0:
                    raise ValueError("HDR old-RLE repeat with no prior pixel")
                count = e << (8 * shift)
                rgbe[y, x:x + count] = rgbe[y, x - 1] if x > 0 else rgbe[y - 1, w - 1]
                x += count
                shift += 1
            else:
                rgbe[y, x] = (r, g, b, e)
                x += 1
                shift = 0
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def write_hdr(path: str | Path, rgb: np.ndarray) -> None:
    """Encode (H, W, 3) float32 as a flat (non-RLE) Radiance file."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    maxc = rgb.max(axis=-1)
    _, e = np.frexp(maxc)  # maxc = f * 2^e, f in [0.5, 1)
    nz = maxc > 1e-32
    scale = np.where(nz, np.ldexp(np.float32(256.0), -e), 0.0).astype(np.float32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    Path(path).write_bytes(header + rgbe.tobytes())


def decode_texture(data: bytes) -> np.ndarray:
    """Decode an encoded PNG or baseline JPEG to (H, W, 4) float32 in [0, 1]
    (UNORM); 16-bit samples keep their high byte, as stb_image does."""
    if data[:8] == _PNG_MAGIC:
        img = read_png(data)
    elif data[:2] == b"\xff\xd8":
        from .jpeg import decode_jpeg

        img = decode_jpeg(data)
    else:
        raise ValueError("unrecognised image format")
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    out = np.ones((h, w, 4), np.float32)
    if c == 1:
        out[..., :3] = img.reshape(h, w, 1)
    elif c == 2:
        out[..., :3] = img[..., :1]
        out[..., 3] = img[..., 1]
    else:
        out[..., :c] = img[..., :4]
    return out


def load_texture(path: str | Path) -> np.ndarray:
    """(H, W, 4) float32 from a ``.hdr`` (alpha 1), PNG or JPEG file."""
    path = Path(path)
    if path.suffix.lower() == ".hdr":
        rgb = read_hdr(path)
        return np.dstack([rgb, np.ones(rgb.shape[:2], np.float32)])
    return decode_texture(path.read_bytes())
