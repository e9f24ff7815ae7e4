"""Image I/O for the headless path: PNG write, Radiance HDR read/write.

Port of the parts of ``vulkan_raytracer_tpu/utils/image.py`` that the
headless render uses (``write_png`` :29, ``read_hdr`` :158, ``write_hdr``
:228, ``load_texture`` :274 for ``.hdr`` skyboxes), in Python + zlib +
NumPy with the same byte output.

Not ported yet: PNG/JPEG decoding (``read_png``, ``decode_texture``), which
glTF textures and non-HDR skyboxes need (ROADMAP.md Queue 1 #8).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 (or float in [0,1]) array as PNG."""
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
    payload = (
        _PNG_MAGIC
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(payload)


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


def load_texture(path: str | Path) -> np.ndarray:
    """(H, W, 4) float32 from a ``.hdr`` file, alpha 1."""
    path = Path(path)
    if path.suffix.lower() != ".hdr":
        raise NotImplementedError(
            f"{path.name}: only Radiance .hdr images load in the torch package; PNG/JPEG "
            "decoding comes with textures (ROADMAP.md Queue 1 #8)"
        )
    rgb = read_hdr(path)
    return np.dstack([rgb, np.ones(rgb.shape[:2], np.float32)])
