"""Baseline JPEG decoder — the stb_image JPEG path (image.cpp:21-43) analogue.

Port of ``vulkan_raytracer_tpu/utils/jpeg.py``, line for line (the module is
NumPy-only); its output is bit-equal to the JAX package's.

Pure Python + NumPy: sequential DCT (SOF0), Huffman entropy coding, 8-bit
precision, arbitrary chroma subsampling, restart intervals.  Progressive
(SOF2) and arithmetic-coded files are rejected with a clear error.  The
entropy scan is a Python loop (host-side asset decode, done once per
texture at load); dequantisation, IDCT and colour conversion are
vectorised over all blocks.
"""

from __future__ import annotations

import struct

import numpy as np

#: zig-zag order: zigzag index -> natural (row-major) index
_ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    np.int32,
)

# orthonormal 8-point DCT-II basis; IDCT(X) = A.T @ X @ A
_A = np.zeros((8, 8), np.float32)
for _k in range(8):
    for _n in range(8):
        c = np.sqrt(0.125) if _k == 0 else 0.5
        _A[_k, _n] = c * np.cos((2 * _n + 1) * _k * np.pi / 16.0)


class JPEGError(ValueError):
    pass


class _Huff:
    """Canonical Huffman table with a (length, code) -> symbol dict."""

    def __init__(self, counts, symbols):
        self.lut = {}
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.lut[(length, code)] = symbols[k]
                code += 1
                k += 1
            code <<= 1


class _BitReader:
    """MSB-first reader over the byte-unstuffed entropy segment."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bits = 0
        self.nbits = 0

    def read_bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.data):
                return 0  # pad past EOS like libjpeg
            self.bits = self.data[self.pos]
            self.pos += 1
            self.nbits = 8
        self.nbits -= 1
        return (self.bits >> self.nbits) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def decode(self, huff: _Huff) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.read_bit()
            sym = huff.lut.get((length, code))
            if sym is not None:
                return sym
        raise JPEGError("invalid Huffman code")


def _extend(v: int, n: int) -> int:
    """JPEG sign extension (ITU T.81 F.2.2.1)."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG to (H, W, 3) uint8 RGB (or (H, W, 1) grey)."""
    if data[:2] != b"\xff\xd8":
        raise JPEGError("not a JPEG")
    pos = 2
    qt = {}
    huff_dc, huff_ac = {}, {}
    frame = None
    restart_interval = 0

    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            break
        (seglen,) = struct.unpack_from(">H", data, pos)
        body = data[pos + 2 : pos + seglen]
        pos += seglen
        if marker == 0xDB:  # DQT
            o = 0
            while o < len(body):
                pq, tq = body[o] >> 4, body[o] & 15
                o += 1
                if pq:
                    tbl = np.frombuffer(body, ">u2", 64, o).astype(np.float32)
                    o += 128
                else:
                    tbl = np.frombuffer(body, np.uint8, 64, o).astype(np.float32)
                    o += 64
                qt[tq] = tbl
        elif marker == 0xC4:  # DHT
            o = 0
            while o < len(body):
                tc, th = body[o] >> 4, body[o] & 15
                counts = list(body[o + 1 : o + 17])
                n = sum(counts)
                syms = list(body[o + 17 : o + 17 + n])
                (huff_dc if tc == 0 else huff_ac)[th] = _Huff(counts, syms)
                o += 17 + n
        elif marker == 0xC0 or marker == 0xC1:  # SOF0/1 baseline
            prec, h, w, nc = body[0], *struct.unpack_from(">HH", body, 1), body[5]
            if prec != 8:
                raise JPEGError("only 8-bit JPEG supported")
            comps = []
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k : 9 + 3 * k]
                comps.append(dict(id=cid, hs=hv >> 4, vs=hv & 15, tq=tq))
            frame = dict(h=h, w=w, comps=comps)
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise JPEGError("only baseline (SOF0) JPEG supported")
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack_from(">H", body, 0)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise JPEGError("SOS before SOF")
            ns = body[0]
            scan = []
            for k in range(ns):
                cs, tt = body[1 + 2 * k], body[2 + 2 * k]
                comp = next(c for c in frame["comps"] if c["id"] == cs)
                scan.append((comp, tt >> 4, tt & 15))
            return _decode_scan(
                data, pos, frame, scan, qt, huff_dc, huff_ac, restart_interval
            )
    raise JPEGError("no scan data found")


def _fancy_up2(p: np.ndarray, axis: int) -> np.ndarray:
    """libjpeg triangle 2x upsample: out pairs = (3*c + neighbour + 2) / 4."""
    if axis == 1:
        p = p.T
    prev = np.vstack([p[:1], p[:-1]])
    nxt = np.vstack([p[1:], p[-1:]])
    out = np.empty((p.shape[0] * 2, p.shape[1]), p.dtype)
    out[0::2] = (3.0 * p + prev) * 0.25
    out[1::2] = (3.0 * p + nxt) * 0.25
    return out.T if axis == 1 else out


def _decode_scan(data, pos, frame, scan, qt, huff_dc, huff_ac, restart_interval):
    # unstuff the entropy segment (FF00 -> FF; stop at any other marker)
    out = bytearray()
    restarts = []  # byte offsets in `out` where RSTn occurred
    i = pos
    while i < len(data):
        b = data[i]
        if b == 0xFF:
            nxt = data[i + 1] if i + 1 < len(data) else 0xD9
            if nxt == 0x00:
                out.append(0xFF)
                i += 2
                continue
            if 0xD0 <= nxt <= 0xD7:
                restarts.append(len(out))
                i += 2
                continue
            break
        out.append(b)
        i += 1

    h, w = frame["h"], frame["w"]
    comps = frame["comps"]
    hmax = max(c["hs"] for c in comps)
    vmax = max(c["vs"] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))

    # coefficient planes per component (in 8x8 blocks)
    planes = []
    for c in comps:
        bw = mcux * c["hs"]
        bh = mcuy * c["vs"]
        planes.append(np.zeros((bh * bw, 64), np.int32))

    rdr = _BitReader(bytes(out))
    pred = [0] * len(comps)
    mcu_index = 0
    next_restart = iter(restarts)
    pending_restart = next(next_restart, None)
    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and mcu_index and mcu_index % restart_interval == 0:
                # re-align to the byte after the RST marker
                if pending_restart is not None:
                    rdr.pos = pending_restart
                    rdr.nbits = 0
                    pending_restart = next(next_restart, None)
                pred = [0] * len(comps)
            mcu_index += 1
            for ci, (comp, tdc, tac) in enumerate(scan):
                for by in range(comp["vs"]):
                    for bx in range(comp["hs"]):
                        blk = np.zeros(64, np.int32)
                        s = rdr.decode(huff_dc[tdc])
                        diff = _extend(rdr.read(s), s)
                        pred[ci] += diff
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = rdr.decode(huff_ac[tac])
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break  # EOB
                            k += r
                            if k > 63:
                                break
                            blk[k] = _extend(rdr.read(s), s)
                            k += 1
                        row = my * comp["vs"] + by
                        col = mx * comp["hs"] + bx
                        planes[ci][row * (mcux * comp["hs"]) + col] = blk

    # dequant + IDCT, vectorised over every block of each component
    imgs = []
    for ci, comp in enumerate(comps):
        q = qt[comp["tq"]]
        coef = planes[ci].astype(np.float32) * q[None, :]
        nat = np.zeros_like(coef)
        nat[:, _ZIGZAG] = coef
        blocks = nat.reshape(-1, 8, 8)
        pix = np.einsum("kn,bkl,lm->bnm", _A, blocks, _A, optimize=True) + 128.0
        bw = mcux * comp["hs"]
        bh = mcuy * comp["vs"]
        plane = (
            pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        )
        # upsample to full MCU-aligned resolution; 2x uses libjpeg-style
        # triangle ("fancy") upsampling, other ratios nearest
        ry, rx = vmax // comp["vs"], hmax // comp["hs"]
        if rx == 2:
            plane = _fancy_up2(plane, axis=1)
        elif rx > 1:
            plane = np.repeat(plane, rx, axis=1)
        if ry == 2:
            plane = _fancy_up2(plane, axis=0)
        elif ry > 1:
            plane = np.repeat(plane, ry, axis=0)
        imgs.append(plane[: mcuy * vmax * 8, : mcux * hmax * 8])

    if len(imgs) == 1:
        y = np.clip(imgs[0][:h, :w], 0, 255).astype(np.uint8)
        return y[..., None]
    y, cb, cr = (p[:h, :w] for p in imgs[:3])
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
