"""Minimal dependency-free PNG reader and writer (8-bit gray, RGB, RGBA).

The port's own copy of ``smolscale_tpu.utils.png``, for the CLI's
``generate`` mode: zlib, struct and numpy, no other package.  It writes the
same bytes as the JAX package's writer (filter 0 on every row, zlib level
6) and reads 8-bit non-interlaced files with any of the five row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> channels


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path, img: np.ndarray) -> None:
    """img: (H, W), (H, W, 3) or (H, W, 4) uint8."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo each row's filter (PNG spec 9.2); sums wrap at 256.  Sub is a
    running sum along the row; Average and Paeth go pixel by pixel, all
    channels at once."""
    stride = w * c
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, dtype=np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, w, c), dtype=np.uint8)
    prev = np.zeros((w, c), dtype=np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].reshape(w, c).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub
            cur = np.cumsum(line, axis=0) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth
            cur = line.copy()
            left = upleft = np.zeros(c, dtype=np.int32)
            for x in range(w):
                if ftype == 3:
                    pred = (left + prev[x]) >> 1
                else:
                    pred = _paeth(left, prev[x], upleft)
                cur[x] = (cur[x] + pred) & 0xFF
                left, upleft = cur[x], prev[x]
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """(H, W) for gray, else (H, W, 3) or (H, W, 4) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", payload)
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNG supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    c = _CHANNELS.get(color_type)
    if c is None:
        raise ValueError(f"unsupported color type {color_type}")
    img = _unfilter(zlib.decompress(idat), h, w, c)
    return img[:, :, 0] if c == 1 else img
