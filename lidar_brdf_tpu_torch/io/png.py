"""Minimal PNG decode/encode + GL-style texture sampling (stdlib only).

The reference loads texture images with lodepng, flips them vertically
(`Image.cpp:11-20` — so t=0 samples the image bottom, the OBJ vt
convention) and samples them with default GL_REPEAT bilinear filtering
inside `retrieveColors-comp.glsl`.  This module provides the same three
pieces with zero new dependencies: a decoder for 8-bit
gray/RGB/RGBA/palette PNGs (all five scanline filters, no interlace), a
filter-0 encoder for tests/tools, and `sample_bilinear` with REPEAT wrap.

Host numpy, copied from `lidar_brdf_tpu/io/png.py` so that the PyTorch
port does not import the JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit PNG into float32 (H, W, C) in [0, 1]."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    palette = None
    width = height = None
    colortype = bitdepth = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", chunk)
            if bitdepth != 8:
                raise ValueError(f"{path}: only 8-bit PNGs supported "
                                 f"(got {bitdepth})")
            if interlace:
                raise ValueError(f"{path}: interlaced PNGs not supported")
            if colortype not in _CHANNELS:
                raise ValueError(f"{path}: unsupported color type {colortype}")
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))
    ch = _CHANNELS[colortype]
    stride = width * ch
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride],
                             np.uint8).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:                                   # None
            cur = line
        elif ftype == 2:                                 # Up
            cur = (line + prev) & 0xFF
        else:  # Sub (1), Average (3), Paeth (4): sequential in x
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - ch] if x >= ch else 0
                b = prev[x]
                if ftype == 1:
                    cur[x] = (line[x] + a) & 0xFF
                elif ftype == 3:
                    cur[x] = (line[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = prev[x - ch] if x >= ch else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                    cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(height, width, ch)
    if colortype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        img = palette[img[:, :, 0]]
    elif colortype == 4:                                 # gray+alpha -> gray
        img = img[:, :, :1]
    return img.astype(np.float32) / 255.0


def write_png(path: str, img: np.ndarray) -> None:
    """Encode float32/uint8 (H, W[, C]) as an 8-bit PNG (filter 0)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, ch = a.shape
    colortype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + ctype + payload \
            + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colortype, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(raw))
                 + chunk(b"IEND", b""))


def sample_bilinear(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """GL `texture()` semantics: REPEAT wrap, bilinear, texel centers at
    (i + 0.5) / size, v=0 at the image BOTTOM (reference's vertical flip,
    `Image.cpp:20`).  ``uv``: (..., 2) -> (..., C)."""
    h, w = img.shape[:2]
    flipped = img[::-1]                       # row 0 becomes the bottom
    uv = np.asarray(uv, np.float64)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0, xi1 = x0 % w, (x0 + 1) % w
    yi0, yi1 = y0 % h, (y0 + 1) % h
    v00 = flipped[yi0, xi0]
    v10 = flipped[yi0, xi1]
    v01 = flipped[yi1, xi0]
    v11 = flipped[yi1, xi1]
    return ((v00 * (1 - fx) + v10 * fx) * (1 - fy)
            + (v01 * (1 - fx) + v11 * fx) * fy).astype(np.float32)
