"""Minimal PNG codec (encode + decode) — no external imaging deps.

Counterpart of ``demiurge_tpu/utils/png.py`` (the port's own copy; numpy
and zlib only, the same bytes).  Supports non-interlaced 8/16-bit grayscale, RGB, RGBA (the formats the
reference reads via stb_image and writes via stb_image_write,
Project.cpp:45-67).  Decode returns float32 arrays in [0,1].
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray, bitdepth: int = 8):
    """arr: (H, W) grayscale or (H, W, 3|4) color, float in [0,1] or uint8.
    Row 0 is written as the TOP image row (callers flip as needed)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 and bitdepth == 8:
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    elif bitdepth == 16:
        arr = (np.clip(arr, 0, 1) * 65535).round().astype(">u2")
    if arr.ndim == 2:
        color = 0
    elif arr.shape[2] == 3:
        color = 2
    elif arr.shape[2] == 4:
        color = 6
    else:
        raise ValueError(f"unsupported shape {arr.shape}")
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    png = (_MAGIC
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bitdepth, color,
                                         0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _unfilter(raw: bytes, h: int, w: int, bpp: int, rowbytes: int) -> bytearray:
    out = bytearray(h * rowbytes)
    pos = 0
    prev_row = bytearray(rowbytes)
    for r in range(h):
        ftype = raw[pos]
        pos += 1
        row = bytearray(raw[pos:pos + rowbytes])
        pos += rowbytes
        if ftype == 1:  # Sub
            for i in range(bpp, rowbytes):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for i in range(rowbytes):
                row[i] = (row[i] + prev_row[i]) & 0xFF
        elif ftype == 3:  # Average
            for i in range(rowbytes):
                a = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((a + prev_row[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(rowbytes):
                a = row[i - bpp] if i >= bpp else 0
                b = prev_row[i]
                c = prev_row[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pr) & 0xFF
        out[r * rowbytes:(r + 1) * rowbytes] = row
        prev_row = row
    return out


def read_png(path: str) -> np.ndarray:
    """Decode to float32 in [0,1]; (H, W) for grayscale, (H, W, C) else.
    Row 0 = top image row."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _MAGIC, "not a PNG"
    pos = 8
    idat = b""
    w = h = bitdepth = color = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", payload)
            assert interlace == 0, "interlaced PNG unsupported"
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    assert bitdepth in (8, 16), f"bitdepth {bitdepth} unsupported"
    bytes_per_sample = bitdepth // 8
    bpp = channels * bytes_per_sample
    rowbytes = w * bpp
    out = _unfilter(raw, h, w, bpp, rowbytes)
    if bitdepth == 8:
        arr = np.frombuffer(bytes(out), np.uint8).reshape(h, w, channels)
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = np.frombuffer(bytes(out), ">u2").reshape(h, w, channels)
        arr = arr.astype(np.float32) / 65535.0
    if color == 3:  # palette
        idx = (arr[..., 0] * 255).astype(np.int32)
        arr = palette[idx].astype(np.float32) / 255.0
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr
