"""Fixed-accuracy snapshot compression (the reference's zfp role).

Counterpart of ``demiurge_tpu/native/snapc.py``, with the same header and
codec ids, so a blob from either package decodes in the other:

  compress(arr, accuracy)   -> bytes   (quantize + delta + varint in C++,
                                        ``snap_codec.cpp``, then zlib)
  decompress(blob, shape)   -> float32 ndarray

The round-trip error is at most accuracy/2 an element (lossy, like zfp's
fixed-accuracy mode); ``accuracy=0`` selects a lossless raw-float path.
The reference falls back silently to raw int64 deltas (codec 2) when its
native library is missing; here a failed build raises.  Codec-2 blobs
(written by the reference's fallback) still decode.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CODEC_VARINT = 1   # C++ delta+zigzag+LEB128
_CODEC_RAW64 = 2    # the reference's numpy fallback: int64 deltas
_CODEC_FLOAT = 3    # lossless raw float32 (accuracy == 0)

_HEADER = struct.Struct("<Bf")  # codec id, accuracy


def _lib():
    from .build import SNAP_SOURCE, library

    return library(SNAP_SOURCE)


def compress(arr, accuracy: float = 1e-6, level: int = 3) -> bytes:
    """Compress a float array to bytes (header + zlib payload)."""
    a = np.ascontiguousarray(arr, np.float32).ravel()
    if accuracy <= 0:
        return _HEADER.pack(_CODEC_FLOAT, 0.0) + zlib.compress(
            a.tobytes(), level)
    lib = _lib()
    cap = int(lib.dmg_snap_bound(a.size))
    out = np.empty(cap, np.uint8)
    n = int(lib.dmg_snap_encode(a.ctypes.data, a.size, accuracy,
                                out.ctypes.data, cap))
    if n < 0:
        raise RuntimeError("dmg_snap_encode overflowed its bound")
    return _HEADER.pack(_CODEC_VARINT, accuracy) + zlib.compress(
        out[:n].tobytes(), level)


def decompress(blob: bytes, shape) -> np.ndarray:
    """Inverse of compress; returns float32 of the given shape."""
    codec, accuracy = _HEADER.unpack_from(blob)
    payload = zlib.decompress(blob[_HEADER.size:])
    n = int(np.prod(shape)) if shape else 1
    if codec == _CODEC_FLOAT:
        a = np.frombuffer(payload, np.float32, n).copy()
    elif codec == _CODEC_RAW64:
        d = np.frombuffer(payload, "<i8", n)
        a = (np.cumsum(d) * np.float64(accuracy)).astype(np.float32)
    elif codec == _CODEC_VARINT:
        buf = np.frombuffer(payload, np.uint8)
        a = np.empty(n, np.float32)
        got = int(_lib().dmg_snap_decode(buf.ctypes.data, buf.size,
                                         accuracy, a.ctypes.data, n))
        if got != n:
            raise ValueError("corrupt snapshot payload")
    else:
        raise ValueError(f"unknown snapshot codec {codec}")
    return a.reshape(shape)
