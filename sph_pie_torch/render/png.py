"""Minimal dependency-free PNG encoder (grayscale 8-bit).

The frame path (splat on the device -> small uint8 image -> client) needs
a wire format; stdlib zlib + struct make valid grayscale PNGs, so the port
has no imaging dependency. Byte for byte the reference's encoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_gray_png(img) -> bytes:
    """uint8 [H, W] (numpy array or CPU tensor) -> PNG bytes."""
    a = np.asarray(img, np.uint8)
    if a.ndim != 2:
        raise ValueError(f"expected [H, W] image, got shape {a.shape}")
    h, w = a.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # bit depth 8, gray
    raw = b"".join(b"\x00" + a[row].tobytes() for row in range(h))
    return (
        _SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
