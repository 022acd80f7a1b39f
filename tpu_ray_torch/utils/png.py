"""Minimal dependency-free PNG writer.

Replaces the reference's display path (WebGL texture blit,
wasm/wasm.cpp:213-218; OpenGL quad, win32/win32.cpp:540-574): frames become
files. Pure stdlib (zlib/struct): no imaging dependency.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image) -> None:
    """Write an [H,W,3] or [H,W,4] u8 array (or [H,W] grayscale) as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]

    raw = bytearray()
    for row in img:
        raw.append(0)  # filter type 0 (None)
        raw.extend(row.tobytes())

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(bytes(raw), 6)))
        f.write(_chunk(b"IEND", b""))
