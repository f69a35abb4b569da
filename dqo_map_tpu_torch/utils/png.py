"""A minimal PNG writer on the standard library (`zlib`, `struct`), so the
evaluation images need no imaging package."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write an (H, W) grey or (H, W, 3) RGB uint8 image as an 8-bit PNG,
    every row with filter 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    colour_type = 2 if img.ndim == 3 else 0
    rows = img.reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour_type,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
