"""A minimal PNG reader and writer on the standard library (`zlib`,
`struct`) and numpy, so the port reads its depth and colour frames and
writes its evaluation images without an imaging package."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel of each colour type holds: grey, RGB, grey-alpha, RGBA
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W) grey or (H, W, 3) RGB uint8 image as the bytes of an 8-bit
    PNG, or an (H, W) uint16 grey image (a depth frame) as a 16-bit one,
    every row with filter 0."""
    img = np.ascontiguousarray(img)
    grey16 = img.dtype == np.uint16 and img.ndim == 2
    if not grey16 and (img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3)):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8 or (H, W) "
                         f"uint16, got {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    colour_type = 2 if img.ndim == 3 else 0
    rows = (img.astype(">u2") if grey16 else img).reshape(H, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H,
                                          16 if grey16 else 8, colour_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    """Write `encode_png(img)` to `path`, making its directory."""
    data = encode_png(img)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(data: bytes, H: int, W: int, bpp: int) -> np.ndarray:
    """The (H, W * bpp) bytes of the image from its filtered scanlines.
    Each row's first byte names its filter (0 none, 1 sub, 2 up, 3
    average, 4 Paeth), which predicts a byte from the same byte of the
    pixel to its left (a), above (b) and above-left (c), all decoded
    already. Pixel (y, x) needs only pixels of smaller y + x, so the
    pixels are decoded one anti-diagonal at a time, each diagonal in one
    vector step whatever its rows' filters."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size != H * (W * bpp + 1):
        raise ValueError(f"PNG data holds {buf.size} bytes, wanted "
                         f"{H * (W * bpp + 1)}")
    buf = buf.reshape(H, W * bpp + 1)
    kinds = buf[:, 0].astype(np.int64)
    if int(kinds.max(initial=0)) > 4:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    raw = buf[:, 1:].reshape(H, W, bpp).astype(np.int16)
    # decoded bytes, with a zero row above and a zero column to the left
    out = np.zeros((H + 1, W + 1, bpp), np.int16)
    for d in range(H + W - 1):
        ys = np.arange(max(0, d - W + 1), min(H, d + 1))
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kinds[ys][:, None], [np.zeros_like(a), a, b,
                                              (a + b) >> 1, paeth])
        out[ys + 1, xs + 1] = (raw[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(H, W * bpp)


def read_png(path: str) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit grey, grey-alpha, RGB or RGBA
    PNG into the array that PIL's `np.asarray(Image.open(path))` gives:
    (H, W) for grey (uint8, or uint16 at 16 bits), (H, W, C) uint8
    otherwise. As in PIL, a 16-bit colour image keeps each sample's high
    byte, and 16-bit grey-alpha becomes RGBA (the grey in R, G and B).
    Raises `ValueError` on any other PNG (palette, other bit depths,
    interlacing) and on a malformed file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    W, H, bits, colour_type, _, _, interlace = header
    if colour_type not in CHANNELS or bits not in (8, 16) or interlace:
        raise ValueError(f"{path}: colour type {colour_type}, {bits} bits, "
                         f"interlace {interlace}: only non-interlaced 8- and "
                         "16-bit grey, grey-alpha, RGB and RGBA are read")
    ch = CHANNELS[colour_type]
    bpp = ch * bits // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), H, W, bpp)
    if bits == 8:
        img = rows.reshape(H, W, ch)
    else:
        img = rows.view(">u2").reshape(H, W, ch)
        if colour_type == 0:
            return img[..., 0].astype(np.uint16)
        img = (img >> 8).astype(np.uint8)
        if colour_type == 4:
            img = img[..., [0, 0, 0, 1]]
    return img[..., 0] if ch == 1 else img
