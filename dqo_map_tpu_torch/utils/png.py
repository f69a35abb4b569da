"""A minimal PNG reader and writer on the standard library (`zlib`,
`struct`) and numpy, so the port reads its depth and colour frames and
writes its evaluation images without an imaging package."""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel of each colour type holds: grey, RGB, palette,
# grey-alpha, RGBA; and the bit depths the specification allows each
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
BIT_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
              4: (8, 16), 6: (8, 16)}
# twice Pillow's Image.MAX_IMAGE_PIXELS: a larger image raises
# DecompressionBombError in Image.open
MAX_PIXELS = 2 * 89478485
# a chunk type as PIL's PngStream accepts one
CHUNK_TYPE = re.compile(rb"\w\w\w\w")
# PIL's mode of each colour type at 8 bits
MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


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
    vector step whatever its rows' filters. Below 8 bits a pixel here is
    one byte, as the specification's filters count it."""
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


# Adam7: each pass's (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _samples(data: bytes, H: int, W: int, ch: int, bits: int):
    """The (H, W, ch) samples of one image's (or one Adam7 pass's) filtered
    scanlines: uint8 below and at 8 bits, uint16 at 16. Returns them and
    the bytes the scanlines took."""
    if H == 0 or W == 0:                  # an empty pass has no scanlines
        return np.zeros((H, W, ch), np.uint16 if bits == 16 else np.uint8), 0
    bpp = max(1, ch * bits // 8)
    row_bytes = -(-W * ch * bits // 8)
    used = H * (row_bytes + 1)
    rows = _unfilter(data[:used], H, row_bytes // bpp, bpp)
    if bits == 16:
        return rows.view(">u2").reshape(H, W, ch).astype(np.uint16), used
    if bits == 8:
        return rows.reshape(H, W, ch), used
    per = 8 // bits
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(H, row_bytes * per)[:, :W, None], used


def read_png(path: str):
    """Decode a PNG into the array that PIL's `np.asarray(Image.open(path))`
    gives and PIL's mode (`1`, `L`, `I;16`, `P`, `LA`, `RGB` or `RGBA`),
    for every colour type and bit depth the specification allows,
    interlaced (Adam7) or not:
    - grey: (H, W) uint8 at 8 bits, uint16 at 16, bool at 1 bit (PIL's
      mode `1`), and at 2 and 4 bits uint8 scaled to 0-255 (x 85, x 17);
    - palette: the (H, W) uint8 indices (PIL's mode `P`), with or without
      a `tRNS` chunk;
    - grey-alpha, RGB and RGBA: (H, W, C) uint8. As in PIL, a 16-bit
      colour image keeps each sample's high byte, and 16-bit grey-alpha
      becomes RGBA (the grey in R, G and B).
    The chunks are read as PIL reads them: those before the image data
    whole and of a good CRC, the IDAT chunks' CRCs unread, nothing after
    them; any interlace method but 0 is Adam7, and data past the image's
    rows are not read. Raises `ValueError` where PIL raises: on an unknown
    colour type or filter method, a bit depth its type does not allow, a
    bad CRC, too little image data and a malformed file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    # the chunks before the image data, as PIL's PngStream reads them:
    # each of a 4-letter type, whole, its CRC checked
    pos, kind, length = 8, None, 0
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no image data)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if not CHUNK_TYPE.fullmatch(kind):
            raise ValueError(f"{path}: broken PNG chunk type {kind!r}")
        if kind in (b"IDAT", b"IEND"):
            break
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC of the {kind!r} chunk")
        if kind == b"IHDR":
            if length < 13:
                raise ValueError(f"{path}: truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        pos += 12 + length
    # the image data: the IDAT chunks in a row, their CRCs not read (as
    # PIL reads them); nothing after them is read
    while kind == b"IDAT":
        idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
        if pos + 8 > len(data):
            break
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    W, H, bits, colour_type, _, filter_method, interlace = header
    if W * H > MAX_PIXELS:
        raise ValueError(f"{path}: {W}x{H} pixels, past PIL's "
                         f"decompression-bomb limit of {MAX_PIXELS}")
    if colour_type not in BIT_DEPTHS:
        raise ValueError(f"{path}: unknown colour type {colour_type}")
    if bits not in BIT_DEPTHS[colour_type]:
        raise ValueError(f"{path}: {bits} bits for colour type "
                         f"{colour_type}, which allows "
                         f"{BIT_DEPTHS[colour_type]}")
    if filter_method:
        raise ValueError(f"{path}: unknown filter method {filter_method}")
    ch = CHANNELS[colour_type]
    # PIL takes any interlace method but 0 as Adam7, and inflates no more
    # than the image's rows need
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    need = 0
    for y0, x0, dy, dx in passes:
        ph, pw = -(-max(H - y0, 0) // dy), -(-max(W - x0, 0) // dx)
        if ph and pw:
            need += ph * (-(-pw * ch * bits // 8) + 1)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"{path}: broken PNG data ({e})") from None
    if len(raw) < need:
        raise ValueError(f"{path}: truncated PNG data ({len(raw)} of "
                         f"{need} bytes)")
    if interlace:
        img = np.zeros((H, W, ch), np.uint16 if bits == 16 else np.uint8)
        pos = 0
        for y0, x0, dy, dx in ADAM7:
            ph, pw = -(-max(H - y0, 0) // dy), -(-max(W - x0, 0) // dx)
            part, used = _samples(raw[pos:], ph, pw, ch, bits)
            img[y0::dy, x0::dx] = part
            pos += used
    else:
        img, _ = _samples(raw, H, W, ch, bits)
    mode = MODES[colour_type]
    if bits < 8 and colour_type == 0:
        img = img[..., 0]
        if bits == 1:
            img, mode = img.astype(bool), "1"
        else:
            img = img * (255 // ((1 << bits) - 1))
    elif bits == 16:
        if colour_type == 0:
            img, mode = img[..., 0], "I;16"
        else:
            img = (img >> 8).astype(np.uint8)
            if colour_type == 4:
                img, mode = img[..., [0, 0, 0, 1]], "RGBA"
    elif ch == 1:
        img = img[..., 0]
    return img, mode
