"""A PNG writer for every colour type, bit depth, row filter and Adam7
interlacing, for the port's reader tests, and the PNG fixtures of
`tests/torch_fixtures/png/` that it writes with `hashes.json` beside them:
each file's decoded shape, dtype, PIL's mode and the SHA-256 of the array
PIL decodes it to (`digest`: a bool array hashed as its 0 / 1 bytes), and
for the palette and 1-bit files the same of the array `Image.resize`
gives at `resize_size` (NEAREST). They hold the port's reader to PIL on a machine without PIL
(`chip_smoke.py`); `tests/test_torch_native_loader.py` re-derives the
hashes with PIL.

    python tests/torch_fixtures/make_png_fixtures.py
"""

import hashlib
import json
import os
import struct
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "png")
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def _packed(samples: np.ndarray, bits: int) -> np.ndarray:
    """(H, W, ch) samples as the (H, row bytes) bytes of their scanlines."""
    H = samples.shape[0]
    flat = samples.reshape(H, -1).astype(np.int64)
    if bits == 16:
        return flat.astype(">u2").view(np.uint8).reshape(H, -1)
    if bits == 8:
        return flat.astype(np.uint8)
    per = 8 // bits
    n = flat.shape[1]
    pad = np.zeros((H, -n % per), np.int64)
    groups = np.concatenate([flat, pad], 1).reshape(H, -1, per)
    shifts = np.arange(8 - bits, -1, -bits)
    return (groups << shifts).sum(-1).astype(np.uint8)


def _filtered(rows: np.ndarray, kinds, bpp: int) -> np.ndarray:
    """The scanlines of (H, stride) bytes, row y filtered with
    kinds[y % len(kinds)] (PNG specification, section 9)."""
    H, S = rows.shape
    r = rows.astype(np.int16)
    out = np.zeros((H, S + 1), np.uint8)
    for y in range(H):
        k = kinds[y % len(kinds)]
        b = r[y - 1] if y else np.zeros(S, np.int16)
        a = np.concatenate([np.zeros(bpp, np.int16), r[y, :-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int16), b[:-bpp]])
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (np.zeros_like(a), a, b, (a + b) >> 1, paeth)[k]
        out[y, 0] = k
        out[y, 1:] = (r[y] - pred) & 0xFF
    return out


def png_bytes(samples: np.ndarray, bits: int, colour_type: int,
              interlace: bool = False, kinds=(0,), palette=None,
              trns: bytes = None) -> bytes:
    """A PNG of `samples` ((H, W) or (H, W, ch) integers, palette indices
    for colour type 3) at `bits`, its rows filtered with `kinds` in turn,
    Adam7-interlaced if asked, its data split over two IDAT chunks;
    `palette` (n, 3) and `trns` (the tRNS chunk's body) where given."""
    samples = np.asarray(samples)
    H, W = samples.shape[:2]
    s = samples.reshape(H, W, -1)
    bpp = max(1, CHANNELS[colour_type] * bits // 8)
    if interlace:
        parts = [s[y0::dy, x0::dx] for y0, x0, dy, dx in ADAM7]
    else:
        parts = [s]
    raw = b"".join(_filtered(_packed(p, bits), kinds, bpp).tobytes()
                   for p in parts if p.shape[0] and p.shape[1])
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, bits, colour_type,
                                       0, 0, int(interlace)))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    data = zlib.compress(raw)
    out += [_chunk(b"IDAT", data[:len(data) // 2]),
            _chunk(b"IDAT", data[len(data) // 2:]), _chunk(b"IEND", b"")]
    return b"".join(out)


# name: (height, width, bits, colour type, interlaced, palette size, tRNS)
FIXTURES = {
    "palette8_trns_13x9.png": (9, 13, 8, 3, False, 200, True),
    "palette4_21x11.png": (11, 21, 4, 3, False, 16, False),
    "palette1_adam7_17x10.png": (10, 17, 1, 3, True, 2, False),
    "grey1_19x7.png": (7, 19, 1, 0, False, 0, False),
    "grey2_adam7_11x13.png": (13, 11, 2, 0, True, 0, False),
    "grey4_23x6.png": (6, 23, 4, 0, False, 0, False),
    "grey16_adam7_9x12.png": (12, 9, 16, 0, True, 0, False),
    "rgb8_adam7_15x14.png": (14, 15, 8, 2, True, 0, False),
    "rgba8_adam7_5x3.png": (3, 5, 8, 6, True, 0, False),
    "greyalpha16_adam7_10x9.png": (9, 10, 16, 4, True, 0, False),
}


def digest(arr: np.ndarray) -> str:
    """The SHA-256 of an array's samples; a bool array's as 0 / 1 bytes,
    whatever bytes stand for True in its memory."""
    a = arr.astype(np.uint8) if arr.dtype == bool else arr
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def entry(im) -> dict:
    """A PIL image's array: its shape, dtype and `digest`."""
    arr = np.asarray(im)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": digest(arr)}


def resize_size(W: int, H: int) -> list:
    """The size a fixture is also resized to: wider, and lower."""
    return [2 * W + 3, H // 2 + 1]


def fixture_bytes(rng, H, W, bits, colour_type, interlace, n_palette, trns):
    ch = CHANNELS[colour_type]
    top = n_palette if colour_type == 3 else 2 ** bits
    img = rng.integers(0, top, (H, W, ch))
    palette = (rng.integers(0, 256, (n_palette, 3))
               if colour_type == 3 else None)
    t = bytes(rng.integers(0, 256, n_palette // 2).astype(np.uint8)) \
        if trns else None
    return png_bytes(img, bits, colour_type, interlace, (0, 1, 2, 3, 4),
                     palette, t)


def main():
    from PIL import Image
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(2026)
    hashes = {}
    for name, spec in FIXTURES.items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(fixture_bytes(rng, *spec))
        im = Image.open(path)
        hashes[name] = {**entry(im), "mode": im.mode}
        if im.mode in ("P", "1"):         # resized NEAREST by Pillow
            hashes[name]["resized"] = entry(im.resize(resize_size(*im.size)))
    with open(os.path.join(OUT, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
