"""JPEG without an imaging package: `read_jpeg`, the ctypes binding of the
port's own decoder (`csrc/jpeg_decode.cc`), which gives the arrays that
PIL's `np.asarray(Image.open(path))` gives, bit for bit; and
`write_jpeg`, a small baseline encoder in numpy that makes test and smoke
data where PIL is absent (nothing on the main path calls it).

The decoder is built from `csrc/jpeg_decode.cc` at first use with `g++
-O3 -fPIC -std=c++17 -shared` into `dqo_map_tpu_torch/_build/`, under a
name keyed by the source's and the flags' hash; a failed build raises.
It reads 8-bit sequential Huffman JPEG (SOF0, SOF1), grey or YCbCr, any
integral sampling factors, restart intervals; any other file raises
`ValueError` naming the file and the cause.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from .native import build_shared

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "csrc" / "jpeg_decode.cc"
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LIB = None


def build_library() -> Path:
    """Compile `csrc/jpeg_decode.cc` into `_build/` unless a library of the
    same source and flags is already there; returns its path."""
    return build_shared(SOURCE, BUILD_DIR, "libjpeg_decode", CXX_FLAGS, [],
                        "the JPEG decoder")


def _load_lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.jd_decode.restype = ctypes.c_int
        lib.jd_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(u8p)]
        lib.jd_free.restype = None
        lib.jd_free.argtypes = [u8p]
        lib.jd_error.restype = ctypes.c_char_p
        lib.jd_error.argtypes = []
        _LIB = lib
    return _LIB


def read_jpeg(path) -> np.ndarray:
    """Decode the JPEG file at `path` into the array PIL gives for it:
    (H, W) uint8 (grey) or (H, W, 3) uint8 (RGB); `ValueError` naming the
    file where it is not read."""
    with open(path, "rb") as f:
        data = f.read()
    lib = _load_lib()
    dims = (ctypes.c_int * 3)()
    out = ctypes.POINTER(ctypes.c_uint8)()
    if lib.jd_decode(data, len(data), dims, ctypes.byref(out)) != 0:
        raise ValueError(f"{path}: {lib.jd_error().decode()}")
    try:
        H, W, C = dims
        img = np.ctypeslib.as_array(out, (H * W * C,)).copy()
    finally:
        lib.jd_free(out)
    return img.reshape(H, W) if C == 1 else img.reshape(H, W, C)


# ---------------------------------------------------------------------------
# the encoder: ITU T.81 Annex K's tables, IJG's quality scaling

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# K.1 and K.2, natural order
Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
# K.3: (code counts by length 1-16, symbols) of the four standard tables
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:0": (2, 2)}


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG's `jpeg_quality_scaling` of a base table, clamped to 1-255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _codes(spec):
    """symbol -> (code, length) of a table given as (counts, symbols)."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II: `C @ x` transforms the columns."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)


def _quantised(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """The blocks' DCT coefficients over `qt`, rounded: (by, bx, 64) in
    zig-zag order."""
    c = _dct_matrix()
    coef = c @ (_blocks(plane) - 128.0) @ c.T
    q = np.rint(coef.reshape(coef.shape[:2] + (64,)) / qt)
    q[..., 1:] = np.clip(q[..., 1:], -1023, 1023)
    return q[..., ZIGZAG].astype(np.int64)


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (0 for 0), the JPEG magnitude category."""
    a = np.abs(v)
    out = np.zeros(v.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _entropy_code(blocks: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Huffman-code the zig-zag blocks (N, 64), in coded order, each of
    component `comp[i]` whose (DC, AC) code tables are `tables[comp[i]]`;
    returns the byte-stuffed entropy-coded segment."""
    n = len(blocks)
    dc = blocks[:, 0].copy()
    diff = np.empty_like(dc)
    for k in np.unique(comp):       # DC predicted from the component's last
        sel = np.nonzero(comp == k)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    dc_codes = np.stack([tables[k][0][0] for k in range(len(tables))])
    dc_lens = np.stack([tables[k][0][1] for k in range(len(tables))])
    ac_codes = np.stack([tables[k][1][0] for k in range(len(tables))])
    ac_lens = np.stack([tables[k][1][1] for k in range(len(tables))])

    keys, vals, lens = [], [], []

    def emit(key, comp_idx, sym, codes, lengths, extra, extra_len):
        c = codes[comp_idx, sym]
        ln = lengths[comp_idx, sym]
        keys.append(key)
        vals.append((c << extra_len) | extra)
        lens.append(ln + extra_len)

    def extra_bits(v, s):
        return np.where(v >= 0, v, v + (1 << s) - 1) & ((1 << s) - 1)

    s = _size(diff)
    emit(np.arange(n) * 256, comp, s, dc_codes, dc_lens, extra_bits(diff, s),
         s)
    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    v = blocks[b, k]
    prev = np.zeros_like(k)          # the block's previous nonzero, or 0
    same = np.nonzero(b[1:] == b[:-1])[0] + 1
    prev[same] = k[same - 1]
    run = k - prev - 1
    s = _size(v)
    emit(b * 256 + 2 * k, comp[b], (run % 16) * 16 + s, ac_codes, ac_lens,
         extra_bits(v, s), s)
    nzrl = run // 16                 # a ZRL (0xF0) for each 16 zeros
    zb = np.repeat(b, nzrl)
    zk = np.repeat(k, nzrl)
    zero = np.zeros(len(zb), np.int64)
    emit(zb * 256 + 2 * zk - 1, comp[zb], np.full(len(zb), 0xF0), ac_codes,
         ac_lens, zero, zero)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    zero = np.zeros(len(eob), np.int64)
    emit(eob * 256 + 255, comp[eob], np.zeros(len(eob), np.int64), ac_codes,
         ac_lens, zero, zero)

    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    total = int(ln.sum())
    start = np.cumsum(ln) - ln
    item = np.repeat(np.arange(len(ln)), ln)
    off = np.arange(total) - start[item]
    bits = ((val[item] >> (ln[item] - 1 - off)) & 1).astype(np.uint8)
    pad = (-total) % 8                                   # pad with ones
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def _dht(tc: int, th: int, spec) -> bytes:
    counts, symbols = spec
    return bytes([(tc << 4) | th]) + bytes(counts) + bytes(symbols)


def encode_jpeg(img: np.ndarray, quality: int = 95,
                subsampling: str = "4:2:0", factors=None) -> bytes:
    """A baseline JFIF JPEG of an (H, W) grey or (H, W, 3) RGB uint8 image:
    Annex K's quantisation tables scaled by `quality` as IJG scales them,
    Annex K's Huffman tables, luma sampled at `factors` (h, v) over chroma
    (by default `subsampling`'s: 4:4:4 (1, 1) or 4:2:0 (2, 2)), chroma
    averaged over each h x v cell."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    if factors is None:
        if subsampling not in SUBSAMPLING:
            raise ValueError(f"subsampling {subsampling!r}; one of "
                             f"{sorted(SUBSAMPLING)}")
        factors = SUBSAMPLING[subsampling]
    H, W = img.shape[:2]
    grey = img.ndim == 2
    h, v = (1, 1) if grey else factors
    mw, mh = 8 * h, 8 * v
    Hp, Wp = -(-H // mh) * mh, -(-W // mw) * mw
    x = np.pad(img.astype(np.float64),
               ((0, Hp - H), (0, Wp - W)) + ((0, 0),) * (img.ndim - 2),
               mode="edge")
    qy, qc = quant_table(Q_LUMA, quality), quant_table(Q_CHROMA, quality)
    if grey:
        planes = [x]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128
        cells = [c.reshape(Hp // v, v, Wp // h, h).mean(axis=(1, 3))
                 for c in (cb, cr)]
        planes = [y] + cells
    quant = [_quantised(p, qy if i == 0 else qc)
             for i, p in enumerate(planes)]
    # coded order: each MCU's h x v luma blocks row by row, then Cb, Cr
    if grey:
        blocks = quant[0].reshape(-1, 64)
        comp = np.zeros(len(blocks), np.int64)
    else:
        my, mx = Hp // mh, Wp // mw
        luma = quant[0].reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
        parts = [luma.reshape(my, mx, h * v, 64)] + [
            q.reshape(my, mx, 1, 64) for q in quant[1:]]
        blocks = np.concatenate(parts, axis=2).reshape(-1, 64)
        comp = np.tile(np.repeat(np.arange(3), [h * v, 1, 1]), my * mx)
    luma_t = (_codes(DC_LUMA), _codes(AC_LUMA))
    chroma_t = (_codes(DC_CHROMA), _codes(AC_CHROMA))
    tables = [luma_t] if grey else [luma_t, chroma_t, chroma_t]
    data = _entropy_code(blocks, comp, tables)

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    dqt = bytes([0]) + bytes(qy[ZIGZAG].astype(np.uint8))
    if not grey:
        dqt += bytes([1]) + bytes(qc[ZIGZAG].astype(np.uint8))
    out.append(_segment(0xDB, dqt))
    ncomp = 1 if grey else 3
    sof = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") \
        + bytes([ncomp, 1, (h << 4) | v, 0])
    if not grey:
        sof += bytes([2, 0x11, 1, 3, 0x11, 1])
    out.append(_segment(0xC0, sof))
    dht = _dht(0, 0, DC_LUMA) + _dht(1, 0, AC_LUMA)
    if not grey:
        dht += _dht(0, 1, DC_CHROMA) + _dht(1, 1, AC_CHROMA)
    out.append(_segment(0xC4, dht))
    sos = bytes([ncomp, 1, 0x00]) + (b"" if grey else bytes([2, 0x11, 3,
                                                            0x11]))
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path, img: np.ndarray, quality: int = 95,
               subsampling: str = "4:2:0"):
    """Write `encode_jpeg(img, quality, subsampling)` to `path`, making its
    directory."""
    data = encode_jpeg(img, quality, subsampling)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
