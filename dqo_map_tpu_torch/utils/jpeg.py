"""JPEG without an imaging package: `read_jpeg`, the ctypes binding of the
port's own decoder (`csrc/jpeg_decode.cc`), which gives the arrays that
PIL's `np.asarray(Image.open(path))` gives, bit for bit; and
`encode_jpeg` / `write_jpeg`, a numpy encoder that writes the file PIL's
`Image.save(f, "JPEG", quality=q)` writes, byte for byte (the evaluation
images at quality 75, the viewer's frames at 85, smoke data).

The decoder is built from `csrc/jpeg_decode.cc` at first use with `g++
-O3 -fPIC -std=c++17 -shared` into `dqo_map_tpu_torch/_build/`, under a
name keyed by the source's and the flags' hash; a failed build raises.
It reads every 8-bit JPEG that PIL reads: grey, YCbCr, RGB, CMYK or
YCCK (the 4 bands inverted, as PIL's `CMYK` holds them); Huffman- or
arithmetic-coded; sequential, progressive (smoothed where its scans leave
bits unsent, as libjpeg smooths it) or lossless; any integral sampling
factors, restart intervals, corrupt data as libjpeg reads them. A file
PIL refuses (12-bit, hierarchical, lossless arithmetic, arithmetic data
past the file's first 64 KiB, truncated, ...) raises `ValueError` naming
the file and the cause.
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
# PIL's mode of a decoded file of 1, 3 or 4 components
JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}


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


def read_jpeg(path):
    """Decode the JPEG file at `path` into the array PIL gives for it and
    PIL's mode: (H, W) uint8 (grey, `L`), (H, W, 3) uint8 (`RGB`) or
    (H, W, 4) uint8 (`CMYK`, Adobe-inverted as PIL stores it).
    `ValueError` naming the file where it is not read, as PIL raises on
    it."""
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
    img = img.reshape(H, W) if C == 1 else img.reshape(H, W, C)
    return img, JPEG_MODES[C]


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


def _fdct_islow(x: np.ndarray) -> np.ndarray:
    """jfdctint.c's `jpeg_fdct_islow` on blocks (..., 8, 8) of centred
    samples: the rows, then the columns, CONST_BITS 13 and PASS1_BITS 2;
    the output is scaled up by 8, as libjpeg's quantiser expects."""
    CB, P1 = 13, 2

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    def one_pass(d, even_shift, odd_n):
        d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
        tmp0, tmp7 = d0 + d7, d0 - d7
        tmp1, tmp6 = d1 + d6, d1 - d6
        tmp2, tmp5 = d2 + d5, d2 - d5
        tmp3, tmp4 = d3 + d4, d3 - d4
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        out = [None] * 8
        out[0], out[4] = even_shift(tmp10 + tmp11), even_shift(tmp10 - tmp11)
        z1 = (tmp12 + tmp13) * 4433
        out[2] = descale(z1 + tmp13 * 6270, odd_n)
        out[6] = descale(z1 + tmp12 * -15137, odd_n)
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * 9633
        tmp4, tmp5 = tmp4 * 2446, tmp5 * 16819
        tmp6, tmp7 = tmp6 * 25172, tmp7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = descale(tmp4 + z1 + z3, odd_n)
        out[5] = descale(tmp5 + z2 + z4, odd_n)
        out[3] = descale(tmp6 + z2 + z3, odd_n)
        out[1] = descale(tmp7 + z1 + z4, odd_n)
        return np.stack(out, -1)

    rows = one_pass(x.astype(np.int64), lambda v: v << P1, CB - P1)
    cols = one_pass(np.swapaxes(rows, -1, -2),
                    lambda v: descale(v, P1), CB + P1)
    return np.swapaxes(cols, -1, -2)


def _quantise(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantiser with 16-bit DCT elements, as libjpeg-turbo
    builds it with its SIMD code: each divisor (8 x the table entry) by
    `compute_reciprocal`'s reciprocal, rounding correction and shift;
    the magnitude is quantised and the sign put back."""
    div = qt.astype(np.int64) * 8
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // div, (1 << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > div // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    mag = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -mag, mag)


def _rgb_to_ycc(img: np.ndarray) -> list:
    """jccolor.c's `rgb_ycc_convert`: the fixed-point tables of
    SCALEBITS 16, each output rounded as libjpeg rounds it."""
    def fix(x):
        return int(x * 65536 + 0.5)
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half
          - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half
          - 1) >> 16
    return [y, cb, cr]


def _downsample(plane: np.ndarray, eh: int, ev: int,
                cols: int) -> np.ndarray:
    """jcsample.c's downsampling of a full-size plane whose rows are a
    multiple of `ev`, by `eh` x `ev` into `cols` columns: the plane's right
    edge repeated out to `cols * eh`, then h2v1 (bias 0, 1, 0, ...), h2v2
    (bias 1, 2, 1, ...), or `int_downsample` (the rounded mean)."""
    H, W = plane.shape
    x = np.pad(plane, ((0, 0), (0, cols * eh - W)), mode="edge")
    if eh == ev == 1:
        return x
    cells = x.reshape(H // ev, ev, cols, eh).sum(axis=(1, 3))
    if (eh, ev) == (2, 1):
        return (cells + (np.arange(cols) & 1)) >> 1
    if (eh, ev) == (2, 2):
        return (cells + 1 + (np.arange(cols) & 1)) >> 2
    n = eh * ev
    return (cells + n // 2) // n


def _component_blocks(plane: np.ndarray, v: int, bw: int, bh: int,
                      mcu_rows: int, qt: np.ndarray) -> np.ndarray:
    """A downsampled component plane (rows, bw * 8) to its quantised blocks
    (bh, bw, 64), zig-zag order: the plane's bottom edge repeated to whole
    iMCU rows (jcprepare.c), each block through the islow FDCT and the
    quantiser."""
    rows = mcu_rows * v * 8
    x = np.pad(plane, ((0, rows - plane.shape[0]), (0, 0)), mode="edge")
    blocks = _blocks(x[:bh * 8] - 128)
    q = _quantise(_fdct_islow(blocks).reshape(bh, bw, 64),
                  qt.reshape(64))
    return q[..., ZIGZAG]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    H, W = plane.shape
    return plane.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)


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


def _coded_blocks(planes: list, factors: list, W: int, H: int, qts: list):
    """The quantised blocks of the components in coded order, (N, 64), and
    each block's component, as jccoefct.c's `compress_data` emits them.
    One component is coded alone, block by block. Several are
    interleaved, MCU by MCU; a block of an MCU past the component's edge
    is a dummy block, all AC zero and the DC of the block before it: the
    one to its left, or below the edge, the last block of the MCU's row
    above."""
    hm = max(h for h, _ in factors)
    vm = max(v for _, v in factors)
    mx, my = -(-W // (8 * hm)), -(-H // (8 * vm))
    rows = -(-H // vm) * vm
    grids = []
    for plane, (h, v), qt in zip(planes, factors, qts):
        bw = -(-W * h // (8 * hm))
        bh = -(-H * v // (8 * vm))
        full = np.pad(plane, ((0, rows - H), (0, 0)), mode="edge")
        down = _downsample(full, hm // h, vm // v, bw * 8)
        real = _component_blocks(down, v, bw, bh, my, qt)
        if len(planes) == 1:
            return real.reshape(-1, 64), np.zeros(bw * bh, np.int64)
        grid = np.zeros((my * v, mx * h, 64), np.int64)
        grid[:bh, :bw] = real
        grid[:bh, bw:, 0] = grid[:bh, bw - 1:bw, 0]
        for r in range(bh, my * v):
            last = grid[r - 1, h - 1::h, 0]
            grid[r, :, 0] = np.repeat(last, h)
        # (my, mx, v * h, 64): each MCU's blocks row by row
        grids.append(grid.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
                     .reshape(my, mx, v * h, 64))
    blocks = np.concatenate(grids, axis=2).reshape(-1, 64)
    per_mcu = np.repeat(np.arange(len(planes)), [h * v for h, v in factors])
    return blocks, np.tile(per_mcu, mx * my)


def encode_jpeg(img: np.ndarray, quality: int = 75,
                subsampling: str = "4:2:0", factors=None) -> bytes:
    """A baseline JFIF JPEG of an (H, W) grey or (H, W, 3) RGB uint8 image,
    as PIL's `Image.fromarray(img).save(f, "JPEG", quality=quality)`
    writes it through libjpeg-turbo (whose defaults PIL keeps): Annex K's
    quantisation tables scaled by `quality` (`jpeg_quality_scaling`,
    clamped to 255) and its Huffman tables; the fixed-point RGB-to-YCbCr
    conversion, chroma downsampling with libjpeg's biases, the islow
    integer FDCT, the reciprocal quantiser and the dummy blocks of the
    MCUs past the image's edge. Luma is sampled at `factors` (h, v) over
    chroma, by default `subsampling`'s: 4:4:4 (1, 1) or 4:2:0 (2, 2, PIL's
    default). The file decodes to PIL's pixels at every quality and size,
    and its entropy-coded data is libjpeg-turbo's, byte for byte."""
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
    qy, qc = quant_table(Q_LUMA, quality), quant_table(Q_CHROMA, quality)
    if grey:
        planes, comp_factors, qts = [img.astype(np.int64)], [(1, 1)], [qy]
    else:
        planes = _rgb_to_ycc(img)
        comp_factors, qts = [(h, v), (1, 1), (1, 1)], [qy, qc, qc]
    blocks, comp = _coded_blocks(planes, comp_factors, W, H, qts)
    luma_t = (_codes(DC_LUMA), _codes(AC_LUMA))
    chroma_t = (_codes(DC_CHROMA), _codes(AC_CHROMA))
    tables = [luma_t] if grey else [luma_t, chroma_t, chroma_t]
    data = _entropy_code(blocks, comp, tables)

    # the markers in libjpeg's order: each table in a segment of its own
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for k, qt in enumerate([qy] if grey else [qy, qc]):
        out.append(_segment(0xDB, bytes([k]) + bytes(
            qt[ZIGZAG].astype(np.uint8))))
    ncomp = 1 if grey else 3
    sof = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") \
        + bytes([ncomp, 1, (h << 4) | v, 0])
    if not grey:
        sof += bytes([2, 0x11, 1, 3, 0x11, 1])
    out.append(_segment(0xC0, sof))
    out += [_segment(0xC4, _dht(0, 0, DC_LUMA)),
            _segment(0xC4, _dht(1, 0, AC_LUMA))]
    if not grey:
        out += [_segment(0xC4, _dht(0, 1, DC_CHROMA)),
                _segment(0xC4, _dht(1, 1, AC_CHROMA))]
    sos = bytes([ncomp, 1, 0x00]) + (b"" if grey else bytes([2, 0x11, 3,
                                                            0x11]))
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path, img: np.ndarray, quality: int = 75,
               subsampling: str = "4:2:0"):
    """Write `encode_jpeg(img, quality, subsampling)` to `path`, making its
    directory."""
    data = encode_jpeg(img, quality, subsampling)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
