"""Writers of the JPEG kinds PIL cannot write, for test and smoke data only:
arithmetic coding (T.81 Annex D and F.1.4, G.1.3, as libjpeg's jcarith.c
codes them), sequential or progressive; Huffman-coded progressive files of
a chosen scan script (jcphuff.c), which can leave low bits unsent; CMYK
and YCCK files; lossless files (predictors 1-7, point transform); 12-bit
and hierarchical ones. The blocks come from the port's encoder (its islow
FDCT and quantiser, `dqo_map_tpu_torch/utils/jpeg.py`). PIL decoding what
these write is the judge, so a fault here cannot hide a fault of the
decoder: `tests/test_torch_jpeg.py` holds the port's decoder to PIL on
them, and `make_jpeg_fixtures.py` writes the committed ones."""

from __future__ import annotations

import numpy as np

from dqo_map_tpu_torch.utils import jpeg as J

ZIGZAG = J.ZIGZAG
# ITU T.81 Table D.2 as jaricom.c packs it: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS); entry 113 is T.851's fixed probability 0.5
ARI = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]

# colour kinds: (components, APP segment) as libjpeg reads them back
ADOBE = {"RGB": 0, "CMYK": 0, "YCCK": 2}


# ---------------------------------------------------------------------------
# the frame: each component's quantised blocks on its MCU grid

class Frame:
    """An image's components as a JPEG encoder holds them: `grids[i]`
    (MCU rows * v, MCU columns * h, 64), zig-zag order, the blocks past
    the component's edge libjpeg's dummy blocks (all AC zero, the DC of
    the block to the left, or below the image of the last block of the
    row above); `real[i]` its (rows, columns) of blocks in the image."""

    def __init__(self, img, kind="YCbCr", quality=75, factors=None,
                 precision=8):
        img = np.asarray(img)
        H, W = img.shape[:2]
        self.H, self.W, self.kind, self.precision = H, W, kind, precision
        qy = J.quant_table(J.Q_LUMA, quality)
        qc = J.quant_table(J.Q_CHROMA, quality)
        x = img.astype(np.int64)
        if kind == "L":
            planes = [x]
        elif kind == "YCbCr":
            planes = J._rgb_to_ycc(img)
        elif kind == "RGB":
            planes = [x[..., k] for k in range(3)]
        elif kind == "CMYK":        # PIL's values, stored inverted
            planes = [255 - x[..., k] for k in range(4)]
        elif kind == "YCCK":        # jccolor.c's cmyk_ycck_convert
            planes = J._rgb_to_ycc(img[..., :3]) + [255 - x[..., 3]]
        else:
            raise ValueError(kind)
        if precision == 12:
            planes = [p * 16 + 8 for p in planes]
            qy, qc = qy * 4, qc * 4
        n = len(planes)
        if factors is None:
            factors = (2, 2) if kind in ("YCbCr", "YCCK") else (1, 1)
        self.factors = [tuple(factors)] + [(1, 1)] * (n - 1)
        self.tq = [0] + [1] * (n - 1) if kind in ("YCbCr", "YCCK") \
            else [0] * n
        self.qts = [qy, qc]
        self.ids = list(range(1, n + 1))
        hm = max(f[0] for f in self.factors)
        vm = max(f[1] for f in self.factors)
        self.hm, self.vm = hm, vm
        self.mx, self.my = -(-W // (8 * hm)), -(-H // (8 * vm))
        rows = -(-H // vm) * vm
        self.grids, self.real = [], []
        centre = 2048 if precision == 12 else 128
        for plane, (ch, cv), tq in zip(planes, self.factors, self.tq):
            bw = -(-W * ch // (8 * hm))
            bh = -(-H * cv // (8 * vm))
            full = np.pad(plane, ((0, rows - H), (0, 0)), mode="edge")
            down = J._downsample(full, hm // ch, vm // cv, bw * 8)
            prows = self.my * cv * 8
            down = np.pad(down, ((0, prows - down.shape[0]), (0, 0)),
                          mode="edge")
            blocks = J._blocks(down[:bh * 8] - centre)
            real = J._quantise(J._fdct_islow(blocks).reshape(bh, bw, 64),
                               self.qts[tq].reshape(64))[..., ZIGZAG]
            grid = np.zeros((self.my * cv, self.mx * ch, 64), np.int64)
            grid[:bh, :bw] = real
            grid[:bh, bw:, 0] = grid[:bh, bw - 1:bw, 0]
            for r in range(bh, self.my * cv):
                grid[r, :, 0] = np.repeat(grid[r - 1, ch - 1::ch, 0], ch)
            self.grids.append(grid)
            self.real.append((bh, bw))

    def scan_blocks(self, comps):
        """The blocks of a scan of components `comps` in coded order, each
        with its index in the scan: one component's real blocks row by
        row, or whole interleaved MCUs."""
        if len(comps) == 1:
            (c,) = comps
            bh, bw = self.real[c]
            return [[(0, self.grids[c][r, x])] for r in range(bh)
                    for x in range(bw)]
        mcus = []
        for my in range(self.my):
            for mx in range(self.mx):
                mcu = []
                for i, c in enumerate(comps):
                    h, v = self.factors[c]
                    for by in range(v):
                        for bx in range(h):
                            mcu.append((i, self.grids[c][my * v + by,
                                                         mx * h + bx]))
                mcus.append(mcu)
        return mcus

    def headers(self, sof: int, app: bool = True) -> list:
        """SOI, the colour kind's APP segment, the quantisation tables and
        the frame header of marker `sof`."""
        out = [b"\xff\xd8"]
        if app and self.kind in ADOBE:
            out.append(adobe_segment(ADOBE[self.kind]))
        elif app and self.kind in ("L", "YCbCr"):
            out.append(J._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                        b"\x01\x00\x00"))
        wide = self.precision > 8
        for k in sorted(set(self.tq)):
            qt = self.qts[k][ZIGZAG].astype(np.int64)
            body = b"".join(int(q).to_bytes(2, "big") for q in qt) if wide \
                else bytes(qt.astype(np.uint8))
            out.append(J._segment(0xDB, bytes([(wide << 4) | k]) + body))
        sof_body = bytes([self.precision]) + self.H.to_bytes(2, "big") + \
            self.W.to_bytes(2, "big") + bytes([len(self.ids)])
        for cid, (h, v), tq in zip(self.ids, self.factors, self.tq):
            sof_body += bytes([cid, (h << 4) | v, tq])
        out.append(J._segment(sof, sof_body))
        return out

    def sos(self, comps, ss, se, ah, al, tables) -> bytes:
        body = bytes([len(comps)])
        for c in comps:
            td, ta = tables(c)
            body += bytes([self.ids[c], (td << 4) | ta])
        return J._segment(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def adobe_segment(transform: int) -> bytes:
    return J._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                              transform]))


def _dri(n: int) -> bytes:
    return J._segment(0xDD, n.to_bytes(2, "big"))


def _shift(v: int, al: int) -> int:
    """An AC coefficient's point transform: |v| >> al, its sign kept."""
    return -((-v) >> al) if v < 0 else v >> al


# ---------------------------------------------------------------------------
# arithmetic coding: jcarith.c

class ArithEncoder:
    """jcarith.c's `arith_encode` and `finish_pass` (T.81 D.1): the C and A
    registers, the stacked 0xFF and zero bytes, the stuffed 0x00 after a
    data byte 0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe, nl, nm, switch = ARI[sv & 0x7F]
        nl |= switch << 7
        self.a -= qe
        if val != sv >> 7:                       # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:                              # renormalise, emit
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)


def _arith_magnitude(enc, stats, st, v, big):
    """Figures F.8 and F.9: the magnitude category of v - 1 from bin `st`
    and its bits 14 bins on. A DC value (`big` None) moves to bin 20 after
    the first decision; an AC one to `big` (189 or 217 by K) after the
    second."""
    m = 0
    v -= 1
    if v:
        enc.encode(stats, st, 1)
        m, v2 = 1, v >> 1
        if big is None:
            st = 20
        elif v2:
            enc.encode(stats, st, 1)
            m, v2, st = 2, v2 >> 1, big
        while v2:
            enc.encode(stats, st, 1)
            m, v2, st = m << 1, v2 >> 1, st + 1
    enc.encode(stats, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(stats, st, 1 if m & v else 0)
        m >>= 1


def write_arithmetic(frame: Frame, scans=None, restart: int = 0,
                     dac=None, app: bool = True) -> bytes:
    """The frame arithmetic-coded: sequential (SOF9, one interleaved scan)
    without `scans`, else progressive (SOF10) with the scan script `scans`
    of (component indices, Ss, Se, Ah, Al). A restart marker every
    `restart` MCUs; `dac` {table: (L, U)} for the DC tables and
    {16 + table: K} for the AC ones, written in a DAC segment (the
    luma components use table 0, the others 1)."""
    n = len(frame.ids)
    progressive = scans is not None
    if not progressive:
        scans = [(tuple(range(n)), 0, 63, 0, 0)]
    tbl = [0] + [1] * (n - 1)
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
    out = frame.headers(0xCA if progressive else 0xC9, app)
    if dac:
        body = b""
        for idx, val in sorted(dac.items()):
            if idx < 16:
                dc_l[idx], dc_u[idx] = val
                body += bytes([idx, (val[1] << 4) | val[0]])
            else:
                ac_k[idx - 16] = val
                body += bytes([idx, val])
        out.append(J._segment(0xCC, body))
    if restart:
        out.append(_dri(restart))
    for comps, ss, se, ah, al in scans:
        out.append(frame.sos(comps, ss, se, ah, al,
                             lambda c: (tbl[c], tbl[c])))
        enc = ArithEncoder()
        dc_stats = {t: bytearray(64) for t in range(2)}
        ac_stats = {t: bytearray(256) for t in range(2)}
        fixed = bytearray([113])
        last, ctx = [0] * 4, [0] * 4

        def reset_stats():
            for i, c in enumerate(comps):
                if not progressive or (ss == 0 and ah == 0):
                    dc_stats[tbl[c]][:] = bytes(64)
                    last[i] = ctx[i] = 0
                if not progressive or ss:
                    ac_stats[tbl[c]][:] = bytes(256)

        reset_stats()
        rst = 0
        for m, mcu in enumerate(frame.scan_blocks(comps)):
            if restart and m and m % restart == 0:
                enc.finish()
                enc.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                reset_stats()
                enc.reset()
            for i, blk in mcu:
                t = tbl[comps[i]]
                if not progressive or (ss == 0 and ah == 0):
                    dcv = int(blk[0]) >> al
                    st_stats, st = dc_stats[t], ctx[i]
                    v = dcv - last[i]
                    if v == 0:
                        enc.encode(st_stats, st, 0)
                        ctx[i] = 0
                    else:
                        last[i] = dcv
                        enc.encode(st_stats, st, 1)
                        sign = v < 0
                        enc.encode(st_stats, st + 1, int(sign))
                        v = abs(v)
                        ctx[i] = 8 if sign else 4
                        st += 3 if sign else 2
                        mm = v - 1
                        cat = 0
                        while mm >> cat:
                            cat += 1          # bits of v - 1
                        m_top = 1 << (cat - 1) if cat else 0
                        if m_top < ((1 << dc_l[t]) >> 1):
                            ctx[i] = 0
                        elif m_top > ((1 << dc_u[t]) >> 1):
                            ctx[i] += 8
                        _arith_magnitude(enc, st_stats, st, v, None)
                    if not progressive:
                        _arith_ac(enc, ac_stats[t], blk, 1, 63, 0,
                                  ac_k[t], fixed)
                elif ss == 0:
                    enc.encode(fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    _arith_ac(enc, ac_stats[t], blk, ss, se, al, ac_k[t],
                              fixed)
                else:
                    _arith_refine(enc, ac_stats[t], blk, ss, se, ah, al,
                                  fixed)
        enc.finish()
        out.append(bytes(enc.out))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _arith_ac(enc, stats, blk, ss, se, al, k_cond, fixed):
    """Figure F.5 (jcarith.c's encode_mcu and encode_mcu_AC_first): the band
    [ss, se] at point transform al."""
    vals = [_shift(int(blk[k]), al) for k in range(64)]
    ke = se
    while ke >= ss and vals[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        enc.encode(stats, st, 0)                 # not the end of the band
        while vals[k] == 0:
            enc.encode(stats, st + 1, 0)
            st += 3
            k += 1
        enc.encode(stats, st + 1, 1)
        v = vals[k]
        enc.encode(fixed, 0, int(v < 0))
        _arith_magnitude(enc, stats, st + 2, abs(v),
                         189 if k <= k_cond else 217)
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)        # end of band


def _arith_refine(enc, stats, blk, ss, se, ah, al, fixed):
    """Figure G.10 (jcarith.c's encode_mcu_AC_refine): a correction bit for
    each coefficient already nonzero, the newly nonzero ones."""
    now = [abs(int(blk[k])) >> al for k in range(64)]
    ke = se
    while ke >= ss and now[ke] == 0:
        ke -= 1
    kex = ke
    while kex >= ss and abs(int(blk[kex])) >> ah == 0:
        kex -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            enc.encode(stats, st, 0)
        while True:
            v = now[k]
            if v:
                if v >> 1:
                    enc.encode(stats, st + 2, v & 1)
                else:
                    enc.encode(stats, st + 1, 1)
                    enc.encode(fixed, 0, int(blk[k] < 0))
                break
            enc.encode(stats, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


# ---------------------------------------------------------------------------
# Huffman coding: tables of one code length, and jcphuff.c's progression

def flat_table(symbols) -> tuple:
    """A Huffman table giving every symbol a code of the same length (the
    shortest that leaves the all-ones code unused): (counts, symbols)."""
    symbols = sorted(symbols)
    n = 1
    while (1 << n) - 1 < len(symbols):
        n += 1
    counts = [0] * 16
    counts[n - 1] = len(symbols)
    return counts, symbols


DC_FLAT = flat_table(range(16))
AC_FLAT = flat_table([(r << 4) | s for r in range(16) for s in range(15)])


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def flush(self) -> bytes:
        """The bits padded with ones to a byte, 0xFF stuffed."""
        bits = self.bits + [1] * (-len(self.bits) % 8)
        self.bits = []
        data = np.packbits(np.array(bits, np.uint8)).tobytes() if bits \
            else b""
        return data.replace(b"\xff", b"\xff\x00")


def _category(v: int) -> int:
    return abs(v).bit_length()


def _extra(v: int, s: int) -> int:
    return (v if v >= 0 else v + (1 << s) - 1) & ((1 << s) - 1)


def write_progressive_huffman(frame: Frame, scans, restart: int = 0,
                              app: bool = True) -> bytes:
    """The frame Huffman-coded (SOF2) with the scan script `scans` of
    (component indices, Ss, Se, Ah, Al), as jcphuff.c codes each kind of
    scan (end-of-band runs, correction bits), with one-length tables
    (`flat_table`); a restart marker every `restart` MCUs."""
    dc_codes, ac_codes = J._codes(DC_FLAT), J._codes(AC_FLAT)
    out = frame.headers(0xC2, app)
    out.append(J._segment(0xC4, J._dht(0, 0, DC_FLAT)))
    out.append(J._segment(0xC4, J._dht(1, 0, AC_FLAT)))
    if restart:
        out.append(_dri(restart))
    for comps, ss, se, ah, al in scans:
        out.append(frame.sos(comps, ss, se, ah, al, lambda c: (0, 0)))
        bw = BitWriter()
        state = {"eobrun": 0, "be": []}
        last = [0] * 4

        def sym(codes, s):
            bw.put(int(codes[0][s]), int(codes[1][s]))

        def emit_eobrun():
            run = state["eobrun"]
            if run:
                nbits = run.bit_length() - 1
                sym(ac_codes, nbits << 4)
                bw.put(run, nbits)
                state["eobrun"] = 0
                for b in state["be"]:
                    bw.put(b, 1)
                state["be"] = []

        data = []
        rst = 0
        for m, mcu in enumerate(frame.scan_blocks(comps)):
            if restart and m and m % restart == 0:
                emit_eobrun()
                data.append(bw.flush() + bytes([0xFF, 0xD0 + rst]))
                rst = (rst + 1) & 7
                last = [0] * 4
            for i, blk in mcu:
                if ss == 0 and ah == 0:
                    v = int(blk[0]) >> al
                    d = v - last[i]
                    last[i] = v
                    s = _category(d)
                    sym(dc_codes, s)
                    bw.put(_extra(d, s), s)
                elif ss == 0:
                    bw.put((int(blk[0]) >> al) & 1, 1)
                elif ah == 0:
                    _huff_ac_first(bw, sym, ac_codes, emit_eobrun, state,
                                   blk, ss, se, al)
                else:
                    _huff_ac_refine(bw, sym, ac_codes, emit_eobrun, state,
                                    blk, ss, se, al)
        emit_eobrun()
        data.append(bw.flush())
        out.append(b"".join(data))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _huff_ac_first(bw, sym, codes, emit_eobrun, state, blk, ss, se, al):
    r = 0
    for k in range(ss, se + 1):
        v = _shift(int(blk[k]), al)
        if v == 0:
            r += 1
            continue
        emit_eobrun()
        while r > 15:
            sym(codes, 0xF0)
            r -= 16
        s = _category(v)
        sym(codes, (r << 4) | s)
        bw.put(_extra(v, s), s)
        r = 0
    if r > 0:
        state["eobrun"] += 1
        if state["eobrun"] == 0x7FFF:
            emit_eobrun()


def _huff_ac_refine(bw, sym, codes, emit_eobrun, state, blk, ss, se, al):
    absv = {k: abs(int(blk[k])) >> al for k in range(ss, se + 1)}
    eob = max([k for k, v in absv.items() if v == 1], default=0)
    r = 0
    br = []
    for k in range(ss, se + 1):
        v = absv[k]
        if v == 0:
            r += 1
            continue
        while r > 15 and k <= eob:
            emit_eobrun()
            sym(codes, 0xF0)
            r -= 16
            for b in br:
                bw.put(b, 1)
            br = []
        if v > 1:
            br.append(v & 1)
            continue
        emit_eobrun()
        sym(codes, (r << 4) | 1)
        bw.put(0 if blk[k] < 0 else 1, 1)
        for b in br:
            bw.put(b, 1)
        br = []
        r = 0
    if r > 0 or br:
        state["eobrun"] += 1
        state["be"] += br
        if state["eobrun"] == 0x7FFF or len(state["be"]) > 937:
            emit_eobrun()


def write_sequential_huffman(frame: Frame, restart: int = 0,
                             app: bool = True) -> bytes:
    """The frame as one interleaved Huffman scan (SOF0, or SOF1 at 12
    bits) with one-length tables; a restart marker every `restart`
    MCUs."""
    dc_codes, ac_codes = J._codes(DC_FLAT), J._codes(AC_FLAT)
    comps = tuple(range(len(frame.ids)))
    out = frame.headers(0xC1 if frame.precision > 8 else 0xC0, app)
    out.append(J._segment(0xC4, J._dht(0, 0, DC_FLAT)))
    out.append(J._segment(0xC4, J._dht(1, 0, AC_FLAT)))
    if restart:
        out.append(_dri(restart))
    out.append(frame.sos(comps, 0, 63, 0, 0, lambda c: (0, 0)))
    bw = BitWriter()
    last = [0] * 4
    data = []
    rst = 0
    for m, mcu in enumerate(frame.scan_blocks(comps)):
        if restart and m and m % restart == 0:
            data.append(bw.flush() + bytes([0xFF, 0xD0 + rst]))
            rst = (rst + 1) & 7
            last = [0] * 4
        for i, blk in mcu:
            d = int(blk[0]) - last[i]
            last[i] = int(blk[0])
            s = _category(d)
            bw.put(int(dc_codes[0][s]), int(dc_codes[1][s]))
            bw.put(_extra(d, s), s)
            r = 0
            nz = [k for k in range(1, 64) if blk[k]]
            for k in range(1, 64):
                v = int(blk[k])
                if v == 0:
                    r += 1
                    continue
                while r > 15:
                    bw.put(int(ac_codes[0][0xF0]), int(ac_codes[1][0xF0]))
                    r -= 16
                s = _category(v)
                code = (r << 4) | s
                bw.put(int(ac_codes[0][code]), int(ac_codes[1][code]))
                bw.put(_extra(v, s), s)
                r = 0
            if not nz or nz[-1] < 63:
                bw.put(int(ac_codes[0][0]), int(ac_codes[1][0]))
    data.append(bw.flush())
    out += [b"".join(data), b"\xff\xd9"]
    return b"".join(out)


# ---------------------------------------------------------------------------
# lossless (SOF3), hierarchical

def _predict(psv, ra, rb, rc):
    return [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
            rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv]


def write_lossless(img, psv: int = 1, pt: int = 0, kind: str = "L",
                   factors=(1, 1), restart_rows: int = 0,
                   interleave: bool = True) -> bytes:
    """A lossless file (SOF3) of an (H, W) grey or (H, W, 3) image (`kind`
    `L`, `RGB` with an Adobe segment of transform 0, or `YCbCr`, whose
    planes go in unconverted): each sample's difference from predictor
    `psv` at point transform `pt`, Huffman-coded with the standard DC luma
    table; the first row of the scan and of each restart interval
    predicted from 2^(7 - pt) and the left sample, the first column of
    the others from the sample above. Luma at `factors` (h, v) over the
    chroma planes (taken every h-th column and v-th row); one interleaved
    scan, or one scan each (`interleave=False`); a restart every
    `restart_rows` MCU rows."""
    img = np.asarray(img).astype(np.int64) >> pt
    H, W = img.shape[:2]
    planes = [img] if img.ndim == 2 else [img[..., k] for k in range(3)]
    n = len(planes)
    fac = [(1, 1)] if n == 1 else [tuple(factors), (1, 1), (1, 1)]
    hm, vm = fac[0]
    planes = [p if f == (hm, vm) else p[::vm, ::hm]
              for p, f in zip(planes, fac)]
    codes = J._codes(J.DC_LUMA)
    out = [b"\xff\xd8"]
    if kind == "RGB":
        out.append(adobe_segment(0))
    elif kind == "YCbCr":
        out.append(J._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                    b"\x01\x00\x00"))
    sof = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + \
        bytes([n])
    for k, (h, v) in enumerate(fac):
        sof += bytes([k + 1, (h << 4) | v, 0])
    out.append(J._segment(0xC3, sof))
    out.append(J._segment(0xC4, J._dht(0, 0, J.DC_LUMA)))
    groups = [tuple(range(n))] if interleave else [(k,) for k in range(n)]
    mx, my = -(-W // hm), -(-H // vm)
    for comps in groups:
        single = len(comps) == 1
        nx = planes[comps[0]].shape[1] if single else mx
        ny = planes[comps[0]].shape[0] if single else my
        if restart_rows:
            out.append(_dri(restart_rows * nx))
        body = bytes([len(comps)])
        for c in comps:
            body += bytes([c + 1, 0])
        out.append(J._segment(0xDA, body + bytes([psv, 0, pt])))
        diffs = []
        for c in comps:
            p = planes[c]
            d = np.zeros_like(p)
            for y in range(p.shape[0]):
                row_mcu = y // (1 if single else fac[c][1])
                first = y == 0 or (restart_rows and row_mcu % restart_rows
                                   == 0 and y % (1 if single else
                                                 fac[c][1]) == 0)
                for x in range(p.shape[1]):
                    if first:
                        pred = (1 << (7 - pt)) if x == 0 else p[y, x - 1]
                    elif x == 0:
                        pred = p[y - 1, 0]
                    else:
                        pred = _predict(psv, p[y, x - 1], p[y - 1, x],
                                        p[y - 1, x - 1])
                    d[y, x] = p[y, x] - pred
            diffs.append(d)
        bw = BitWriter()
        data = []
        rst = 0
        for yy in range(ny):
            if restart_rows and yy and yy % restart_rows == 0:
                data.append(bw.flush() + bytes([0xFF, 0xD0 + rst]))
                rst = (rst + 1) & 7
            for xx in range(nx):
                for i, c in enumerate(comps):
                    h, v = (1, 1) if single else fac[c]
                    for by in range(v):
                        for bx in range(h):
                            y, x = yy * v + by, xx * h + bx
                            dd = diffs[i]
                            val = int(dd[y, x]) if y < dd.shape[0] and \
                                x < dd.shape[1] else 0
                            s = _category(val)
                            bw.put(int(codes[0][s]), int(codes[1][s]))
                            bw.put(_extra(val, s), s)
        data.append(bw.flush())
        out.append(b"".join(data))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_hierarchical(img) -> bytes:
    """A hierarchical file: DHP, a first frame (SOF0) at half size, then
    EXP and a differential frame (SOF5) at full size whose differences
    are all zero; (H, W) grey."""
    img = np.asarray(img)
    H, W = img.shape
    small = Frame(img[::2, ::2], "L", 75)
    dc_codes, ac_codes = J._codes(DC_FLAT), J._codes(AC_FLAT)
    out = [b"\xff\xd8"]
    out += small.headers(0xC1)[2:-1]            # the quantisation table
    out.append(J._segment(0xDE, bytes([8]) + H.to_bytes(2, "big") +
                          W.to_bytes(2, "big") + bytes([1, 1, 0x11, 0])))
    body = write_sequential_huffman(small, app=False)
    out.append(body[body.index(b"\xff\xc0"):-2])   # the first frame
    out.append(J._segment(0xDF, bytes([0x11])))
    out.append(J._segment(0xC5, bytes([8]) + H.to_bytes(2, "big") +
                          W.to_bytes(2, "big") + bytes([1, 1, 0x11, 0])))
    out.append(J._segment(0xDA, bytes([1, 1, 0, 0, 63, 0])))
    bw = BitWriter()
    for _ in range(-(-H // 8) * -(-W // 8)):
        bw.put(int(dc_codes[0][0]), int(dc_codes[1][0]))
        bw.put(int(ac_codes[0][0]), int(ac_codes[1][0]))
    out += [bw.flush(), b"\xff\xd9"]
    return b"".join(out)
