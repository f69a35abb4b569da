// Baseline, extended-sequential and progressive Huffman JPEG decoder for
// the port's dataset readers (host code, no libjpeg). Its output is
// bit-equal to libjpeg-turbo's with the decoder defaults that PIL's
// `Image.open` uses: the integer ("islow") inverse DCT with its range
// limiting, fancy upsampling of subsampled chroma, and the fixed-point
// YCbCr -> RGB tables.
//
// Reads 8-bit Huffman files, sequential (SOF0, SOF1) or progressive
// (SOF2: the DC first and refine scans, the AC first and refine scans
// with end-of-band runs and successive approximation, as jdphuff.c
// decodes them, into a coefficient buffer of the whole image), of 1
// component (grey) or 3: YCbCr (JFIF, Adobe transform other than 0, or
// unmarked) or RGB (Adobe transform 0, or unmarked with component ids
// 'R', 'G', 'B'; no colour conversion). Any integral sampling factors
// from 1 to 4, interleaved or not, restart intervals, any Huffman and
// quantisation tables, any size. Anything else (arithmetic coding,
// lossless, 12-bit, CMYK / YCCK, a progressive file whose scans leave
// low coefficient bits unsent, for which libjpeg smooths the blocks,
// truncated or corrupt data) fails with a message naming the cause.
//
// C interface: `jd_decode(data, size, dims, &out)` decodes a whole file
// held in memory; on success it returns 0, sets dims = {H, W, C} and
// *out to an H * W * C uint8 buffer that the caller releases with
// `jd_free`; on failure it returns -1 and `jd_error()` says why.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared -o libjpeg_decode.so jpeg_decode.cc

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Bad : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string &why) { throw Bad(why); }

std::string marker_name(int m) {
  char buf[8];
  std::snprintf(buf, sizeof buf, "0x%02X", m);
  std::string hex = std::string("marker ") + buf;
  switch (m) {
    case 0xC3: return "lossless (SOF3, " + hex + ")";
    case 0xC5: case 0xC6: case 0xC7:
      return "hierarchical (SOF" + std::to_string(m - 0xC0) + ", " + hex + ")";
    case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
      return "arithmetic coding (SOF" + std::to_string(m - 0xC0) + ", " +
             hex + ")";
    case 0xCC: return "arithmetic conditioning (DAC, " + hex + ")";
    case 0xDC: return "DNL (" + hex + ")";
    default: return hex;
  }
}

// zig-zag position -> natural (row-major) position in an 8x8 block
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int maxcode[17];   // largest code of each length, -1 if none
  int valptr[17];    // index in vals of the first code of each length
  int mincode[17];
  // 9-bit lookahead: (length << 8) | symbol, 0 where the code is longer
  uint16_t look[512];

  void build(const uint8_t counts[16], const uint8_t *symbols, int n,
             bool dc) {
    std::memcpy(vals, symbols, n);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof look);
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      code += counts[len - 1];
      k += counts[len - 1];
      // one past the last code must fit: no code is all ones
      if (counts[len - 1] && code >= (1 << len)) fail("bad Huffman table");
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (len <= 9) {
        for (int c = mincode[len]; c < code; ++c) {
          int sym = vals[valptr[len] + c - mincode[len]];
          int shift = 9 - len;
          for (int f = 0; f < (1 << shift); ++f)
            look[(c << shift) | f] = static_cast<uint16_t>((len << 8) | sym);
        }
      }
      code <<= 1;
    }
    if (dc)
      for (int i = 0; i < n; ++i)
        if (vals[i] > 15) fail("bad Huffman table (DC symbol above 15)");
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;              // the current scan's table selectors
  int bw = 0, bh = 0;              // blocks a row / column, MCU-padded
  int dw = 0, dh = 0;              // downsampled width and height
  bool seen = false;               // coded by some scan
  uint16_t qt[64];                 // its table, latched at its first scan
  int coef_bits[64];               // progressive: the lowest bit sent, -1
  std::vector<int16_t> coef;       // bh * bw blocks of 64, natural order
};

class BitReader {
 public:
  BitReader(const uint8_t *d, size_t n, size_t pos)
      : d_(d), n_(n), pos_(pos) {}

  size_t pos() const { return pos_; }

  // zero bits are fed once a marker or the end of the data is reached;
  // consuming any of them means the entropy-coded segment was short
  void fill() {
    while (cnt_ <= 56) {
      uint32_t byte = 0;
      if (!stopped_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) ++q;   // fill bytes
          if (q < n_ && d_[q] == 0x00) {
            pos_ = q + 1;
          } else {
            stopped_ = true;   // a marker: leave pos_ on its first 0xFF
            byte = 0;
            fake_ += 8;
          }
        } else {
          ++pos_;
        }
      } else {
        stopped_ = true;
        fake_ += 8;
      }
      buf_ |= static_cast<uint64_t>(byte) << (56 - cnt_);
      cnt_ += 8;
    }
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (cnt_ < n) fill();
    int v = static_cast<int>(buf_ >> (64 - n));
    buf_ <<= n;
    cnt_ -= n;
    return v;
  }

  int bit() { return bits(1); }

  int decode(const Huffman &t) {
    if (cnt_ < 16) fill();
    int e = t.look[buf_ >> 55];
    if (e) {
      int len = e >> 8;
      buf_ <<= len;
      cnt_ -= len;
      return e & 0xFF;
    }
    int code = static_cast<int>(buf_ >> 55);   // the first 9 bits
    buf_ <<= 9;
    cnt_ -= 9;
    int len = 9;
    while (code > t.maxcode[len]) {
      code = (code << 1) | bit();
      if (++len > 16) fail("corrupt data (bad Huffman code)");
    }
    return t.vals[t.valptr[len] + code - t.mincode[len]];
  }

  bool overrun() const { return cnt_ < fake_; }

  // drop the rest of the current byte and the bits read ahead; the
  // decoder resumes at pos_
  void reset() {
    buf_ = 0;
    cnt_ = 0;
    fake_ = 0;
    stopped_ = false;
  }

 private:
  const uint8_t *d_;
  size_t n_, pos_;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  int fake_ = 0;       // zero bits appended past the segment's end
  bool stopped_ = false;
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

class Decoder {
 public:
  Decoder(const uint8_t *d, size_t n) : d_(d), n_(n) {}

  std::vector<uint8_t> run(int dims[3]) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                                   // EOI
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) { read_sof(m); continue; }
      if ((m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8) || m == 0xDC)
        fail("unsupported " + marker_name(m));
      if (m == 0xC4) { read_dht(); continue; }
      if (m == 0xDB) { read_dqt(); continue; }
      if (m == 0xDD) { read_dri(); continue; }
      if (m == 0xDA) { read_sos(); continue; }
      if (m == 0xE0) { read_app(m); continue; }
      if (m == 0xEE) { read_app(m); continue; }
      if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xC8 ||
          (m >= 0xF0 && m <= 0xFD)) {
        skip_segment();
        continue;
      }
      fail("unexpected " + marker_name(m) + " at byte " +
           std::to_string(pos_ - 2));
    }
    if (comps_.empty()) fail("no frame header (SOF) before EOI");
    for (auto &c : comps_)
      if (!c.seen) fail("a component was never coded by a scan");
    return output(dims);
  }

 private:
  const uint8_t *d_;
  size_t n_, pos_ = 0;
  int H_ = 0, W_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool progressive_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  uint16_t q_[4][64];
  bool q_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;

  int byte() {
    if (pos_ >= n_) fail("truncated file");
    return d_[pos_++];
  }

  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    if (byte() != 0xFF)
      fail("expected a marker at byte " + std::to_string(pos_ - 1));
    int m;
    do m = byte(); while (m == 0xFF);
    if (m == 0x00) fail("expected a marker at byte " + std::to_string(pos_));
    return m;
  }

  // the segment's payload: [start, end) after its 2-byte length
  size_t segment(size_t *end) {
    int len = word();
    if (len < 2 || pos_ + len - 2 > n_) fail("truncated segment");
    *end = pos_ + len - 2;
    return pos_;
  }

  void skip_segment() {
    size_t end;
    segment(&end);
    pos_ = end;
  }

  void read_app(int m) {
    size_t end, p = segment(&end);
    size_t len = end - p;
    if (m == 0xE0 && len >= 5 && std::memcmp(d_ + p, "JFIF\0", 5) == 0)
      jfif_ = true;
    if (m == 0xEE && len >= 12 && std::memcmp(d_ + p, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = d_[p + 11];
    }
    pos_ = end;
  }

  void read_sof(int m) {
    if (!comps_.empty()) fail("a second frame header (SOF)");
    progressive_ = m == 0xC2;
    size_t end;
    segment(&end);
    int precision = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (SOF" +
           std::to_string(m - 0xC0) + "); only 8-bit is read");
    H_ = word();
    W_ = word();
    if (H_ == 0) fail("height 0 (defined by a DNL marker) is not read");
    if (W_ == 0) fail("width 0");
    int nc = byte();
    if (nc != 1 && nc != 3)
      fail(std::to_string(nc) + " components (CMYK / YCCK or other); "
           "only 1 (grey) and 3 (YCbCr) are read");
    comps_.resize(nc);
    for (auto &c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component sampling factors or table");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    if (pos_ != end) fail("bad SOF length");
    for (auto &c : comps_)
      if (hmax_ % c.h || vmax_ % c.v)
        fail("fractional sampling factors");
    mcux_ = (W_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (H_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto &c : comps_) {
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.dw = static_cast<int>((static_cast<long>(W_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<long>(H_) * c.v + vmax_ - 1) / vmax_);
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
  }

  void read_dht() {
    size_t end;
    segment(&end);
    while (pos_ < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table class or id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = byte();
      if (total > 256 || pos_ + total > end) fail("bad Huffman table");
      (tc ? ac_ : dc_)[th].build(counts, d_ + pos_, total, tc == 0);
      pos_ += total;
    }
    if (pos_ != end) fail("bad DHT length");
  }

  void read_dqt() {
    size_t end;
    segment(&end);
    while (pos_ < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail("bad quantisation table precision or id");
      for (int i = 0; i < 64; ++i)
        q_[tq][kNatural[i]] = static_cast<uint16_t>(pq ? word() : byte());
      q_defined_[tq] = true;
    }
    if (pos_ != end) fail("bad DQT length");
  }

  void read_dri() {
    size_t end;
    segment(&end);
    restart_ = word();
    if (pos_ != end) fail("bad DRI length");
  }

  void read_sos() {
    if (comps_.empty()) fail("a scan (SOS) before the frame header (SOF)");
    size_t end;
    segment(&end);
    int ns = byte();
    if (ns < 1 || ns > 4 || ns > static_cast<int>(comps_.size()))
      fail("bad scan component count");
    std::vector<Component *> sc;
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component *c = nullptr;
      for (auto &k : comps_)
        if (k.id == id) c = &k;
      if (c == nullptr) fail("a scan names an unknown component");
      for (auto *o : sc)
        if (o == c) fail("a scan names a component twice");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) fail("bad Huffman table selector");
      sc.push_back(c);
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (!progressive_ && (ss != 0 || se != 63 || a != 0))
      fail("spectral selection or successive approximation in a "
           "sequential scan");
    if (progressive_ &&
        (ss > se || se > 63 || (ss == 0 && se != 0) ||
         (ss > 0 && ns != 1) || ah > 13 || al > 13 || (ah && ah != al + 1)))
      fail("bad progressive scan parameters (Ss " + std::to_string(ss) +
           ", Se " + std::to_string(se) + ", Ah " + std::to_string(ah) +
           ", Al " + std::to_string(al) + ")");
    if (pos_ != end) fail("bad SOS length");
    const bool dc_scan = ss == 0, first = ah == 0;
    int blocks_per_mcu = 0;
    for (auto *c : sc) {
      if ((dc_scan && first && !dc_[c->td].defined) ||
          (!dc_scan && !ac_[c->ta].defined) ||
          (!progressive_ && !ac_[c->ta].defined))
        fail("a scan uses an undefined Huffman table");
      if (!c->seen) {
        if (!q_defined_[c->tq]) fail("a component's quantisation table is "
                                     "undefined");
        std::memcpy(c->qt, q_[c->tq], sizeof c->qt);
      }
      blocks_per_mcu += ns == 1 ? 1 : c->h * c->v;
      c->seen = true;
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
    if (blocks_per_mcu > 10) fail("more than 10 blocks in an MCU");
    decode_scan(sc, ss, se, ah, al);
  }

  // one scan's blocks; a sequential scan codes each block whole, a
  // progressive one the band [ss, se] of it at bit al (refining bit al of
  // what earlier scans sent where ah > 0)
  void decode_scan(const std::vector<Component *> &sc, int ss, int se,
                   int ah, int al) {
    const bool single = sc.size() == 1;
    // a single-component scan codes the component's own blocks, one an
    // MCU; an interleaved one whole MCUs of h x v blocks per component
    int nx, ny;
    if (single) {
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux_;
      ny = mcuy_;
    }
    long total = static_cast<long>(nx) * ny;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    BitReader br(d_, n_, pos_);
    int next_rst = 0;
    for (long mcu = 0; mcu < total; ++mcu) {
      if (restart_ && mcu && mcu % restart_ == 0) {
        // byte-align, expect RSTn, reset the DC predictors
        br.reset();
        size_t p = br.pos();
        while (p < n_ && d_[p] == 0xFF) ++p;
        if (p >= n_ || d_[p] != 0xD0 + next_rst || d_[p - 1] != 0xFF)
          fail("corrupt data (missing restart marker RST" +
               std::to_string(next_rst) + ")");
        br = BitReader(d_, n_, p + 1);
        next_rst = (next_rst + 1) & 7;
        std::memset(pred, 0, sizeof pred);
        eobrun = 0;
      }
      int mx = static_cast<int>(mcu % nx), my = static_cast<int>(mcu / nx);
      for (size_t k = 0; k < sc.size(); ++k) {
        Component &c = *sc[k];
        int h = single ? 1 : c.h, v = single ? 1 : c.v;
        for (int by = 0; by < v; ++by)
          for (int bx = 0; bx < h; ++bx) {
            int row = my * v + by, col = mx * h + bx;
            int16_t *blk = &c.coef[(static_cast<size_t>(row) * c.bw + col) * 64];
            if (!progressive_)
              decode_block(br, dc_[c.td], ac_[c.ta], &pred[k], blk);
            else if (ss == 0 && ah == 0)
              dc_first(br, dc_[c.td], &pred[k], blk, al);
            else if (ss == 0)
              blk[0] = static_cast<int16_t>(blk[0] | (br.bit() << al));
            else if (ah == 0)
              ac_first(br, ac_[c.ta], blk, ss, se, al, &eobrun);
            else
              ac_refine(br, ac_[c.ta], blk, ss, se, al, &eobrun);
          }
      }
      if (br.overrun()) fail("truncated or corrupt data (the scan ends "
                             "inside an MCU)");
    }
    // the scan ends at the next marker, after any padding bits
    br.reset();
    size_t p = br.pos();
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 &&
                           d_[p + 1] != 0xFF))
      ++p;
    if (p + 1 >= n_) fail("truncated file (no marker after the scan)");
    pos_ = p;
  }

  void decode_block(BitReader &br, const Huffman &dc, const Huffman &ac,
                    int *pred, int16_t *blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = br.decode(dc);
    int diff = s ? extend(br.bits(s), s) : 0;
    *pred += diff;
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt data (coefficient index past 63)");
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_DC_first: the DC difference, scaled by 2^al
  void dc_first(BitReader &br, const Huffman &dc, int *pred, int16_t *blk,
                int al) {
    int s = br.decode(dc);
    *pred += s ? extend(br.bits(s), s) : 0;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(*pred) << al);
  }

  // jdphuff.c's decode_mcu_AC_first: the band's first bits, or one block
  // of a pending end-of-band run
  void ac_first(BitReader &br, const Huffman &ac, int16_t *blk, int ss,
                int se, int al, int *eobrun) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt data (coefficient index past the band)");
        blk[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(extend(br.bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = (1 << r) - 1 + (r ? br.bits(r) : 0);
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_AC_refine: a correction bit for each nonzero
  // coefficient passed over, and a new +-2^al coefficient after each run
  // of zero ones
  void ac_refine(BitReader &br, const Huffman &ac, int16_t *blk, int ss,
                 int se, int al, int *eobrun) {
    const int p1 = 1 << al, m1 = -p1;
    auto refine = [&](int16_t &c) {
      if (br.bit() && (c & p1) == 0)
        c = static_cast<int16_t>(c + (c >= 0 ? p1 : m1));
    };
    int k = ss;
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt data (bad refinement coefficient size)");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          *eobrun = (1 << r) + (r ? br.bits(r) : 0);
          break;
        }
        do {
          int16_t &c = blk[kNatural[k]];
          if (c != 0)
            refine(c);
          else if (--r < 0)
            break;
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) fail("corrupt data (coefficient index past the band)");
          blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t &c = blk[kNatural[k]];
        if (c != 0) refine(c);
      }
      --*eobrun;
    }
  }

  // jidctint.c's jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2; the result
  // wrapped to 10 bits and range-limited as libjpeg's post-IDCT table
  static inline uint8_t limit(int64_t x) {
    int v = static_cast<int>(x & 1023);
    if (v >= 512) v -= 1024;
    v += 128;
    return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
  }

  static void idct(const int16_t *in, const uint16_t *qt, uint8_t *out,
                   int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                      F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) -> int64_t {
      return (x + (int64_t(1) << (n - 1))) >> n;
    };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      auto dq = [&](int r) -> int64_t {
        return static_cast<int64_t>(in[r * 8 + c]) *
               static_cast<int16_t>(qt[r * 8 + c]);
      };
      if (!(in[8 + c] | in[16 + c] | in[24 + c] | in[32 + c] | in[40 + c] |
            in[48 + c] | in[56 + c])) {
        // AC terms all zero: the full pass gives the DC term for all 8
        int dc = static_cast<int>(dq(0) * (1 << P1));
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
        continue;
      }
      int64_t z2 = dq(2), z3 = dq(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = dq(0);
      z3 = dq(4);
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << CB);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << CB);
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
      int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = dq(7);
      tmp1 = dq(5);
      tmp2 = dq(3);
      tmp3 = dq(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      ws[0 * 8 + c] = static_cast<int>(descale(t10 + tmp3, CB - P1));
      ws[7 * 8 + c] = static_cast<int>(descale(t10 - tmp3, CB - P1));
      ws[1 * 8 + c] = static_cast<int>(descale(t11 + tmp2, CB - P1));
      ws[6 * 8 + c] = static_cast<int>(descale(t11 - tmp2, CB - P1));
      ws[2 * 8 + c] = static_cast<int>(descale(t12 + tmp1, CB - P1));
      ws[5 * 8 + c] = static_cast<int>(descale(t12 - tmp1, CB - P1));
      ws[3 * 8 + c] = static_cast<int>(descale(t13 + tmp0, CB - P1));
      ws[4 * 8 + c] = static_cast<int>(descale(t13 - tmp0, CB - P1));
    }
    for (int r = 0; r < 8; ++r) {
      const int *w = ws + r * 8;
      uint8_t *o = out + r * stride;
      if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
        uint8_t dc = limit(descale(w[0], P1 + 3));
        std::memset(o, dc, 8);
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CB);
      int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CB);
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
      int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int D = CB + P1 + 3;
      o[0] = limit(descale(t10 + tmp3, D));
      o[7] = limit(descale(t10 - tmp3, D));
      o[1] = limit(descale(t11 + tmp2, D));
      o[6] = limit(descale(t11 - tmp2, D));
      o[2] = limit(descale(t12 + tmp1, D));
      o[5] = limit(descale(t12 - tmp1, D));
      o[3] = limit(descale(t13 + tmp0, D));
      o[4] = limit(descale(t13 - tmp0, D));
    }
  }

  // a component's samples, (bh * 8) x (bw * 8), row stride bw * 8
  std::vector<uint8_t> samples(const Component &c) const {
    int stride = c.bw * 8;
    std::vector<uint8_t> s(static_cast<size_t>(stride) * c.bh * 8);
    const uint16_t *qt = c.qt;
    int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
    for (int by = 0; by < rows; ++by)
      for (int bx = 0; bx < cols; ++bx)
        idct(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], qt,
             &s[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
    return s;
  }

  // the component at full size, W_ x H_, as jdsample.c upsamples it with
  // do_fancy_upsampling: rows past dh repeat row dh - 1, row -1 repeats
  // row 0 (jdmainct.c's context pointers)
  std::vector<uint8_t> upsample(const Component &c,
                                const std::vector<uint8_t> &s) const {
    const int stride = c.bw * 8, rh = hmax_ / c.h, rv = vmax_ / c.v;
    const int W = W_, H = H_, dw = c.dw, dh = c.dh;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto in = [&](int y) { return &s[static_cast<size_t>(y) * stride]; };
    auto clampy = [&](int y) { return y < 0 ? 0 : y >= dh ? dh - 1 : y; };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[size_t(y) * W], in(y), W);
    } else if (rh == 2 && rv == 1 && dw > 2) {            // h2v1_fancy
      std::vector<uint8_t> row(2 * dw);
      for (int y = 0; y < H; ++y) {
        const uint8_t *p = in(y);
        for (int x = 0; x < dw; ++x) {
          int cur = p[x] * 3;
          int left = p[x > 0 ? x - 1 : 0], right = p[x < dw - 1 ? x + 1 : x];
          row[2 * x] = static_cast<uint8_t>((cur + left + 1) >> 2);
          row[2 * x + 1] = static_cast<uint8_t>((cur + right + 2) >> 2);
        }
        std::memcpy(&out[size_t(y) * W], row.data(), W);
      }
    } else if (rh == 1 && rv == 2) {                      // h1v2_fancy
      for (int y = 0; y < H; ++y) {
        int iy = y >> 1;
        const uint8_t *p0 = in(iy);
        const uint8_t *p1 = in(clampy(y & 1 ? iy + 1 : iy - 1));
        int bias = y & 1 ? 2 : 1;
        uint8_t *o = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x)
          o[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
      }
    } else if (rh == 2 && rv == 2 && dw > 2) {            // h2v2_fancy
      std::vector<int> sum(dw);
      std::vector<uint8_t> row(2 * dw);
      for (int y = 0; y < H; ++y) {
        int iy = y >> 1;
        const uint8_t *p0 = in(iy);
        const uint8_t *p1 = in(clampy(y & 1 ? iy + 1 : iy - 1));
        for (int x = 0; x < dw; ++x) sum[x] = p0[x] * 3 + p1[x];
        for (int x = 0; x < dw; ++x) {
          int cur = sum[x] * 3;
          int left = sum[x > 0 ? x - 1 : 0], right = sum[x < dw - 1 ? x + 1 : x];
          row[2 * x] = static_cast<uint8_t>((cur + left + 8) >> 4);
          row[2 * x + 1] = static_cast<uint8_t>((cur + right + 7) >> 4);
        }
        std::memcpy(&out[size_t(y) * W], row.data(), W);
      }
    } else {                                   // h2v1, h2v2 and int_upsample
      for (int y = 0; y < H; ++y) {
        const uint8_t *p = in(y / rv);
        uint8_t *o = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x) o[x] = p[x / rh];
      }
    }
    return out;
  }

  std::vector<uint8_t> output(int dims[3]) {
    const size_t npix = static_cast<size_t>(W_) * H_;
    dims[0] = H_;
    dims[1] = W_;
    // jdcoefct.c's smoothing_ok: libjpeg smooths the blocks of a
    // progressive image whose coefficients 1-9 lack low bits
    for (const auto &c : comps_)
      for (int k = 1; progressive_ && k <= 9; ++k)
        if (c.coef_bits[k] != 0)
          fail("a progressive file whose scans leave coefficient " +
               std::to_string(k) + " unrefined (libjpeg smooths its "
               "blocks)");
    if (comps_.size() == 1) {
      dims[2] = 1;
      return upsample(comps_[0], samples(comps_[0]));
    }
    // the colour space as jdapimin.c's default_decompress_parms guesses
    // it: JFIF files are YCbCr; Adobe ones RGB at transform 0, else YCbCr;
    // unmarked ones RGB with component ids 'R', 'G', 'B', else YCbCr
    const bool rgb_space =
        !jfif_ && (adobe_ ? adobe_transform_ == 0
                          : comps_[0].id == 82 && comps_[1].id == 71 &&
                                comps_[2].id == 66);
    std::vector<uint8_t> p[3];
    for (int k = 0; k < 3; ++k) p[k] = upsample(comps_[k], samples(comps_[k]));
    dims[2] = 3;
    if (rgb_space) {                      // jdcolor.c's rgb_rgb_convert
      std::vector<uint8_t> out(npix * 3);
      for (size_t i = 0; i < npix; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = p[k][i];
      return out;
    }
    // jdcolor.c's ycc_rgb_convert tables, SCALEBITS 16
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << SB) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    std::vector<uint8_t> rgb(npix * 3);
    for (size_t i = 0; i < npix; ++i) {
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
      rgb[3 * i] = clamp(y + cr_r[cr]);
      rgb[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB));
      rgb[3 * i + 2] = clamp(y + cb_b[cb]);
    }
    return rgb;
  }
};

}  // namespace

extern "C" {

int jd_decode(const uint8_t *data, size_t size, int *dims, uint8_t **out) {
  *out = nullptr;
  try {
    std::vector<uint8_t> img = Decoder(data, size).run(dims);
    *out = static_cast<uint8_t *>(std::malloc(img.size() ? img.size() : 1));
    if (*out == nullptr) fail("out of memory");
    std::memcpy(*out, img.data(), img.size());
    return 0;
  } catch (const Bad &e) {
    g_error = e.what();
  } catch (const std::bad_alloc &) {
    g_error = "out of memory";
  }
  return -1;
}

void jd_free(uint8_t *p) { std::free(p); }

const char *jd_error(void) { return g_error.c_str(); }

}  // extern "C"
