// JPEG decoder for the port's dataset readers (host code, no libjpeg). Its
// output is bit-equal to libjpeg-turbo 3.1's with the decoder defaults that
// PIL's `Image.open` uses: the integer ("islow") inverse DCT in the 16-bit
// arithmetic of its x86-64 SIMD code, fancy upsampling of subsampled
// chroma, block smoothing of progressive images, and the fixed-point
// colour conversions; and it refuses what PIL refuses.
//
// Reads 8-bit files of 1 component (grey), 3 (YCbCr: JFIF, Adobe
// transform other than 0, or unmarked; RGB: Adobe transform 0, or
// unmarked with component ids 'R', 'G', 'B') or 4 (CMYK; YCCK with an
// Adobe transform other than 0, converted as jdcolor.c's ycck_cmyk_convert),
// the 4 samples stored inverted as PIL's "CMYK;I" stores them. Codings:
// - sequential DCT (SOF0, SOF1) and progressive DCT (SOF2: the DC and AC
//   first and refine scans, end-of-band runs, successive approximation),
//   Huffman-coded as jdhuff.c / jdphuff.c decode them;
// - the same arithmetic-coded (SOF9, SOF10) as jdarith.c decodes them:
//   jaricom.c's probability table, the DC and AC statistics with DAC's
//   L / U / K conditioning, restart resets;
// - lossless (SOF3): the difference of each sample from predictor 1-7
//   (jdlhuff.c, jdpred.c), undone and scaled by the point transform.
// Progressive files whose scans leave coefficient 1-9 bits unsent have
// their blocks smoothed as jdcoefct.c's decompress_smooth_data does (the
// 5x5 DC neighbourhood; DC interpolation where no AC bit was sent).
// Any integral sampling factors from 1 to 4, interleaved or not, restart
// intervals (a lost restart marker resynchronised as
// jpeg_resync_to_restart does), any Huffman and quantisation tables, any
// size. Corrupt data are read as libjpeg reads them: a scan cut by a
// marker reads zeros from there and leaves the rest of its restart
// interval blank, a bad Huffman code reads as 0, a run past the band
// writes coefficient 63, bytes before a marker are skipped, a stray RSTn
// is ignored. Hierarchical files
// (SOF5-7, 13-15, DHP, EXP), lossless arithmetic (SOF11), 12- and 16-bit
// samples, 2 or more than 4 components, bad scan parameters, files cut
// short and unknown markers fail with a message naming the cause: PIL
// refuses each.
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

// the file ends where libjpeg would wait for more data
struct Truncated : Bad {
  using Bad::Bad;
};

[[noreturn]] void truncated(const std::string &why) { throw Truncated(why); }

std::string hex(int m) {
  char buf[8];
  std::snprintf(buf, sizeof buf, "0x%02X", m);
  return buf;
}

std::string sof_name(int m) {
  return "SOF" + std::to_string(m - 0xC0) + ", marker " + hex(m);
}

// zig-zag position -> natural (row-major) position in an 8x8 block; the
// 16 entries past 63 are 63, as in libjpeg's jpeg_natural_order, for the
// runs of corrupt data that pass the last coefficient
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jaricom.c's jpeg_aritab, ITU T.81 Table D.2: (Qe << 16) | (Next_Index_MPS
// << 8) | (Switch_MPS << 7) | Next_Index_LPS; entry 113 is the fixed
// probability 0.5 of T.851
#define V(i, qe, lps, mps, sw) \
  ((uint32_t(qe) << 16) | (uint32_t(mps) << 8) | (uint32_t(sw) << 7) | (lps))
const uint32_t kAriTab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),
    V(2, 0x1114, 16, 3, 0),      V(3, 0x080b, 18, 4, 0),
    V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),
    V(8, 0x0036, 30, 9, 0),      V(9, 0x001a, 33, 10, 0),
    V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),
    V(14, 0x5a7f, 15, 15, 1),    V(15, 0x3f25, 36, 16, 0),
    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),
    V(20, 0x0cef, 43, 21, 0),    V(21, 0x09a1, 45, 22, 0),
    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),
    V(26, 0x0240, 52, 27, 0),    V(27, 0x01b1, 54, 28, 0),
    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),
    V(32, 0x0068, 62, 33, 0),    V(33, 0x004e, 63, 34, 0),
    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),
    V(38, 0x3a0d, 65, 39, 0),    V(39, 0x2ef1, 67, 40, 0),
    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),
    V(44, 0x1177, 73, 45, 0),    V(45, 0x0e74, 74, 46, 0),
    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),
    V(50, 0x05cd, 48, 51, 0),    V(51, 0x04de, 50, 52, 0),
    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),
    V(56, 0x01f8, 54, 57, 0),    V(57, 0x01a4, 55, 58, 0),
    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),
    V(62, 0x00ab, 61, 63, 0),    V(63, 0x008f, 61, 32, 0),
    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),
    V(68, 0x2fe8, 83, 69, 0),    V(69, 0x293c, 84, 70, 0),
    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),
    V(74, 0x1424, 72, 75, 0),    V(75, 0x119c, 74, 76, 0),
    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),
    V(80, 0x5832, 80, 81, 1),    V(81, 0x4d1c, 88, 82, 0),
    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),
    V(86, 0x299a, 93, 87, 0),    V(87, 0x2516, 86, 71, 0),
    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),
    V(92, 0x3824, 99, 93, 0),    V(93, 0x32b4, 99, 94, 0),
    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),
    V(98, 0x41cf, 103, 99, 0),   V(99, 0x3c3d, 104, 100, 0),
    V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0),
    V(104, 0x415e, 103, 99, 0),  V(105, 0x5627, 105, 106, 1),
    V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0),
    V(110, 0x5a10, 110, 111, 1), V(111, 0x5522, 112, 109, 0),
    V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

// ITU T.81 Annex K.3's tables, which libjpeg-turbo's jstdhuff.c gives a
// sequential file whose table 0 or 1 no DHT segment defined: 16 code
// counts, then the symbols; DC luma, DC chroma, AC luma, AC chroma
const uint8_t kStdDcLuma[] = {
    0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdDcChroma[] = {
    0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b};
const uint8_t kStdAcLuma[] = {
    0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04,
    0x00, 0x00, 0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
    0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
    0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85,
    0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2,
    0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChroma[] = {
    0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04,
    0x00, 0x01, 0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
    0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9,
    0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huffman {
  bool defined = false;
  uint8_t counts[16];
  int n = 0;
  uint8_t vals[256];
  int maxcode[18];   // largest code of each length, -1 if none
  int valptr[17];    // index in vals of the first code of each length
  int mincode[17];
  // 9-bit lookahead: (length << 8) | symbol, 0 where the code is longer
  uint16_t look[512];

  // a DHT segment's table, kept as it came until a scan uses it
  void define(const uint8_t c[16], const uint8_t *symbols, int count) {
    std::memcpy(counts, c, sizeof counts);
    std::memcpy(vals, symbols, count);
    n = count;
    defined = true;
  }

  // jdhuff.c's jpeg_make_d_derived_tbl, at the start of each scan that
  // uses the table: the codes, the lookahead, the checks that the codes
  // fit and, for a DC (or lossless) table, that no symbol passes
  // `max_symbol`
  void derive(int max_symbol) {
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
    maxcode[17] = 0xFFFFF;   // the sentinel that ends a bad code
    for (int i = 0; max_symbol >= 0 && i < n; ++i)
      if (vals[i] > max_symbol)
        fail("bad Huffman table (DC symbol above " +
             std::to_string(max_symbol) + ")");
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;              // the current scan's table selectors
  int bw = 0, bh = 0;              // blocks a row / column, MCU-padded
  int dw = 0, dh = 0;              // downsampled width and height
  int wib = 0, hib = 0;            // blocks a row / column in the image
  bool seen = false;               // coded by some scan: its table latched
  uint16_t qt[64] = {};            // 0 until then (libjpeg's multipliers)
  int pt = 0;                      // lossless: the point transform
  // progressive: the lowest bit sent of each coefficient (-1: none), and
  // of coefficients 0-9 as they were before the latest scan that coded
  // any of them (jdphuff.c's second half of coef_bits)
  int coef_bits[64];
  int prev_bits[10];
  std::vector<int16_t> coef;       // bh * bw blocks of 64, natural order
  std::vector<uint16_t> smp;       // lossless: bh x bw samples
};

// The bytes of an entropy-coded segment as libjpeg's source manager and
// its `unread_marker` give them: 0xFF 0x00 is a data byte 0xFF, fill 0xFF
// bytes are skipped, and a marker stops the data (it stays unread, `pos`
// on its first 0xFF, its code in `marker`).
struct Source {
  const uint8_t *d;
  size_t n, pos;
  int marker = 0;
  size_t limit = SIZE_MAX;   // the end of the bytes PIL has given libjpeg

  // the byte at offset i, which must lie before `limit`
  int at(size_t i) const {
    if (i >= limit)
      fail("an arithmetic-coded scan whose data pass byte " +
           std::to_string(limit) + " of the file: PIL gives libjpeg the "
           "file 65536 bytes at a time, and its arithmetic decoder cannot "
           "wait for more (jdarith.c, JERR_CANT_SUSPEND), so PIL refuses "
           "the file");
    return d[i];
  }

  // the next data byte; -1 at a marker, -2 at the end of the file
  int byte() {
    if (marker) return -1;
    if (pos >= n) return -2;
    int c = at(pos);
    if (c != 0xFF) {
      ++pos;
      return c;
    }
    size_t q = pos + 1;
    while (q < n && at(q) == 0xFF) ++q;
    if (q >= n) return -2;
    if (d[q] == 0) {
      pos = q + 1;
      return 0xFF;
    }
    marker = d[q];
    return -1;
  }

  // jdmarker.c's next_marker: skip to the next marker (data bytes and
  // stuffed 0xFF 0x00 are discarded), leaving it unread
  void find_marker() {
    while (!marker) {
      if (byte() == -2) truncated("truncated file (no marker after the data)");
    }
  }

  // read the unread marker: the data resume after it
  void take_marker() {
    while (at(pos) == 0xFF) ++pos;
    at(pos++);
    marker = 0;
  }
};

// jdmarker.c's read_restart_marker and jpeg_resync_to_restart: past the
// expected RSTn the data resume; after a lost marker libjpeg skips to a
// later one, or stops at a marker it cannot pass (the interval's data are
// then empty). Returns whether the segment's data resume.
bool restart(Source &s, int *next_rst) {
  if (!s.marker) s.find_marker();
  const int desired = *next_rst;
  *next_rst = (*next_rst + 1) & 7;
  if (s.marker == 0xD0 + desired) {
    s.take_marker();
    return true;
  }
  for (;;) {
    const int m = s.marker;
    auto rst = [](int k) { return 0xD0 + (k & 7); };
    int action;
    if (m < 0xC0)
      action = 2;                          // not a valid marker: go on
    else if (m < 0xD0 || m > 0xD7)
      action = 3;                          // a marker that ends the scan
    else if (m == rst(desired + 1) || m == rst(desired + 2))
      action = 3;                          // one of the next two restarts
    else if (m == rst(desired - 1) || m == rst(desired - 2))
      action = 2;                          // an earlier one: go on
    else
      action = 1;                          // too far to tell: take it
    if (action == 3) return false;
    s.take_marker();
    if (action == 1) return true;
    s.find_marker();
  }
}

class BitReader {
 public:
  explicit BitReader(Source &s) : s_(s) {}

  // zero bits are fed once a marker or the end of the file is reached
  void fill() {
    while (cnt_ <= 56) {
      int b = s_.byte();
      if (b < 0) {
        eof_ = eof_ || b == -2;
        fake_ += 8;
        b = 0;
      }
      buf_ |= static_cast<uint64_t>(b) << (56 - cnt_);
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

  // jdhuff.c's HUFF_DECODE: a code longer than 16 bits (corrupt data)
  // decodes as 0 after 17 bits
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
      ++len;
    }
    if (len > 16) return 0;
    return t.vals[t.valptr[len] + code - t.mincode[len]];
  }

  // whether bits past the data were decoded: at a marker the scan's
  // data ran out (libjpeg's insufficient_data), at the file's end it is
  // truncated
  bool overrun() const {
    if (cnt_ < fake_ && eof_) truncated("truncated file (the scan's data end)");
    return cnt_ < fake_;
  }

  // drop the bits read ahead (libjpeg's process_restart)
  void reset() {
    buf_ = 0;
    cnt_ = 0;
    fake_ = 0;
    eof_ = false;
  }

 private:
  Source &s_;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  int fake_ = 0;       // zero bits appended past the data
  bool eof_ = false;
};

// jdarith.c's arith_decode on the bytes of `s`: zero data past a marker,
// and the end of the file fails (libjpeg cannot suspend here)
class Arith {
 public:
  explicit Arith(Source &s) : s_(s) {}

  void reset() {
    c_ = 0;
    a_ = 0;
    ct_ = -16;       // read 2 bytes first
  }

  int decode(uint8_t *st) {
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        int data = s_.byte();
        if (data == -2) truncated("truncated file (the scan's data end)");
        if (data < 0) data = 0;
        c_ = (c_ << 8) | data;
        if ((ct_ += 8) < 0)
          if (++ct_ == 0) a_ = 0x8000;   // 2 bytes read: A = 0x10000
      }
      a_ <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    int nl = qe & 0xFF;
    qe >>= 8;
    int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {           // the conditional exchange
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < int64_t(qe)) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  int ct_ = -16;      // -1 after a bad code: the rest of the interval is blank

 private:
  Source &s_;
  int64_t c_ = 0, a_ = 0;
};

// Pillow's ImageFile.MAXBLOCK: the bytes it reads for the decoder at a time
constexpr size_t kPilChunk = 65536;
// twice Pillow's Image.MAX_IMAGE_PIXELS: a larger image raises
// DecompressionBombError in Image.open
constexpr long kMaxPixels = 2L * 89478485;

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

class Decoder {
 public:
  Decoder(const uint8_t *d, size_t n) : d_(d), n_(n) {
    for (int i = 0; i < 16; ++i) {   // jdmarker.c's get_soi defaults
      dc_L_[i] = 0;
      dc_U_[i] = 1;
      ac_K_[i] = 5;
    }
  }

  std::vector<uint8_t> run(int dims[3]) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    try {
      read_markers();
    } catch (const Truncated &) {
      // a single-scan file is output as its scan is read: what follows
      // the scan may be cut short (jpeg_finish_decompress then waits in
      // vain, and PIL keeps the image)
      if (!single_scan_done_) throw;
    }
    if (comps_.empty()) fail("no frame header (SOF) before EOI");
    return output(dims);
  }

 private:
  void read_markers() {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) return;                                  // EOI
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          read_sof(m);
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
          fail("hierarchical (differential) frame (" + sof_name(m) +
               "); libjpeg, hence PIL, does not read it");
        case 0xCB:
          fail("lossless arithmetic coding (" + sof_name(m) +
               "); libjpeg, hence PIL, does not read it");
        case 0xDE: case 0xDF:
          fail(std::string("hierarchical file (") +
               (m == 0xDE ? "DHP" : "EXP") + ", marker " + hex(m) +
               "); PIL does not read it");
        case 0xC4: read_dht(); break;
        case 0xCC: read_dac(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: read_dri(); break;
        case 0xDA: read_sos(); break;
        case 0xE0: case 0xEE: read_app(m); break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
        case 0xD6: case 0xD7:
          break;                                   // a stray RSTn: ignored
        default:
          if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
            skip_segment();                        // APPn, COM, DNL
            break;
          }
          fail("unexpected marker " + hex(m) + " at byte " +
               std::to_string(pos_ - 2) + " (libjpeg, hence PIL, refuses "
               "it)");
      }
    }
  }

  const uint8_t *d_;
  size_t n_, pos_ = 0;
  int H_ = 0, W_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool progressive_ = false, arith_ = false, lossless_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int scans_ = 0;             // the scans read so far
  // the first scan coded every component of a sequential or lossless
  // file (libjpeg's has_multiple_scans false), and has been read
  bool single_scan_ = false, single_scan_done_ = false;
  int last_good_ = 0;         // the last iMCU row the last scan began whole
  uint16_t q_[4][64];
  bool q_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int dc_L_[16], dc_U_[16], ac_K_[16];
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  std::vector<Component> comps_;

  int byte() {
    if (pos_ >= n_) truncated("truncated file");
    return d_[pos_++];
  }

  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c's next_marker: bytes before the marker (the rest of a
  // corrupt scan, stuffed 0xFF 0x00 pairs) are skipped, as libjpeg and
  // PIL's header reader skip them
  int next_marker() {
    for (;;) {
      while (byte() != 0xFF) {
      }
      int m;
      do m = byte(); while (m == 0xFF);
      if (m != 0x00) return m;
    }
  }

  // the segment's payload: [start, end) after its 2-byte length; the
  // readers read it byte by byte, as libjpeg does, so a segment that
  // passes the file's end is cut short where they read past it
  size_t segment(size_t *end) {
    int len = word();
    if (len < 2) fail("bad segment length");
    *end = pos_ + len - 2;
    return pos_;
  }

  void skip_segment() {
    size_t end;
    segment(&end);
    if (end > n_) truncated("truncated segment");
    pos_ = end;
  }

  // jdmarker.c's examine_app0 / examine_app14: a JFIF segment of at least
  // 14 bytes, an Adobe one of at least 12
  void read_app(int m) {
    size_t end, p = segment(&end);
    size_t len = std::min(end, n_) - p;
    if (m == 0xE0 && len >= 14 && std::memcmp(d_ + p, "JFIF\0", 5) == 0)
      jfif_ = true;
    if (m == 0xEE && len >= 12 && std::memcmp(d_ + p, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = d_[p + 11];
    }
    if (end > n_) truncated("truncated segment");
    pos_ = end;
  }

  void read_sof(int m) {
    if (!comps_.empty()) fail("a second frame header (SOF)");
    progressive_ = m == 0xC2 || m == 0xCA;
    arith_ = m == 0xC9 || m == 0xCA;
    lossless_ = m == 0xC3;
    size_t end;
    segment(&end);
    int precision = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (" + sof_name(m) +
           "); PIL reads only 8-bit ones");
    H_ = word();
    W_ = word();
    if (H_ == 0) fail("height 0 (defined by a DNL marker) is not read");
    if (W_ == 0) fail("width 0");
    if (static_cast<long>(W_) * H_ > kMaxPixels)
      fail(std::to_string(W_) + "x" + std::to_string(H_) + " pixels, past "
           "PIL's decompression-bomb limit of " + std::to_string(kMaxPixels));
    int nc = byte();
    if (nc != 1 && nc != 3 && nc != 4)
      fail(std::to_string(nc) + " components; PIL reads 1 (grey), 3 "
           "(YCbCr / RGB) and 4 (CMYK / YCCK)");
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
    // a block is 8x8 samples, or one sample in a lossless file
    const int bs = lossless_ ? 1 : 8;
    mcux_ = (W_ + bs * hmax_ - 1) / (bs * hmax_);
    mcuy_ = (H_ + bs * vmax_ - 1) / (bs * vmax_);
    for (auto &c : comps_) {
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.dw = static_cast<int>((static_cast<long>(W_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<long>(H_) * c.v + vmax_ - 1) / vmax_);
      c.wib = (c.dw + bs - 1) / bs;
      c.hib = (c.dh + bs - 1) / bs;
      if (lossless_)
        c.smp.assign(static_cast<size_t>(c.bw) * c.bh, 0);
      else
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 10, -1);
    }
  }

  // jdmarker.c's get_dht: each table read as it comes, checked against
  // the segment's length; its codes are checked when a scan uses it
  void read_dht() {
    size_t end;
    segment(&end);
    long left = static_cast<long>(end - pos_);
    while (left > 16) {
      int index = byte();
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = byte();
      left -= 17;
      if (total > 256 || total > left) fail("bad Huffman table");
      uint8_t symbols[256];
      for (int i = 0; i < total; ++i) symbols[i] = byte();
      left -= total;
      const bool ac = index & 0x10;
      if (ac) index -= 0x10;
      if (index > 3) fail("bad Huffman table class or id");
      (ac ? ac_ : dc_)[index].define(counts, symbols, total);
    }
    if (left != 0) fail("bad DHT length");
  }

  // the Huffman table a scan uses, derived for it
  void use_table(bool ac, int index, int max_symbol) {
    if (index > 3) fail("bad Huffman table selector");
    Huffman &t = (ac ? ac_ : dc_)[index];
    if (!t.defined) fail("a scan uses an undefined Huffman table");
    t.derive(max_symbol);
  }

  // jdhuff.c's jinit_huff_decoder (std_huff_tables): a sequential Huffman
  // file's DC and AC tables 0 and 1 that no DHT segment defined before
  // its first scan are the standard ones (Motion-JPEG frames omit them)
  void default_tables() {
    for (int ac = 0; ac < 2; ++ac)
      for (int index = 0; index < 2; ++index) {
        Huffman &t = (ac ? ac_ : dc_)[index];
        if (t.defined) continue;
        const uint8_t *spec = ac ? (index ? kStdAcChroma : kStdAcLuma)
                                 : (index ? kStdDcChroma : kStdDcLuma);
        int n = 0;
        for (int i = 0; i < 16; ++i) n += spec[i];
        t.define(spec, spec + 16, n);
      }
  }

  // jdmarker.c's get_dac: each DC table's L and U, each AC table's K
  void read_dac() {
    size_t end;
    segment(&end);
    while (pos_ < end) {
      int index = byte(), val = byte();
      if (index >= 32) fail("bad arithmetic conditioning table index");
      if (index >= 16) {
        ac_K_[index - 16] = val;
      } else {
        dc_L_[index] = val & 15;
        dc_U_[index] = val >> 4;
        if (dc_L_[index] > dc_U_[index])
          fail("bad arithmetic DC conditioning (L above U)");
      }
    }
    if (pos_ != end) fail("bad DAC length");
  }

  // jdmarker.c's get_dqt: each table's precision (any nonzero is 16-bit)
  // and id read first; a table cut short by the segment is not read
  void read_dqt() {
    size_t end;
    segment(&end);
    while (pos_ < end) {
      int pq_tq = byte();
      int wide = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad quantisation table id");
      if (end - pos_ < (wide ? 128u : 64u))
        fail("a quantisation table cut short by its segment");
      for (int i = 0; i < 64; ++i)
        q_[tq][kNatural[i]] = static_cast<uint16_t>(wide ? word() : byte());
      q_defined_[tq] = true;
    }
    if (pos_ != end) fail("bad DQT length");
  }

  void read_dri() {
    size_t end;
    segment(&end);
    if (end != pos_ + 2) fail("bad DRI length");
    restart_ = word();
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
      sc.push_back(c);
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (pos_ != end) fail("bad SOS length");
    if (single_scan_)
      fail("a second scan in a file whose first scan coded every "
           "component (libjpeg expects EOI there)");
    single_scan_ = !progressive_ && ns == static_cast<int>(comps_.size());
    if (++scans_ == 1 && !progressive_ && !arith_ && !lossless_)
      default_tables();
    int blocks_per_mcu = 0;
    for (auto *c : sc) blocks_per_mcu += ns == 1 ? 1 : c->h * c->v;
    if (blocks_per_mcu > 10) fail("more than 10 blocks in an MCU");
    if (lossless_) {
      // jdlossls.c: the predictor (Ss) 1-7, Pt (Al) below the precision
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7)
        fail("bad lossless scan parameters (predictor " +
             std::to_string(ss) + ", Se " + std::to_string(se) + ", Ah " +
             std::to_string(ah) + ", Pt " + std::to_string(al) + ")");
      for (auto *c : sc) {
        use_table(false, c->td, 16);
        c->seen = true;
      }
      lossless_scan(sc, ss, al);
      return;
    }
    // a sequential scan's Ss, Se, Ah and Al are not checked (jdhuff.c
    // warns); a progressive one's as jdphuff.c / jdarith.c check them
    if (progressive_ &&
        (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
         al > 13 || (ah && ah != al + 1)))
      fail("bad progressive scan parameters (Ss " + std::to_string(ss) +
           ", Se " + std::to_string(se) + ", Ah " + std::to_string(ah) +
           ", Al " + std::to_string(al) + ")");
    const bool dc_scan = ss == 0, first = ah == 0;
    for (auto *c : sc) {
      if (!arith_) {
        if (!progressive_ || (dc_scan && first)) use_table(false, c->td, 15);
        if (!progressive_ || !dc_scan) use_table(true, c->ta, -1);
      }
      if (!c->seen) {
        if (!q_defined_[c->tq]) fail("a component's quantisation table is "
                                     "undefined");
        std::memcpy(c->qt, q_[c->tq], sizeof c->qt);
      }
      c->seen = true;
      if (progressive_) {
        for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
          if (k < 10) c->prev_bits[k] = scans_ > 1 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      }
    }
    if (arith_)
      arith_scan(sc, ss, se, ah, al);
    else
      huffman_scan(sc, ss, se, ah, al);
  }

  // the blocks of MCU `mcu` of a scan of the components `sc`, each with
  // the index of its component in the scan
  void mcu_blocks(const std::vector<Component *> &sc, long mcu, int nx,
                  std::vector<std::pair<int, int16_t *>> *out) const {
    out->clear();
    const bool single = sc.size() == 1;
    int mx = static_cast<int>(mcu % nx), my = static_cast<int>(mcu / nx);
    for (size_t k = 0; k < sc.size(); ++k) {
      Component &c = *sc[k];
      int h = single ? 1 : c.h, v = single ? 1 : c.v;
      for (int by = 0; by < v; ++by)
        for (int bx = 0; bx < h; ++bx) {
          int row = my * v + by, col = mx * h + bx;
          out->push_back({static_cast<int>(k),
                          &c.coef[(static_cast<size_t>(row) * c.bw + col) * 64]});
        }
    }
  }

  // the MCUs of a scan: a single-component scan codes the component's own
  // blocks, one an MCU; an interleaved one whole MCUs of h x v blocks per
  // component. Returns (MCUs a row, MCU rows)
  std::pair<int, int> mcu_grid(const std::vector<Component *> &sc) const {
    if (sc.size() == 1) return {sc[0]->wib, sc[0]->hib};
    return {mcux_, mcuy_};
  }

  // the iMCU row of MCU row `my` of the scan
  int imcu_row(const std::vector<Component *> &sc, int my) const {
    return sc.size() == 1 ? my / sc[0]->v : my;
  }

  // the scan ends at the next marker, after any stray bytes; a single-
  // scan file's image is whole once that marker is found
  void end_scan(Source &src) {
    src.find_marker();
    pos_ = src.pos;
    single_scan_done_ = single_scan_;
  }

  // one scan's blocks, Huffman-coded: a sequential scan codes each block
  // whole, a progressive one the band [ss, se] of it at bit al (refining
  // bit al of what earlier scans sent where ah > 0). After the data run
  // out at a marker, the MCUs left in the restart interval are skipped.
  void huffman_scan(const std::vector<Component *> &sc, int ss, int se,
                    int ah, int al) {
    auto [nx, ny] = mcu_grid(sc);
    const long total = static_cast<long>(nx) * ny;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    Source src{d_, n_, pos_};
    BitReader br(src);
    int next_rst = 0;
    bool insufficient = false;
    std::vector<std::pair<int, int16_t *>> blocks;
    for (long mcu = 0; mcu < total; ++mcu) {
      if (restart_ && mcu && mcu % restart_ == 0) {
        br.reset();
        restart(src, &next_rst);
        std::memset(pred, 0, sizeof pred);
        eobrun = 0;
        // the flag stays as it was where a marker waits unread: the next
        // MCU then reads zeros (jdhuff.c's process_restart)
        if (!src.marker) insufficient = false;
      }
      if (insufficient) continue;
      last_good_ = imcu_row(sc, static_cast<int>(mcu / nx));
      mcu_blocks(sc, mcu, nx, &blocks);
      for (auto &[k, blk] : blocks) {
        Component &c = *sc[k];
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
      insufficient = br.overrun();
    }
    br.reset();
    end_scan(src);
  }

  void decode_block(BitReader &br, const Huffman &dc, const Huffman &ac,
                    int *pred, int16_t *blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = br.decode(dc);
    int diff = s ? extend(br.bits(s), s) : 0;
    *pred = static_cast<int>(static_cast<unsigned>(*pred) + diff);
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else if (r == 15) {
        k += 15;
      } else {
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_DC_first: the DC difference, scaled by 2^al
  void dc_first(BitReader &br, const Huffman &dc, int *pred, int16_t *blk,
                int al) {
    int s = br.decode(dc);
    *pred = static_cast<int>(static_cast<unsigned>(*pred) +
                             (s ? extend(br.bits(s), s) : 0));
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
          s = br.bit() ? p1 : m1;   // a size other than 1 is read as 1
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
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
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

  // jdarith.c's DC difference decoding into `*last` (16 bits), its
  // conditioning context in `*ctx`; false after a magnitude overflow
  bool arith_dc(Arith &ar, int tbl, int *last, int *ctx) {
    uint8_t *st = dc_stats_[tbl] + *ctx;
    if (ar.decode(st) == 0) {
      *ctx = 0;
      return true;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = dc_stats_[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < ((1 << dc_L_[tbl]) >> 1))
      *ctx = 0;                      // zero difference category
    else if (m > ((1 << dc_U_[tbl]) >> 1))
      *ctx = 12 + sign * 4;          // large
    else
      *ctx = 4 + sign * 4;           // small
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    *last = (*last + v) & 0xFFFF;
    return true;
  }

  // jdarith.c's nonzero AC value at position k, its statistics from `st`
  // (the position's EOB bin); 0 after a magnitude overflow
  int arith_ac(Arith &ar, int tbl, int k, uint8_t *st) {
    uint8_t fixed = 113;
    int sign = ar.decode(&fixed);
    st += 2;
    int m = ar.decode(st);
    if (m && ar.decode(st)) {
      m <<= 1;
      st = ac_stats_[tbl] + (k <= ac_K_[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return 0;
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // one scan's blocks, arithmetic-coded (jdarith.c's decode_mcu and the
  // four progressive decoders). A bad code leaves the rest of its restart
  // interval as it is (a sequential block there all zero).
  void arith_scan(const std::vector<Component *> &sc, int ss, int se,
                  int ah, int al) {
    auto [nx, ny] = mcu_grid(sc);
    const long total = static_cast<long>(nx) * ny;
    int last[4] = {0, 0, 0, 0}, ctx[4] = {0, 0, 0, 0};
    Source src{d_, n_, pos_};
    // Pillow's ImageFile.load feeds the decoder 65536 bytes a read; the
    // reads so far end at the first multiple past the scan header
    src.limit = (pos_ - 1) / kPilChunk * kPilChunk + kPilChunk;
    Arith ar(src);
    auto reset = [&]() {
      for (size_t k = 0; k < sc.size(); ++k) {
        if (!progressive_ || (ss == 0 && ah == 0)) {
          std::memset(dc_stats_[sc[k]->td], 0, 64);
          last[k] = ctx[k] = 0;
        }
        if (!progressive_ || ss) std::memset(ac_stats_[sc[k]->ta], 0, 256);
      }
      ar.reset();
    };
    reset();
    int next_rst = 0;
    std::vector<std::pair<int, int16_t *>> blocks;
    const int p1 = 1 << al, m1 = -p1;
    for (long mcu = 0; mcu < total; ++mcu) {
      if (restart_ && mcu && mcu % restart_ == 0) {
        restart(src, &next_rst);
        reset();
      }
      last_good_ = imcu_row(sc, static_cast<int>(mcu / nx));
      mcu_blocks(sc, mcu, nx, &blocks);
      if (!progressive_)
        for (auto &kb : blocks) std::memset(kb.second, 0, 64 * sizeof(int16_t));
      if (ar.ct_ == -1) continue;
      for (auto &[k, blk] : blocks) {
        Component &c = *sc[k];
        bool ok = true;
        if (!progressive_) {
          ok = arith_dc(ar, c.td, &last[k], &ctx[k]);
          if (!ok) break;
          blk[0] = static_cast<int16_t>(last[k]);
          for (int kk = 0; kk < 63;) {
            uint8_t *st = ac_stats_[c.ta] + 3 * kk;
            if (ar.decode(st)) break;                    // end of block
            for (;;) {
              ++kk;
              if (ar.decode(st + 1)) break;
              st += 3;
              if (kk >= 63) {
                ok = false;
                break;
              }
            }
            if (!ok) break;
            int v = arith_ac(ar, c.ta, kk, st);
            if (!v) {
              ok = false;
              break;
            }
            blk[kNatural[kk]] = static_cast<int16_t>(v);
          }
        } else if (ss == 0 && ah == 0) {
          ok = arith_dc(ar, c.td, &last[k], &ctx[k]);
          if (ok)
            blk[0] = static_cast<int16_t>(static_cast<unsigned>(last[k]) << al);
        } else if (ss == 0) {
          uint8_t fixed = 113;
          if (ar.decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] | p1);
        } else if (ah == 0) {
          for (int kk = ss; kk <= se; ++kk) {
            uint8_t *st = ac_stats_[c.ta] + 3 * (kk - 1);
            if (ar.decode(st)) break;                    // end of band
            while (ar.decode(st + 1) == 0) {
              st += 3;
              if (++kk > se) {
                ok = false;
                break;
              }
            }
            if (!ok) break;
            int v = arith_ac(ar, c.ta, kk, st);
            if (!v) {
              ok = false;
              break;
            }
            blk[kNatural[kk]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
          }
        } else {
          int kex = se;                // the previous stage's end of band
          for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
          uint8_t fixed = 113;
          for (int kk = ss; kk <= se && ok; ++kk) {
            uint8_t *st = ac_stats_[c.ta] + 3 * (kk - 1);
            if (kk > kex && ar.decode(st)) break;        // end of band
            for (;;) {
              int16_t &co = blk[kNatural[kk]];
              if (co) {                                  // a correction bit
                if (ar.decode(st + 2))
                  co = static_cast<int16_t>(co + (co < 0 ? m1 : p1));
                break;
              }
              if (ar.decode(st + 1)) {                   // newly nonzero
                co = static_cast<int16_t>(ar.decode(&fixed) ? m1 : p1);
                break;
              }
              st += 3;
              if (++kk > se) {
                ok = false;
                break;
              }
            }
          }
        }
        if (!ok) {
          ar.ct_ = -1;
          break;
        }
      }
    }
    src.limit = SIZE_MAX;      // the markers after the scan can wait
    end_scan(src);
  }

  // jdlhuff.c, jddiffct.c and jdpred.c: each sample's difference from its
  // predictor, undone row by row: the first row of the scan and of each
  // restart interval predicts from 2^(7 - Pt) and then the sample to the
  // left, the first column of the other rows from the sample above, the
  // rest by predictor `psv` of the left (a), upper (b) and upper-left (c)
  // samples. The samples of an interleaved MCU past the component's edge
  // are read and dropped.
  void lossless_scan(const std::vector<Component *> &sc, int psv, int pt) {
    auto [nx, ny] = mcu_grid(sc);
    if (restart_ % nx)
      fail("a lossless restart interval of " + std::to_string(restart_) +
           " MCUs, not a multiple of the " + std::to_string(nx) +
           " MCUs of a row (libjpeg refuses it)");
    const bool single = sc.size() == 1;
    std::vector<std::vector<int>> diff(sc.size());
    std::vector<bool> first(sc.size(), true);
    Source src{d_, n_, pos_};
    BitReader br(src);
    int next_rst = 0;
    bool insufficient = false;
    for (int my = 0; my < ny; ++my) {
      if (restart_ && my && (static_cast<long>(my) * nx) % restart_ == 0) {
        br.reset();
        restart(src, &next_rst);
        if (!src.marker) insufficient = false;
        std::fill(first.begin(), first.end(), true);
      }
      for (size_t k = 0; k < sc.size(); ++k) {
        int h = single ? 1 : sc[k]->h, v = single ? 1 : sc[k]->v;
        diff[k].assign(static_cast<size_t>(v) * nx * h, 0);
      }
      // jdlhuff.c's decode_mcus: once the data ran out, a row's
      // differences are 0 and the predictors restart (its samples grey)
      if (insufficient) std::fill(first.begin(), first.end(), true);
      for (int mx = 0; mx < nx && !insufficient; ++mx) {
        for (size_t k = 0; k < sc.size(); ++k) {
          const Huffman &t = dc_[sc[k]->td];
          int h = single ? 1 : sc[k]->h, v = single ? 1 : sc[k]->v;
          for (int by = 0; by < v; ++by)
            for (int bx = 0; bx < h; ++bx) {
              int s = br.decode(t);
              int dv = s == 0 ? 0 : s == 16 ? 32768 : extend(br.bits(s), s);
              diff[k][static_cast<size_t>(by) * nx * h + mx * h + bx] = dv;
            }
        }
      }
      insufficient = insufficient || br.overrun();
      for (size_t k = 0; k < sc.size(); ++k) {
        Component &c = *sc[k];
        int h = single ? 1 : c.h, v = single ? 1 : c.v;
        for (int by = 0; by < v; ++by) {
          int y = my * v + by;
          if (y >= c.dh) break;
          const int *df = &diff[k][static_cast<size_t>(by) * nx * h];
          uint16_t *out = &c.smp[static_cast<size_t>(y) * c.bw];
          const uint16_t *up = y ? out - c.bw : nullptr;
          if (first[k]) {
            int ra = (df[0] + (1 << (7 - pt))) & 0xFFFF;
            out[0] = static_cast<uint16_t>(ra);
            for (int x = 1; x < c.dw; ++x) {
              ra = (df[x] + ra) & 0xFFFF;
              out[x] = static_cast<uint16_t>(ra);
            }
            first[k] = false;
            continue;
          }
          int rb = up[0], ra = (df[0] + rb) & 0xFFFF, rc;
          out[0] = static_cast<uint16_t>(ra);
          for (int x = 1; x < c.dw; ++x) {
            rc = rb;
            rb = up[x];
            int64_t p;
            switch (psv) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = int64_t(ra) + rb - rc; break;
              case 5: p = ra + ((int64_t(rb) - rc) >> 1); break;
              case 6: p = rb + ((int64_t(ra) - rc) >> 1); break;
              default: p = (int64_t(ra) + rb) >> 1; break;
            }
            ra = static_cast<int>((df[x] + p) & 0xFFFF);
            out[x] = static_cast<uint16_t>(ra);
          }
        }
      }
    }
    for (auto *c : sc) c->pt = pt;
    br.reset();
    end_scan(src);
  }

  // libjpeg-turbo's SIMD islow inverse DCT (jidctint-sse2.asm /
  // jidctint-avx2.asm, which PIL's libjpeg-turbo runs on x86-64), in its
  // own arithmetic: jidctint.c's algorithm (CONST_BITS 13, PASS1_BITS 2)
  // with each dequantised coefficient the low 16 bits of its product
  // (pmullw), the sums fed to the multipliers 16-bit (paddw, psubw), the
  // products and the rest 32-bit (pmaddwd), each pass's results saturated
  // to 16 bits (packssdw) and the last to 8 bits around 128 (packsswb). A
  // block whose rows 1-7 are all zero takes each column's DC << 2 in 16
  // bits (psllw). On a valid file it equals the C version's result; on
  // corrupt coefficients the saturations and wraps are PIL's.
  static inline int16_t w16(int64_t x) { return static_cast<int16_t>(x); }
  static inline int16_t sat16(int64_t x) {
    return static_cast<int16_t>(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
  }

  // one 8-point pass over v[0..7] (16-bit), descaled by `shift` bits
  static void idct_pass(const int16_t *v, int shift, int32_t *o) {
    const int32_t z2 = v[2], z3 = v[6];
    const int32_t tmp3 = z2 * 10703 + z3 * 4433;
    const int32_t tmp2 = z2 * 4433 + z3 * -10704;
    const int32_t tmp0 = int32_t(w16(v[0] + v[4])) * 8192;
    const int32_t tmp1 = int32_t(w16(v[0] - v[4])) * 8192;
    const int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int32_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    const int32_t a0 = v[7], a1 = v[5], a2 = v[3], a3 = v[1];
    const int32_t s3 = w16(a0 + a2), s4 = w16(a1 + a3);
    const int32_t z3o = s3 * -6436 + s4 * 9633;
    const int32_t z4o = s3 * 9633 + s4 * 6437;
    const int32_t b0 = a0 * -4927 + a3 * -7373 + z3o;
    const int32_t b3 = a0 * -7373 + a3 * 4926 + z4o;
    const int32_t b1 = a1 * -4176 + a2 * -20995 + z4o;
    const int32_t b2 = a1 * -20995 + a2 * 4177 + z3o;
    const int32_t round = int32_t(1) << (shift - 1);
    o[0] = (t10 + b3 + round) >> shift;
    o[7] = (t10 - b3 + round) >> shift;
    o[1] = (t11 + b2 + round) >> shift;
    o[6] = (t11 - b2 + round) >> shift;
    o[2] = (t12 + b1 + round) >> shift;
    o[5] = (t12 - b1 + round) >> shift;
    o[3] = (t13 + b0 + round) >> shift;
    o[4] = (t13 - b0 + round) >> shift;
  }

  static void idct(const int16_t *in, const uint16_t *qt, uint8_t *out,
                   int stride) {
    int16_t ws[64];
    bool rows_zero = true;
    for (int i = 8; i < 64 && rows_zero; ++i) rows_zero = in[i] == 0;
    if (rows_zero) {
      for (int c = 0; c < 8; ++c) {
        int16_t dc = w16(w16(int32_t(in[c]) * int16_t(qt[c])) * 4);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      }
    } else {
      for (int c = 0; c < 8; ++c) {
        int16_t col[8];
        int32_t o[8];
        for (int r = 0; r < 8; ++r)
          col[r] = w16(int32_t(in[r * 8 + c]) * int16_t(qt[r * 8 + c]));
        idct_pass(col, 11, o);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(o[r]);
      }
    }
    for (int r = 0; r < 8; ++r) {
      int32_t o[8];
      idct_pass(ws + r * 8, 18, o);
      uint8_t *row = out + r * stride;
      for (int c = 0; c < 8; ++c) {
        int v = sat16(o[c]);
        v = v < -128 ? -128 : v > 127 ? 127 : v;
        row[c] = static_cast<uint8_t>(v + 128);
      }
    }
  }

  // jdcoefct.c's smoothing_ok, in libjpeg-turbo 3.1's form: a progressive
  // image whose every component has its table, nonzero quantisers at DC
  // and coefficients 1-9 and some DC bits, and whose scans left bits of
  // coefficients 1-9 unsent somewhere
  bool smoothing_ok() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const auto &c : comps_) {
      if (!c.seen) return false;
      for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.qt[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data for block (row, col) of `c`, into
  // `ws`: coefficients 1-9 that are zero and not known exactly estimated
  // from the DC values of the 5x5 blocks around it; where no AC bit was
  // sent at all, the DC too, from a Gaussian-like kernel. `bits` are the
  // coefficient bits latched for the block's iMCU row; (pp, p, n, nn) the
  // block rows above and below it as libjpeg picks them.
  void smooth_block(const Component &c, const int *bits, int row, int pp,
                    int p, int nx, int nn, int col, int16_t *ws) const {
    const int last = c.wib - 1;
    auto dc = [&](int r, int x) -> int {
      x = x < 0 ? 0 : x > last ? last : x;
      return c.coef[(static_cast<size_t>(r) * c.bw + x) * 64];
    };
    int D[26];
    const int rows[5] = {pp, p, row, nx, nn};
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 5; ++j) D[1 + 5 * i + j] = dc(rows[i], col - 2 + j);
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    const int64_t Q00 = c.qt[0], Q01 = c.qt[1], Q10 = c.qt[8],
                  Q20 = c.qt[16], Q11 = c.qt[9], Q02 = c.qt[2],
                  Q03 = c.qt[3], Q12 = c.qt[10], Q21 = c.qt[17],
                  Q30 = c.qt[24];
    auto estimate = [&](int k, int pos, int64_t q, int64_t num) {
      int al = bits[k];
      if (al == 0 || ws[pos] != 0) return;
      num *= Q00;
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = static_cast<int>(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      ws[pos] = static_cast<int16_t>(pred);
    };
    const int *d = D;
    if (change_dc) {
      estimate(1, 1, Q01,
               -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] -
                   13 * d[9] + 3 * d[10] - 3 * d[11] + 38 * d[12] -
                   38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] -
                   13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] + d[25]);
      estimate(2, 8, Q10,
               -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] +
                   13 * d[7] + 38 * d[8] + 13 * d[9] - d[10] + d[16] -
                   13 * d[17] - 38 * d[18] - 13 * d[19] + d[20] + d[21] +
                   3 * d[22] + 3 * d[23] + 3 * d[24] + d[25]);
      estimate(3, 16, Q20,
               d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] -
                   14 * d[13] - 5 * d[14] + 2 * d[17] + 7 * d[18] +
                   2 * d[19] + d[23]);
      estimate(4, 9, Q11,
               -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] +
                   d[21] - d[25]);
      estimate(5, 2, Q02,
               2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] -
                   14 * d[13] + 7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] +
                   2 * d[19]);
      estimate(6, 3, Q03,
               d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
      estimate(7, 10, Q12,
               d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
      estimate(8, 17, Q21,
               d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
      estimate(9, 24, Q30,
               d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
      int64_t num = Q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] -
                           2 * d[5] - 6 * d[6] + 6 * d[7] + 42 * d[8] +
                           6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] +
                           152 * d[13] + 42 * d[14] - 8 * d[15] - 6 * d[16] +
                           6 * d[17] + 42 * d[18] + 6 * d[19] - 6 * d[20] -
                           2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] -
                           2 * d[25]);
      int pred = num >= 0
                     ? static_cast<int>(((Q00 << 7) + num) / (Q00 << 8))
                     : -static_cast<int>(((Q00 << 7) - num) / (Q00 << 8));
      ws[0] = static_cast<int16_t>(pred);
    } else {
      estimate(1, 1, Q01, -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]);
      estimate(2, 8, Q10, -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]);
      estimate(3, 16, Q20,
               -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]);
      estimate(4, 9, Q11,
               d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] +
                   d[22] - d[24] + d[4] - d[6] + 10 * d[7] - 10 * d[9]);
      estimate(5, 2, Q02,
               -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]);
    }
  }

  // a component's samples, (bh * 8) x (bw * 8), row stride bw * 8; with
  // `smooth`, each block smoothed first (smooth_block), its neighbour rows
  // and its coefficient bits chosen per iMCU row as decompress_smooth_data
  // chooses them
  std::vector<uint8_t> samples(const Component &c, bool smooth) const {
    int stride = c.bw * 8;
    std::vector<uint8_t> s(static_cast<size_t>(stride) * c.bh * 8);
    const int total = mcuy_;
    int16_t ws[64];
    for (int im = 0; im < total; ++im) {
      const bool last = im == total - 1;
      const int brows = last ? (c.hib % c.v ? c.hib % c.v : c.v) : c.v;
      const int ibrows = brows * total;
      const int *bits = im > last_good_ ? c.prev_bits : c.coef_bits;
      int bits_latched[10];
      for (int k = 0; k < 10; ++k)
        bits_latched[k] = im > last_good_ && scans_ <= 1 ? -1 : bits[k];
      for (int br = 0; br < brows; ++br) {
        const int ib = im * brows + br, row = im * c.v + br;
        const int p = ib > 0 ? row - 1 : row;
        const int pp = ib > 1 ? row - 2 : p;
        const int nx = ib < ibrows - 1 ? row + 1 : row;
        const int nn = ib < ibrows - 2 ? row + 2 : nx;
        for (int bx = 0; bx < c.wib; ++bx) {
          const int16_t *blk = &c.coef[(static_cast<size_t>(row) * c.bw + bx) * 64];
          if (smooth) {
            std::memcpy(ws, blk, sizeof ws);
            smooth_block(c, bits_latched, row, pp, p, nx, nn, bx, ws);
            blk = ws;
          }
          idct(blk, c.qt, &s[static_cast<size_t>(row) * 8 * stride + bx * 8],
               stride);
        }
      }
    }
    return s;
  }

  // a lossless component's samples, bh x bw: each shifted left by its
  // point transform, as an 8-bit sample
  std::vector<uint8_t> lossless_samples(const Component &c) const {
    std::vector<uint8_t> s(c.smp.size());
    for (size_t i = 0; i < s.size(); ++i)
      s[i] = static_cast<uint8_t>(c.smp[i] << c.pt);
    return s;
  }

  // the component at full size, W_ x H_, from its samples `s` of row
  // stride `stride`, as jdsample.c upsamples it; with `fancy`
  // (do_fancy_upsampling) rows past dh repeat row dh - 1, row -1 repeats
  // row 0 (jdmainct.c's context pointers)
  std::vector<uint8_t> upsample(const Component &c,
                                const std::vector<uint8_t> &s, int stride,
                                bool fancy) const {
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const int W = W_, H = H_, dw = c.dw, dh = c.dh;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto in = [&](int y) { return &s[static_cast<size_t>(y) * stride]; };
    auto clampy = [&](int y) { return y < 0 ? 0 : y >= dh ? dh - 1 : y; };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[size_t(y) * W], in(y), W);
    } else if (fancy && rh == 2 && rv == 1 && dw > 2) {            // h2v1_fancy
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
    } else if (fancy && rh == 1 && rv == 2) {                      // h1v2_fancy
      for (int y = 0; y < H; ++y) {
        int iy = y >> 1;
        const uint8_t *p0 = in(iy);
        const uint8_t *p1 = in(clampy(y & 1 ? iy + 1 : iy - 1));
        int bias = y & 1 ? 2 : 1;
        uint8_t *o = &out[size_t(y) * W];
        for (int x = 0; x < W; ++x)
          o[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
      }
    } else if (fancy && rh == 2 && rv == 2 && dw > 2) {            // h2v2_fancy
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

  // the colour space as jdapimin.c's default_decompress_parms guesses it:
  // 3 components are YCbCr in a JFIF file, RGB in an Adobe one of
  // transform 0, YCbCr in other Adobe ones, and in an unmarked one RGB
  // with the component ids 'R', 'G', 'B', else YCbCr; 4 are YCCK in an
  // Adobe file of transform other than 0, else CMYK
  bool needs_conversion() const {
    if (comps_.size() == 4) return adobe_ && adobe_transform_ != 0;
    if (comps_.size() != 3 || jfif_) return comps_.size() == 3;
    if (adobe_) return adobe_transform_ != 0;
    return !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);
  }

  std::vector<uint8_t> output(int dims[3]) {
    const size_t npix = static_cast<size_t>(W_) * H_;
    dims[0] = H_;
    dims[1] = W_;
    const int nc = static_cast<int>(comps_.size());
    const bool convert = needs_conversion();
    if (lossless_ && convert)
      fail(std::string("a lossless file whose colour needs converting (") +
           (nc == 4 ? "YCCK to CMYK" : "YCbCr to RGB") +
           "); libjpeg, hence PIL, refuses it");
    // the components at full size; a lossless file's blocks are single
    // samples (min_DCT_scaled_size 1), so it is upsampled plainly
    const bool smooth = smoothing_ok();
    std::vector<uint8_t> p[4];
    for (int k = 0; k < nc; ++k) {
      const Component &c = comps_[k];
      if (lossless_ && !c.seen)
        fail("a component was never coded by a scan");
      p[k] = lossless_ ? upsample(c, lossless_samples(c), c.bw, false)
                       : upsample(c, samples(c, smooth), c.bw * 8, true);
    }
    dims[2] = nc;
    std::vector<uint8_t> out(npix * nc);
    if (nc == 1) return p[0];
    if (convert) ycc_convert(p, nc == 4);
    if (nc == 4) {          // PIL's "CMYK;I" stores each sample inverted
      for (size_t i = 0; i < npix; ++i)
        for (int k = 0; k < 4; ++k)
          out[4 * i + k] = static_cast<uint8_t>(255 - p[k][i]);
      return out;
    }
    for (size_t i = 0; i < npix; ++i)
      for (int k = 0; k < 3; ++k) out[3 * i + k] = p[k][i];
    return out;
  }

  // jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16) on the planes p[0-2] in
  // place; with `ycck`, ycck_cmyk_convert: each result subtracted from 255
  // before its range limit (the fourth plane passes through)
  void ycc_convert(std::vector<uint8_t> *p, bool ycck) const {
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
    const int flip = ycck ? 255 : 0, sign = ycck ? -1 : 1;
    const size_t npix = static_cast<size_t>(W_) * H_;
    for (size_t i = 0; i < npix; ++i) {
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
      p[0][i] = clamp(flip + sign * (y + cr_r[cr]));
      p[1][i] = clamp(flip + sign * (y + static_cast<int>(
                                             (cb_g[cb] + cr_g[cr]) >> SB)));
      p[2][i] = clamp(flip + sign * (y + cb_b[cb]));
    }
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
