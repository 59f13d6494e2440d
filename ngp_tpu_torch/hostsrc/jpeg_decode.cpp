// jpeg_decode — the JPEG reader of ngp_tpu_torch, built into the same
// library as ngp_host.cpp.
//
// It gives, bit for bit, what libjpeg-turbo's default decode gives (the
// library behind PIL's JPEG plugin): Huffman-coded baseline, extended
// sequential and progressive frames of 8-bit samples, one component
// (grey) or three (YCbCr, or RGB where an Adobe APP14 marker says
// transform 0 or the component ids spell "RGB" with no JFIF marker).
// Three public integer algorithms make that output:
//   - the "islow" integer IDCT of libjpeg's jidctint.c (13-bit constants,
//     two passes, its descaling and its range-limit table);
//   - "fancy" triangle upsampling of h2v1 and h2v2 chroma (jdsample.c),
//     with its alternating rounding bias, its edge columns and rows, and
//     plain replication where the chroma is at most 2 samples wide;
//   - YCbCr -> RGB by jdcolor.c's 16-bit fixed-point tables.
// No EXIF orientation is applied (PIL's Image.open applies none).
//
// What it does not decode raises, with a message naming it: arithmetic
// coding, precisions other than 8 bits, lossless and hierarchical frames,
// 4-component images, sampling other than luma 1x1, 2x1 or 2x2 over
// chroma 1x1, and progressive files whose scans leave any of the first ten
// coefficients unrefined (libjpeg smooths those blocks). A truncated or
// corrupt stream raises too (status 1); where libjpeg would warn and go on
// (a bad Huffman code, entropy data that runs into a marker), this
// decoder stops.
//
// ngp_jpeg_info reads the header only; ngp_jpeg_decode decodes many files,
// one a thread. Both are plain C functions called through ctypes, which
// releases the GIL for the call.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {
namespace jpeg {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

struct Failure {
  int status;
  std::string message;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{kCorrupt, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{kUnsupported, m}; }

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ------------------------------------------------------------------
// Huffman tables and the entropy-coded bit stream
// ------------------------------------------------------------------

struct Huffman {
  bool defined = false;
  uint16_t fast[512];   // 9-bit prefix -> (length << 8) | symbol; 0: longer
  int32_t maxcode[18];  // the largest code of each length, -1 where none
  int32_t valptr[18];   // index of a length's first symbol minus its code
  uint8_t vals[256];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int n_vals) {
  std::memcpy(h.vals, vals, n_vals);
  std::memset(h.fast, 0, sizeof h.fast);
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = counts[len - 1];
    h.valptr[len] = k - code;
    h.maxcode[len] = n ? code + n - 1 : -1;
    for (int i = 0; i < n; ++i, ++k, ++code)
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j)
          h.fast[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
      }
    // no code may be all ones (libjpeg's jpeg_make_d_derived_tbl)
    if (n && code >= (1 << len)) corrupt("corrupt Huffman table");
    code <<= 1;
  }
  h.defined = true;
}

// The bits of one entropy-coded segment, most significant first, with
// stuffed zero bytes removed. Past the segment's closing marker the
// buffer is padded with zero bits; a code that reaches into them is
// corrupt data.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // valid bits MSB-aligned
  int n = 0;         // valid bits in acc
  int fake = 0;      // of them, the zero bits past the marker
  bool at_marker = false;

  void reset(const uint8_t* q, const uint8_t* e) {
    p = q;
    end = e;
    acc = 0;
    n = fake = 0;
    at_marker = false;
  }
  void fill() {
    while (n <= 56) {
      uint64_t c = 0;
      if (at_marker) {
        fake += 8;
      } else {
        if (p >= end) corrupt("truncated JPEG data (entropy-coded segment cut short)");
        if (*p != 0xFF) {
          c = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q >= end) corrupt("truncated JPEG data (entropy-coded segment cut short)");
          if (*q == 0x00) {
            c = 0xFF;
            p = q + 1;
          } else {
            at_marker = true;
            p = q - 1;  // the 0xFF before the marker's code
            fake += 8;
          }
        }
      }
      acc |= c << (56 - n);
      n += 8;
    }
  }
  uint32_t peek(int k) {
    if (n < k) fill();
    return (uint32_t)(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    n -= k;
    if (n < fake) corrupt("corrupt JPEG data (a code runs into a marker)");
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return (int)v;
  }
  // The position of the marker that ends this segment, skipping bytes
  // before it as libjpeg's next_marker does (the buffered bits are padding).
  const uint8_t* marker() const {
    const uint8_t* q = p;
    for (;;) {
      while (q < end && *q != 0xFF) ++q;
      const uint8_t* r = q;
      while (r < end && *r == 0xFF) ++r;
      if (r >= end) corrupt("truncated JPEG data (no marker after a scan)");
      if (*r != 0x00) return r - 1;
      q = r + 1;
    }
  }
};

inline int decode_symbol(Bits& b, const Huffman& h) {
  uint32_t look = b.peek(16);
  uint16_t f = h.fast[look >> 7];
  if (f) {
    b.skip(f >> 8);
    return f & 0xFF;
  }
  for (int len = 10; len <= 16; ++len) {
    int32_t code = (int32_t)(look >> (16 - len));
    if (code <= h.maxcode[len]) {
      b.skip(len);
      return h.vals[h.valptr[len] + code];
    }
  }
  corrupt("corrupt JPEG data (bad Huffman code)");
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------------------
// The islow IDCT (jidctint.c) and the sample range limit (jdmaster.c)
// ------------------------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// prepare_range_limit_table's post-IDCT part: index (x & 1023) of a
// descaled IDCT output x gives clamp(x + 128) for x in [-384, 639]
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; ++v)
      t[v] = v < 128 ? (uint8_t)(128 + v) : v < 512 ? 255 : v < 896 ? 0 : (uint8_t)(v - 896);
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* w = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, s);
    w[56] = (int)descale(tmp10 - tmp3, s);
    w[8] = (int)descale(tmp11 + tmp2, s);
    w[48] = (int)descale(tmp11 - tmp2, s);
    w[16] = (int)descale(tmp12 + tmp1, s);
    w[40] = (int)descale(tmp12 - tmp1, s);
    w[24] = (int)descale(tmp13 + tmp0, s);
    w[32] = (int)descale(tmp13 - tmp0, s);
  }
  constexpr int s = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t dc = kRange.t[(int)descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[(int)descale(tmp10 + tmp3, s) & 1023];
    o[7] = kRange.t[(int)descale(tmp10 - tmp3, s) & 1023];
    o[1] = kRange.t[(int)descale(tmp11 + tmp2, s) & 1023];
    o[6] = kRange.t[(int)descale(tmp11 - tmp2, s) & 1023];
    o[2] = kRange.t[(int)descale(tmp12 + tmp1, s) & 1023];
    o[5] = kRange.t[(int)descale(tmp12 - tmp1, s) & 1023];
    o[3] = kRange.t[(int)descale(tmp13 + tmp0, s) & 1023];
    o[4] = kRange.t[(int)descale(tmp13 - tmp0, s) & 1023];
  }
}

// ------------------------------------------------------------------
// YCbCr -> RGB (jdcolor.c build_ycc_rgb_table)
// ------------------------------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = (int32_t)(-fix(0.71414) * x);
      cb_g[i] = (int32_t)(-fix(0.34414) * x + kHalf);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------------
// The decoder
// ------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks a row and a column of the MCU-padded grid
  int dw = 0, dh = 0;  // samples a row and a column (ceil(W h / hmax), ...)
  int td = 0, ta = 0, dc_pred = 0;
  bool latched = false, scanned = false;
  uint16_t q[64];            // the latched quantisation table, natural order
  int coef_bits[64];         // progressive: the Al last sent, -1 before any
  std::vector<int16_t> coef;  // (bh, bw, 64), natural order
  std::vector<uint8_t> plane;  // (bh * 8, bw * 8) samples after the IDCT
  int16_t* block(int bx, int by) { return coef.data() + ((size_t)by * bw + bx) * 64; }
};

struct Decoder {
  const uint8_t* data;
  size_t size, pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0, sof = -1, precision = 8;
  int width = 0, height = 0, n_comp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, jfif = false, adobe = false, eoi = false;
  int adobe_transform = -1;
  Component comp[4];
  int eobrun = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) corrupt("truncated JPEG data (a marker segment cut short)");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }
  // the payload of a marker segment: [pos, end)
  size_t segment() {
    int len = u16();
    if (len < 2) corrupt("corrupt JPEG data (bad marker length)");
    if (pos + len - 2 > size) corrupt("truncated JPEG data (a marker segment cut short)");
    return pos + len - 2;
  }
  int next_marker() {
    if (pos >= size || data[pos] != 0xFF) {
      if (pos >= size) corrupt("truncated JPEG data (no EOI marker)");
      corrupt("corrupt JPEG data (expected a marker)");
    }
    while (pos < size && data[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= size) corrupt("truncated JPEG data (no EOI marker)");
    return data[pos++];
  }

  void read_sof(int m) {
    if (sof >= 0) corrupt("corrupt JPEG data (two frame headers)");
    size_t end = segment();
    sof = m;
    precision = u8();
    height = u16();
    width = u16();
    n_comp = u8();
    if (end - pos != (size_t)3 * n_comp) corrupt("corrupt JPEG data (bad frame header length)");
    if (n_comp < 1 || n_comp > 4) corrupt("corrupt JPEG data (bad component count)");
    for (int i = 0; i < n_comp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        corrupt("corrupt JPEG data (bad component parameters)");
      for (int j = 0; j < i; ++j)
        if (comp[j].id == c.id) corrupt("corrupt JPEG data (two components share an id)");
    }
    progressive = m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE;
  }

  // Refuse what this decoder does not reproduce, then lay out the frame.
  void check_and_layout() {
    if ((sof >= 0xC9 && sof <= 0xCB) || (sof >= 0xCD && sof <= 0xCF))
      unsupported("arithmetic coding is not supported");
    if (sof == 0xC3) unsupported("lossless JPEG is not supported");
    if (sof >= 0xC5 && sof <= 0xC7) unsupported("hierarchical JPEG is not supported");
    if (precision != 8)
      unsupported(std::to_string(precision) + "-bit precision is not supported (8-bit only)");
    if (n_comp == 4) unsupported("4-component (CMYK/YCCK) JPEG is not supported");
    if (n_comp == 2) unsupported("2-component JPEG is not supported");
    if (width == 0 || height == 0)
      unsupported("a zero image size (DNL-defined height) is not supported");
    if (n_comp == 3) {
      const Component& y = comp[0];
      bool luma_ok = (y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 1) || (y.h == 2 && y.v == 2);
      bool chroma_ok = comp[1].h == 1 && comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1;
      if (!luma_ok || !chroma_ok)
        unsupported("sampling factors " + std::to_string(y.h) + "x" + std::to_string(y.v) +
                    "," + std::to_string(comp[1].h) + "x" + std::to_string(comp[1].v) + "," +
                    std::to_string(comp[2].h) + "x" + std::to_string(comp[2].v) +
                    " are not supported (luma 1x1, 2x1 or 2x2 over chroma 1x1 only)");
    } else {
      comp[0].h = comp[0].v = 1;  // one component: its factors do not matter
    }
    hmax = vmax = 1;
    for (int i = 0; i < n_comp; ++i) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < n_comp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
  }

  void read_dqt() {
    size_t end = segment();
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) corrupt("corrupt JPEG data (bad quantisation table)");
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = (uint16_t)(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    if (pos != end) corrupt("corrupt JPEG data (bad quantisation table length)");
  }

  void read_dht() {
    size_t end = segment();
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) corrupt("corrupt JPEG data (bad Huffman table)");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256 || pos + total > end) corrupt("corrupt JPEG data (bad Huffman table)");
      build_huffman(tc ? ac[th] : dc[th], counts, data + pos, total);
      pos += total;
    }
    if (pos != end) corrupt("corrupt JPEG data (bad Huffman table length)");
  }

  void read_app(int m) {
    size_t end = segment();
    size_t len = end - pos;
    const uint8_t* d = data + pos;
    if (m == 0xE0 && len >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && len >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[11];
    }
    pos = end;
  }

  void process_restart(Bits& b, int n) {
    const uint8_t* q = b.marker();
    if (q[1] != 0xD0 + n) corrupt("corrupt JPEG data (missing restart marker)");
    b.reset(q + 2, data + size);
  }

  void block_sequential(Bits& b, Component& c, int16_t* blk) {
    int s = decode_symbol(b, dc[c.td]);
    if (s > 15) corrupt("corrupt JPEG data (bad DC difference size)");
    c.dc_pred += s ? extend(b.get(s), s) : 0;
    blk[0] = (int16_t)c.dc_pred;
    const Huffman& h = ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(b, h);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) corrupt("corrupt JPEG data (coefficient run past the block)");
        blk[kNatural[k]] = (int16_t)extend(b.get(s), s);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void block_dc_first(Bits& b, Component& c, int16_t* blk, int al) {
    int s = decode_symbol(b, dc[c.td]);
    if (s > 15) corrupt("corrupt JPEG data (bad DC difference size)");
    c.dc_pred += s ? extend(b.get(s), s) : 0;
    blk[0] = (int16_t)((uint32_t)c.dc_pred << al);
  }

  void block_ac_first(Bits& b, Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& h = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = decode_symbol(b, h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) corrupt("corrupt JPEG data (coefficient run past the band)");
        blk[kNatural[k]] = (int16_t)((uint32_t)extend(b.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) - 1;
        if (r) eobrun += b.get(r);
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine
  void block_ac_refine(Bits& b, Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (b.get(1) && (coef & p1) == 0) coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      const Huffman& h = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = decode_symbol(b, h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = b.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) corrupt("corrupt JPEG data (coefficient run past the band)");
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void read_sos() {
    if (sof < 0) corrupt("corrupt JPEG data (a scan before the frame header)");
    size_t end = segment();
    int ns = u8();
    if (ns < 1 || ns > 4 || end - pos != (size_t)2 * ns + 3)
      corrupt("corrupt JPEG data (bad scan header)");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      sc[i] = nullptr;
      for (int j = 0; j < n_comp; ++j)
        if (comp[j].id == id) sc[i] = &comp[j];
      if (sc[i] == nullptr) corrupt("corrupt JPEG data (a scan names no component of the frame)");
      for (int j = 0; j < i; ++j)
        if (sc[j] == sc[i]) corrupt("corrupt JPEG data (a scan names a component twice)");
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) corrupt("corrupt JPEG data (bad table selector)");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) corrupt("corrupt JPEG data (bad progressive scan parameters)");
    } else if (ss != 0 || se != 63 || a != 0) {
      corrupt("corrupt JPEG data (bad sequential scan parameters)");
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.latched) {  // libjpeg latches a table at the component's first scan
        if (!qt_defined[c.tq]) corrupt("corrupt JPEG data (an undefined quantisation table)");
        std::memcpy(c.q, qt[c.tq], sizeof c.q);
        c.latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[c.td].defined) || (need_ac && !ac[c.ta].defined))
        corrupt("corrupt JPEG data (an undefined Huffman table)");
      c.scanned = true;
      if (progressive)
        for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
    }
    decode_scan(sc, ns, ss, se, ah, al);
  }

  void decode_scan(Component** sc, int ns, int ss, int se, int ah, int al) {
    Bits b;
    b.reset(data + pos, data + size);
    int mx_n = mcux, my_n = mcuy;
    if (ns == 1) {
      mx_n = (sc[0]->dw + 7) / 8;
      my_n = (sc[0]->dh + 7) / 8;
    }
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    eobrun = 0;
    int64_t total = (int64_t)mx_n * my_n;
    int left = restart_interval, next_rst = 0;
    auto one = [&](Component& c, int16_t* blk) {
      if (!progressive)
        block_sequential(b, c, blk);
      else if (ss == 0 && ah == 0)
        block_dc_first(b, c, blk, al);
      else if (ss == 0)
        blk[0] = (int16_t)(blk[0] | (b.get(1) ? (1 << al) : 0));
      else if (ah == 0)
        block_ac_first(b, c, blk, ss, se, al);
      else
        block_ac_refine(b, c, blk, ss, se, al);
    };
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (left == 0) {
          process_restart(b, next_rst);
          next_rst = (next_rst + 1) & 7;
          left = restart_interval;
          for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
          eobrun = 0;
        }
        --left;
      }
      int mx = (int)(m % mx_n), my = (int)(m / mx_n);
      if (ns == 1) {
        one(*sc[0], sc[0]->block(mx, my));
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) one(c, c.block(mx * c.h + h, my * c.v + v));
        }
      }
    }
    pos = (size_t)(b.marker() - data);
  }

  // Parse markers up to the frame header (header_only) or to EOI.
  void run(bool header_only) {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8)
      corrupt("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if ((m >= 0xC0 && m <= 0xC3) || (m >= 0xC5 && m <= 0xC7) || (m >= 0xC9 && m <= 0xCB) ||
          (m >= 0xCD && m <= 0xCF)) {
        read_sof(m);
        if (header_only) return;
        check_and_layout();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        unsupported("arithmetic coding is not supported (DAC marker)");
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        size_t end = segment();
        if (end - pos != 2) corrupt("corrupt JPEG data (bad DRI length)");
        restart_interval = u16();
      } else if (m == 0xDA) {
        if (header_only) corrupt("corrupt JPEG data (a scan before the frame header)");
        read_sos();
      } else if (m == 0xD9) {
        if (header_only) corrupt("corrupt JPEG data (no frame header)");
        eoi = true;
        return;
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        read_app(m);  // APPn, COM and DNL are skipped (JFIF and Adobe noted)
      } else if (m == 0xDE || m == 0xDF) {
        unsupported("hierarchical JPEG is not supported");
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // parameterless markers outside a scan: libjpeg ignores them
      } else if (m == 0xD8) {
        corrupt("corrupt JPEG data (a second SOI marker)");
      } else {
        char buf[64];
        std::snprintf(buf, sizeof buf, "corrupt JPEG data (unknown marker 0x%02X)", m);
        corrupt(buf);
      }
    }
  }

  // libjpeg's default_decompress_parms for three components
  bool is_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  void reconstruct() {
    for (int i = 0; i < n_comp; ++i) {
      Component& c = comp[i];
      if (!c.scanned) corrupt("corrupt JPEG data (a component in no scan)");
      if (progressive)
        for (int k = 0; k < 10; ++k)
          if (c.coef_bits[k] != 0)
            unsupported("progressive JPEG whose scans leave coefficients unrefined is not "
                        "supported (libjpeg smooths them)");
      int stride = c.bw * 8;
      c.plane.assign((size_t)stride * c.bh * 8, 0);
      // only the blocks that hold samples of the image
      int bx_n = (c.dw + 7) / 8, by_n = (c.dh + 7) / 8;
      for (int by = 0; by < by_n; ++by)
        for (int bx = 0; bx < bx_n; ++bx)
          idct_islow(c.block(bx, by), c.q, c.plane.data() + (size_t)by * 8 * stride + bx * 8,
                     stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // chroma row of component c upsampled to the output row y
  void upsample_row(const Component& c, int y, uint8_t* out, std::vector<int>& colsum) const {
    const int stride = c.bw * 8, dw = c.dw;
    if (hmax == 1) {  // 4:4:4
      std::memcpy(out, c.plane.data() + (size_t)y * stride, width);
      return;
    }
    if (vmax == 1) {  // h2v1
      const uint8_t* in = c.plane.data() + (size_t)y * stride;
      if (dw <= 2) {
        for (int x = 0; x < width; ++x) out[x] = in[x >> 1];
        return;
      }
      out[0] = in[0];
      out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = in[i] * 3;
        out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      int l = dw - 1;
      out[2 * l] = (uint8_t)((in[l] * 3 + in[l - 1] + 1) >> 2);
      out[2 * l + 1] = in[l];
      return;
    }
    // h2v2
    const int r = y >> 1;
    const uint8_t* near_row = c.plane.data() + (size_t)r * stride;
    if (dw <= 2) {
      for (int x = 0; x < width; ++x) out[x] = near_row[x >> 1];
      return;
    }
    int rf = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
    const uint8_t* far_row = c.plane.data() + (size_t)rf * stride;
    for (int i = 0; i < dw; ++i) colsum[i] = near_row[i] * 3 + far_row[i];
    out[0] = (uint8_t)((colsum[0] * 4 + 8) >> 4);
    out[1] = (uint8_t)((colsum[0] * 3 + colsum[1] + 7) >> 4);
    for (int i = 1; i < dw - 1; ++i) {
      out[2 * i] = (uint8_t)((colsum[i] * 3 + colsum[i - 1] + 8) >> 4);
      out[2 * i + 1] = (uint8_t)((colsum[i] * 3 + colsum[i + 1] + 7) >> 4);
    }
    int l = dw - 1;
    out[2 * l] = (uint8_t)((colsum[l] * 3 + colsum[l - 1] + 8) >> 4);
    out[2 * l + 1] = (uint8_t)((colsum[l] * 4 + 7) >> 4);
  }

  // (H, W, channels): channels 4 gives RGBA (grey replicated, alpha 255),
  // else the file's own components (1 or 3)
  void write(uint8_t* out, int channels) const {
    const Component& y0 = comp[0];
    const int ystride = y0.bw * 8;
    if (n_comp == 1) {
      for (int y = 0; y < height; ++y) {
        const uint8_t* in = y0.plane.data() + (size_t)y * ystride;
        uint8_t* o = out + (size_t)y * width * channels;
        if (channels == 1) {
          std::memcpy(o, in, width);
        } else {
          for (int x = 0; x < width; ++x) {
            o[4 * x] = o[4 * x + 1] = o[4 * x + 2] = in[x];
            o[4 * x + 3] = 255;
          }
        }
      }
      return;
    }
    const bool rgb = is_rgb();
    std::vector<uint8_t> c1(2 * (size_t)comp[1].bw * 8 + 2), c2(c1.size());
    std::vector<int> colsum(comp[1].bw * 8 + 1);
    for (int y = 0; y < height; ++y) {
      const uint8_t* l = y0.plane.data() + (size_t)y * ystride;
      upsample_row(comp[1], y, c1.data(), colsum);
      upsample_row(comp[2], y, c2.data(), colsum);
      uint8_t* o = out + (size_t)y * width * channels;
      for (int x = 0; x < width; ++x, o += channels) {
        if (rgb) {
          o[0] = l[x];
          o[1] = c1[x];
          o[2] = c2[x];
        } else {
          int yy = l[x], cb = c1[x], cr = c2[x];
          o[0] = clamp255(yy + kYcc.cr_r[cr]);
          o[1] = clamp255(yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
          o[2] = clamp255(yy + kYcc.cb_b[cb]);
        }
        if (channels == 4) o[3] = 255;
      }
    }
  }
};

void put_message(char* dst, int64_t cap, const std::string& m) {
  if (dst == nullptr || cap <= 0) return;
  size_t n = std::min((size_t)cap - 1, m.size());
  std::memcpy(dst, m.data(), n);
  dst[n] = 0;
}

int decode_one(const uint8_t* data, int64_t size, uint8_t* out, int rgba, char* err,
               int64_t err_len) {
  try {
    Decoder d(data, (size_t)size);
    d.run(false);
    d.reconstruct();
    d.write(out, rgba ? 4 : d.n_comp);
    return kOk;
  } catch (const Failure& f) {
    put_message(err, err_len, f.message);
    return f.status;
  } catch (const std::bad_alloc&) {
    put_message(err, err_len, "out of memory decoding a JPEG file");
    return kCorrupt;
  }
}

}  // namespace jpeg
}  // namespace

extern "C" {

// The frame header of a JPEG file: info = (width, height, components,
// progressive). Returns 0, or a status (1 corrupt, 2 unsupported) with its
// message in err.
int ngp_jpeg_info(const uint8_t* data, int64_t size, int32_t* info, char* err,
                  int64_t err_len) {
  try {
    jpeg::Decoder d(data, (size_t)size);
    d.run(true);
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.n_comp;
    info[3] = d.progressive ? 1 : 0;
    return jpeg::kOk;
  } catch (const jpeg::Failure& f) {
    jpeg::put_message(err, err_len, f.message);
    return f.status;
  }
}

// Decode n files, one a thread over n_threads (0: one a hardware thread):
// file i (datas[i], sizes[i] bytes) into outs[i], (H, W, 4) RGBA where rgba,
// else (H, W) grey or (H, W, 3) RGB, allocated by the caller from
// ngp_jpeg_info. status[i] is 0 or a status with its message at
// errs + i * err_len.
void ngp_jpeg_decode(int64_t n, const uint8_t* const* datas, const int64_t* sizes,
                     uint8_t* const* outs, int rgba, int n_threads, int32_t* status,
                     char* errs, int64_t err_len) {
  int t = n_threads > 0 ? n_threads : (int)std::max(1u, std::thread::hardware_concurrency());
  t = (int)std::min<int64_t>(t, std::max<int64_t>(n, 1));
  std::atomic<int64_t> next{0};
  auto work = [&]() {
    for (int64_t i; (i = next.fetch_add(1)) < n;)
      status[i] = jpeg::decode_one(datas[i], sizes[i], outs[i], rgba, errs + i * err_len,
                                   err_len);
  };
  std::vector<std::thread> pool;
  for (int i = 1; i < t; ++i) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

}  // extern "C"
