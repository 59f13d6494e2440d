// jpeg_encode — the JPEG writer of ngp_tpu_torch, built into the same
// library as ngp_host.cpp and jpeg_decode.cpp.
//
// It writes, byte for byte, what PIL writes for an (H, W, 3) uint8 RGB
// image with Image.save(f, format="JPEG", quality=q) through libjpeg-turbo
// (built with its SIMD, as PIL's wheels ship it) and PIL's defaults:
//   - SOI, a JFIF 1.01 APP0 (density 1x1, no units), one DQT a table
//     (luma, then chroma), SOF0, the four standard Huffman tables (DC 0,
//     AC 0, DC 1, AC 1, each a DHT), SOS, the entropy-coded data, EOI;
//     no restart markers, no Huffman optimisation;
//   - jcparam.c's standard tables scaled by jpeg_quality_scaling, clamped
//     to [1, 255] (force_baseline);
//   - 4:2:0 sampling: Y 2x2, Cb and Cr 1x1, MCUs of 16x16 pixels.
// The integer algorithms that decide each byte:
//   - jccolor.c's RGB -> YCbCr, 16-bit fixed point (the chroma rounding
//     ONE_HALF - 1);
//   - jcsample.c's h2v2 average with its bias alternating 1, 2 along a row;
//   - the edges: the last column and row replicated (columns up to whole
//     blocks, the full-resolution rows to an even count before the chroma
//     average, each plane's rows up to whole MCUs); blocks outside a
//     component's blocks within an MCU are jccoefct.c's dummies (all AC 0,
//     the DC of the block before);
//   - the "islow" forward DCT of jfdctint.c (13-bit constants, two passes);
//   - jcdctmgr.c's quantisation by reciprocal (compute_reciprocal with
//     16-bit DCT elements, as the SIMD build has them): q = (|x| + c) · f
//     >> r, which is not always |x| / (8·quant) rounded;
//   - jchuff.c's coding, 0xFF stuffed with 0x00, the last byte padded with
//     1 bits.
//
// ngp_jpeg_encode is a plain C function called through ctypes, which
// releases the GIL for the call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
namespace jpeg_encode {

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c's std_luminance_quant_tbl and std_chrominance_quant_tbl
// (natural order)
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c's tables: code counts of lengths 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ------------------------------------------------------------------
// Tables
// ------------------------------------------------------------------

// jpeg_quality_scaling, then jpeg_add_quant_table with force_baseline
void scaled_quant(const int* basic, int quality, int* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = (basic[i] * scale + 50L) / 100L;
    out[i] = v <= 0 ? 1 : v > 255 ? 255 : static_cast<int>(v);
  }
}

// The quantiser of one coefficient: q = (|x| + corr) * recip >> shift,
// compute_reciprocal of the divisor quant << 3 with 16-bit DCT elements.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two: fq would not fit 16 bits
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

// jpeg_make_c_derived_tbl: code and length a symbol
struct HuffCodes {
  uint32_t code[256];
  int size[256];
};

void derive_codes(const uint8_t* bits, const uint8_t* vals, HuffCodes& t) {
  std::memset(t.size, 0, sizeof t.size);
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      t.code[vals[k]] = code++;
      t.size[vals[k]] = len;
    }
    code <<= 1;
  }
}

// ------------------------------------------------------------------
// The forward DCT (jfdctint.c, islow)
// ------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298631336 = 2446, F_0_390180644 = 3196, F_0_541196100 = 4433,
                  F_0_765366865 = 6270, F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137, F_1_961570560 = 16069,
                  F_2_053119869 = 16819, F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// One pass over 8 rows (stride 1 within a row, 8 between rows) or 8
// columns (stride 8 within, 1 between); ``last`` is the column pass.
void fdct_pass(int32_t* data, int step, int next, bool last) {
  const int odd = last ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
  for (int ctr = 0; ctr < 8; ++ctr, data += next) {
    int32_t* p = data;
    int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
    int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
    int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
    int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    if (last) {
      p[0] = descale(tmp10 + tmp11, kPass1Bits);
      p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
    } else {
      p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
      p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
    }
    int32_t z1 = (tmp12 + tmp13) * F_0_541196100;
    p[2 * step] = descale(z1 + tmp13 * F_0_765366865, odd);
    p[6 * step] = descale(z1 + tmp12 * -F_1_847759065, odd);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp4 *= F_0_298631336;
    tmp5 *= F_2_053119869;
    tmp6 *= F_3_072711026;
    tmp7 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 = z3 * -F_1_961570560 + z5;
    z4 = z4 * -F_0_390180644 + z5;
    p[7 * step] = descale(tmp4 + z1 + z3, odd);
    p[5 * step] = descale(tmp5 + z2 + z4, odd);
    p[3 * step] = descale(tmp6 + z2 + z3, odd);
    p[step] = descale(tmp7 + z1 + z4, odd);
  }
}

// ------------------------------------------------------------------
// Output: markers and the entropy-coded bits
// ------------------------------------------------------------------

struct Writer {
  uint8_t* out;
  int64_t cap, n = 0;
  bool overflow = false;
  uint64_t bits = 0;  // pending bits, right-aligned
  int n_bits = 0;

  void byte(uint8_t b) {
    if (n < cap) out[n] = b;
    else overflow = true;
    ++n;
  }
  void word(int v) {
    byte(static_cast<uint8_t>(v >> 8));
    byte(static_cast<uint8_t>(v));
  }
  void put(uint32_t code, int size) {  // size <= 27
    bits = (bits << size) | (code & ((1u << size) - 1));
    n_bits += size;
    while (n_bits >= 8) {
      uint8_t b = static_cast<uint8_t>(bits >> (n_bits - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      n_bits -= 8;
    }
  }
  void flush() {  // fill the last byte with 1 bits
    if (n_bits > 0) put((1u << (8 - n_bits)) - 1, 8 - n_bits);
  }
};

void write_dqt(Writer& w, int index, const int* quant) {
  w.word(0xFFDB);
  w.word(67);
  w.byte(static_cast<uint8_t>(index));
  for (int i = 0; i < 64; ++i) w.byte(static_cast<uint8_t>(quant[kNatural[i]]));
}

void write_dht(Writer& w, int klass_index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + n);
  w.byte(static_cast<uint8_t>(klass_index));
  for (int i = 0; i < 16; ++i) w.byte(bits[i]);
  for (int i = 0; i < n; ++i) w.byte(vals[i]);
}

struct Component {
  std::vector<uint8_t> plane;  // rows x cols samples, edges replicated
  int cols = 0, rows = 0;
  int width_blocks = 0, height_blocks = 0;
  const Divisor* div = nullptr;
  const HuffCodes* dc = nullptr;
  const HuffCodes* ac = nullptr;
  int last_dc = 0;
};

// The DCT and the quantiser of the block at block row by, column bx.
void quantized_block(const Component& c, int by, int bx, int16_t* coef) {
  int32_t ws[64];
  const uint8_t* src = c.plane.data() + static_cast<int64_t>(by) * 8 * c.cols + bx * 8;
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) ws[y * 8 + x] = static_cast<int32_t>(src[y * c.cols + x]) - 128;
  fdct_pass(ws, 1, 8, false);
  fdct_pass(ws, 8, 1, true);
  for (int i = 0; i < 64; ++i) {
    const Divisor& d = c.div[i];
    int32_t x = ws[i];
    uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x) + d.corr;
    int32_t q = static_cast<int32_t>((static_cast<uint64_t>(a) * d.recip) >> d.shift);
    coef[i] = static_cast<int16_t>(x < 0 ? -q : q);
  }
}

inline int n_bits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(Writer& w, Component& c, const int16_t* coef) {
  int diff = coef[0] - c.last_dc;
  c.last_dc = coef[0];
  int mag = diff < 0 ? -diff : diff;
  int nb = n_bits_of(mag);
  w.put(c.dc->code[nb], c.dc->size[nb]);
  if (nb) w.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.put(c.ac->code[0xF0], c.ac->size[0xF0]);
      run -= 16;
    }
    mag = v < 0 ? -v : v;
    nb = n_bits_of(mag);
    int sym = (run << 4) + nb;
    w.put(c.ac->code[sym], c.ac->size[sym]);
    w.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nb);
    run = 0;
  }
  if (run > 0) w.put(c.ac->code[0], c.ac->size[0]);
}

int64_t encode(const uint8_t* rgb, int width, int height, int quality, uint8_t* out,
               int64_t cap) {
  const int mcu_cols = (width + 15) / 16, mcu_rows = (height + 15) / 16;
  int quant[2][64];
  scaled_quant(kLumaQuant, quality, quant[0]);
  scaled_quant(kChromaQuant, quality, quant[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(static_cast<uint32_t>(quant[t][i]) << 3);
  HuffCodes dc[2], ac[2];
  derive_codes(kDcLumaBits, kDcVals, dc[0]);
  derive_codes(kDcChromaBits, kDcVals, dc[1]);
  derive_codes(kAcLumaBits, kAcLumaVals, ac[0]);
  derive_codes(kAcChromaBits, kAcChromaVals, ac[1]);

  // Y at full resolution over whole MCUs; Cb and Cr at full resolution
  // over the columns their h2v2 average reads and the rows rounded up to
  // even, then averaged over whole MCUs. Edges replicate the last column
  // and row (the rows past a component's last block row are never read).
  Component comp[3];
  const int full_cols = mcu_cols * 16, full_rows = mcu_rows * 16;
  std::vector<uint8_t> cb_full(static_cast<size_t>(full_cols) * full_rows);
  std::vector<uint8_t> cr_full(cb_full.size());
  comp[0].plane.resize(cb_full.size());
  const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
  for (int y = 0; y < full_rows; ++y) {
    const uint8_t* row = rgb + static_cast<int64_t>(y < height ? y : height - 1) * width * 3;
    const int64_t o = static_cast<int64_t>(y) * full_cols;
    for (int x = 0; x < full_cols; ++x) {
      const uint8_t* p = row + (x < width ? x : width - 1) * 3;
      int32_t r = p[0], g = p[1], b = p[2];
      comp[0].plane[o + x] =
          static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + ONE_HALF) >> 16);
      cb_full[o + x] = static_cast<uint8_t>(
          (-11059 * r - 21709 * g + 32768 * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
      cr_full[o + x] = static_cast<uint8_t>(
          (32768 * r - 27439 * g - 5329 * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
    }
  }
  comp[0].cols = full_cols;
  comp[0].rows = full_rows;
  comp[0].width_blocks = (width + 7) / 8;
  comp[0].height_blocks = (height + 7) / 8;
  // chroma: the full-resolution rows past the image's even row count
  // replicate its last (even-padded) row pair's result, so rows of the
  // average at or past ceil(height / 2) copy the last real one
  const int half_rows = (height + 1) / 2;
  for (int ci = 1; ci < 3; ++ci) {
    const std::vector<uint8_t>& full = ci == 1 ? cb_full : cr_full;
    Component& c = comp[ci];
    c.cols = mcu_cols * 8;
    c.rows = mcu_rows * 8;
    c.width_blocks = mcu_cols;
    c.height_blocks = mcu_rows;
    c.plane.resize(static_cast<size_t>(c.cols) * c.rows);
    for (int y = 0; y < c.rows; ++y) {
      const int sy = y < half_rows ? y : half_rows - 1;
      const uint8_t* r0 = full.data() + static_cast<int64_t>(2 * sy) * full_cols;
      // rows past the image are copies of its last row
      const int y1 = 2 * sy + 1 < height ? 2 * sy + 1 : height - 1;
      const uint8_t* r1 = full.data() + static_cast<int64_t>(y1) * full_cols;
      int bias = 1;
      for (int x = 0; x < c.cols; ++x) {
        c.plane[static_cast<int64_t>(y) * c.cols + x] = static_cast<uint8_t>(
            (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  for (int ci = 0; ci < 3; ++ci) {
    const int t = ci ? 1 : 0;
    comp[ci].div = div[t];
    comp[ci].dc = &dc[t];
    comp[ci].ac = &ac[t];
  }

  Writer w{out, cap};
  w.word(0xFFD8);
  // JFIF APP0: version 1.01, density 1x1 without units, no thumbnail
  const uint8_t app0[16] = {0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  w.word(0xFFE0);
  for (uint8_t b : app0) w.byte(b);
  write_dqt(w, 0, quant[0]);
  write_dqt(w, 1, quant[1]);
  w.word(0xFFC0);
  w.word(17);
  w.byte(8);
  w.word(height);
  w.word(width);
  w.byte(3);
  const uint8_t sof[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  for (uint8_t b : sof) w.byte(b);
  write_dht(w, 0x00, kDcLumaBits, kDcVals);
  write_dht(w, 0x10, kAcLumaBits, kAcLumaVals);
  write_dht(w, 0x01, kDcChromaBits, kDcVals);
  write_dht(w, 0x11, kAcChromaBits, kAcChromaVals);
  w.word(0xFFDA);
  w.word(12);
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  for (uint8_t b : sos) w.byte(b);

  int16_t blocks[4][64], chroma[64];
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      // Y: 2x2 blocks, dummies (AC 0, the DC of the block before) right
      // of the last block column and below the last block row
      Component& y = comp[0];
      for (int yi = 0; yi < 2; ++yi) {
        for (int xi = 0; xi < 2; ++xi) {
          int16_t* blk = blocks[yi * 2 + xi];
          const int by = my * 2 + yi, bx = mx * 2 + xi;
          if (by < y.height_blocks && bx < y.width_blocks) {
            quantized_block(y, by, bx, blk);
          } else {
            std::memset(blk, 0, 64 * sizeof(int16_t));
            // the block before in the MCU: left of it in a real row, the
            // last of the row above in a dummy row
            blk[0] = by < y.height_blocks ? blocks[yi * 2 + xi - 1][0] : blocks[yi * 2 - 1][0];
          }
        }
      }
      for (int k = 0; k < 4; ++k) encode_block(w, y, blocks[k]);
      for (int ci = 1; ci < 3; ++ci) {
        quantized_block(comp[ci], my, mx, chroma);
        encode_block(w, comp[ci], chroma);
      }
    }
  }
  w.flush();
  w.word(0xFFD9);
  return w.overflow ? -w.n : w.n;
}

}  // namespace jpeg_encode
}  // namespace

extern "C" {

// Encode the (height, width, 3) uint8 RGB image ``rgb`` (C order) as a
// baseline 4:2:0 JPEG at ``quality`` into ``out`` (``capacity`` bytes).
// Returns the file's size, or minus the size it needs where ``capacity``
// is too small (nothing past ``capacity`` is written).
int64_t ngp_jpeg_encode(const uint8_t* rgb, int width, int height, int quality, uint8_t* out,
                        int64_t capacity) {
  return jpeg_encode::encode(rgb, width, height, quality, out, capacity);
}

}  // extern "C"
