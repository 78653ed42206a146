// JPEG decoder: ITU-T T.81 Huffman coding (SOF0 baseline, SOF1 extended,
// SOF2 progressive) and arithmetic coding (SOF9 sequential, SOF10
// progressive), 8-bit samples, to the grayscale plane that libjpeg
// (libjpeg-turbo) gives with out_color_space = JCS_GRAYSCALE.
//
// What that output is, and what this file does to reproduce it:
// - Gray and YCbCr files give component 0 (Y). The other components are
//   entropy-decoded to stay in step (scans of them alone are skipped to the
//   next marker) but never dequantised or transformed.
// - Adobe RGB files (APP14 transform 0, or component ids 'R' 'G' 'B') give
//   libjpeg's fixed-point mix, (19595 R + 38470 G + 7471 B + 32768) >> 16.
//   CMYK, YCCK and other counts of components are refused, as libjpeg
//   refuses the conversion.
// - Blocks go through libjpeg's JDCT_ISLOW integer IDCT (CONST_BITS 13,
//   PASS1_BITS 2) as libjpeg-turbo's x86-64 SIMD code computes it.
// - A component sampled below the frame's maximum is upsampled as libjpeg
//   does by default: its "fancy" triangle filters for 2:1 ratios, sample
//   replication for other integer ratios.
// - A progressive file whose first coefficients are not all known to full
//   precision when the data ends (a truncated or corrupt file) goes through
//   libjpeg-turbo's inter-block smoothing: those coefficients, and with no
//   AC data the DC too, estimated from the 5 x 5 neighbourhood of DC values.
// - Corrupt or truncated data is read as libjpeg reads it: the end of the
//   file is an endless run of EOI markers, a marker inside entropy-coded data
//   feeds zero bits to the MCU in progress and leaves the rest of the restart
//   interval zero, a code longer than 16 bits decodes as 0, restart markers
//   out of order are resynchronised by jpeg_resync_to_restart's rules, and
//   in a sequential file, tables missing in slots 0 and 1 are the standard
//   ones of T.81 Annex K.
//
// - Arithmetic-coded data is decoded as libjpeg's jdarith.c decodes it
//   (T.81 Annex D, F.1.4.4, F.2.4 and G.1.3/G.2): a marker inside the data
//   feeds zero bytes to the end of the scan, and a magnitude that overflows
//   or a coefficient index past the band's end leaves the rest of the
//   restart interval as it stands. DAC conditioning values default to
//   L = 0, U = 1 and K = 5, and table slots run 0-15.
//
// Lossless (SOF3, SOF11), hierarchical (SOF5-SOF7, SOF13-SOF15) and 12-bit
// files are refused (return 2), as libjpeg-turbo refuses them.

#include <cstdint>
#include <cstring>
#include <exception>
#include <vector>

#include "decode.h"

namespace fmimg {
namespace {

struct Bad {};
[[noreturn]] void fail() { throw Bad(); }

// Zigzag index -> natural index, with 16 spare entries so that a corrupt
// run past coefficient 63 lands on 63 (libjpeg's jpeg_natural_order).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Table D.2: the probability estimation state machine, {Qe, NMPS,
// NLPS, SWITCH} for states 0-112, and libjpeg's state 113: a fixed
// estimate of 1/2 (T.851 Table 5), for sign and refinement bits.
struct ArithState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const ArithState kArithStates[114] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 2, 14, 0},    {0x1114, 3, 16, 0},    {0x080b, 4, 18, 0},
    {0x03d8, 5, 20, 0},    {0x01da, 6, 23, 0},    {0x00e5, 7, 25, 0},    {0x006f, 8, 28, 0},
    {0x0036, 9, 30, 0},    {0x001a, 10, 33, 0},   {0x000d, 11, 35, 0},   {0x0006, 12, 9, 0},
    {0x0003, 13, 10, 0},   {0x0001, 13, 12, 0},   {0x5a7f, 15, 15, 1},   {0x3f25, 16, 36, 0},
    {0x2cf2, 17, 38, 0},   {0x207c, 18, 39, 0},   {0x17b9, 19, 40, 0},   {0x1182, 20, 42, 0},
    {0x0cef, 21, 43, 0},   {0x09a1, 22, 45, 0},   {0x072f, 23, 46, 0},   {0x055c, 24, 48, 0},
    {0x0406, 25, 49, 0},   {0x0303, 26, 51, 0},   {0x0240, 27, 52, 0},   {0x01b1, 28, 54, 0},
    {0x0144, 29, 56, 0},   {0x00f5, 30, 57, 0},   {0x00b7, 31, 59, 0},   {0x008a, 32, 60, 0},
    {0x0068, 33, 62, 0},   {0x004e, 34, 63, 0},   {0x003b, 35, 32, 0},   {0x002c, 9, 33, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 38, 64, 0},   {0x3a0d, 39, 65, 0},   {0x2ef1, 40, 67, 0},
    {0x261f, 41, 68, 0},   {0x1f33, 42, 69, 0},   {0x19a8, 43, 70, 0},   {0x1518, 44, 72, 0},
    {0x1177, 45, 73, 0},   {0x0e74, 46, 74, 0},   {0x0bfb, 47, 75, 0},   {0x09f8, 48, 77, 0},
    {0x0861, 49, 78, 0},   {0x0706, 50, 79, 0},   {0x05cd, 51, 48, 0},   {0x04de, 52, 50, 0},
    {0x040f, 53, 50, 0},   {0x0363, 54, 51, 0},   {0x02d4, 55, 52, 0},   {0x025c, 56, 53, 0},
    {0x01f8, 57, 54, 0},   {0x01a4, 58, 55, 0},   {0x0160, 59, 56, 0},   {0x0125, 60, 57, 0},
    {0x00f6, 61, 58, 0},   {0x00cb, 62, 59, 0},   {0x00ab, 63, 61, 0},   {0x008f, 32, 61, 0},
    {0x5b12, 65, 65, 1},   {0x4d04, 66, 80, 0},   {0x412c, 67, 81, 0},   {0x37d8, 68, 82, 0},
    {0x2fe8, 69, 83, 0},   {0x293c, 70, 84, 0},   {0x2379, 71, 86, 0},   {0x1edf, 72, 87, 0},
    {0x1aa9, 73, 87, 0},   {0x174e, 74, 72, 0},   {0x1424, 75, 72, 0},   {0x119c, 76, 74, 0},
    {0x0f6b, 77, 74, 0},   {0x0d51, 78, 75, 0},   {0x0bb6, 79, 77, 0},   {0x0a40, 48, 77, 0},
    {0x5832, 81, 80, 1},   {0x4d1c, 82, 88, 0},   {0x438e, 83, 89, 0},   {0x3bdd, 84, 90, 0},
    {0x34ee, 85, 91, 0},   {0x2eae, 86, 92, 0},   {0x299a, 87, 93, 0},   {0x2516, 71, 86, 0},
    {0x5570, 89, 88, 1},   {0x4ca9, 90, 95, 0},   {0x44d9, 91, 96, 0},   {0x3e22, 92, 97, 0},
    {0x3824, 93, 99, 0},   {0x32b4, 94, 99, 0},   {0x2e17, 86, 93, 0},   {0x56a8, 96, 95, 1},
    {0x4f46, 97, 101, 0},  {0x47e5, 98, 102, 0},  {0x41cf, 99, 103, 0},  {0x3c3d, 100, 104, 0},
    {0x375e, 93, 99, 0},   {0x5231, 102, 105, 0}, {0x4c0f, 103, 106, 0}, {0x4639, 104, 107, 0},
    {0x415e, 99, 103, 0},  {0x5627, 106, 105, 1}, {0x50e7, 107, 108, 0}, {0x4b85, 103, 109, 0},
    {0x5597, 109, 110, 0}, {0x504f, 107, 111, 0}, {0x5a10, 111, 110, 1}, {0x5522, 109, 112, 0},
    {0x59eb, 111, 112, 1}, {0x5a1d, 113, 113, 0}};
constexpr uint8_t kFixedState = 113;

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// T.81 Annex K.3 tables: DC and AC, luminance (slot 0) and chrominance (slot 1).
const uint8_t kStdDcBits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                   {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdAcBits[2][17] = {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                   {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

HuffSpec standard_table(bool dc, int slot) {
  HuffSpec s;
  s.defined = true;
  memcpy(s.bits, dc ? kStdDcBits[slot] : kStdAcBits[slot], 17);
  if (dc) {
    for (int i = 0; i < 12; i++) s.vals[i] = (uint8_t)i;
  } else {
    memcpy(s.vals, kStdAcVals[slot], 162);
  }
  return s;
}

// A table ready for decoding (libjpeg's d_derived_tbl): canonical code
// bounds by length and an 8-bit lookahead.
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];  // (length << 8) | symbol for codes of at most 8 bits, else 0
};

void derive(const HuffSpec& s, bool dc, HuffTable* t) {
  int size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int n = s.bits[l];
    if (p + n > 256) fail();
    while (n--) size[p++] = l;
  }
  size[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) fail();  // the counts are not a prefix code
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (s.bits[l]) {
      t->valoffset[l] = p - (int32_t)code_of[p];
      p += s.bits[l];
      t->maxcode[l] = (int32_t)code_of[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;  // ends the bit-by-bit search at length 17
  memcpy(t->vals, s.vals, 256);
  memset(t->look, 0, sizeof t->look);
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 0; i < s.bits[l]; i++, p++) {
      int lookbits = (int)(code_of[p] << (8 - l));
      for (int n = 1 << (8 - l); n > 0; n--) t->look[lookbits++] = (uint16_t)((l << 8) | s.vals[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < nsym; i++)
      if (s.vals[i] > 15) fail();
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;    // blocks that hold image samples
  int dw = 0, dh = 0;    // samples (libjpeg's downsampled_width/height)
  int sbw = 0, sbh = 0;  // stored blocks: bw, bh rounded up to the MCU
  bool needed = false;
  bool latched = false;
  uint16_t q[64] = {};
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
  int coef_bits[64], prev_coef_bits[64];  // progression status (libjpeg's coef_bits)
  std::vector<int16_t> coef;  // stored blocks, when the output or a progression needs them
  int16_t* block(int by, int bx) { return &coef[((size_t)by * sbw + bx) * 64]; }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)(~0u << s) + 1 : r; }

// ---------- integer IDCT (libjpeg-turbo's jpeg_idct_islow, SIMD form) ----------

// libjpeg-turbo's x86-64 builds run JDCT_ISLOW in SSE2/AVX2
// (jidctint-avx2.asm): the arithmetic of jidctint.c (CONST_BITS 13,
// PASS1_BITS 2), held in 16-bit lanes where jidctint.c uses int. For
// coefficients that real encoders write the two agree; for corrupt ones
// this follows the SIMD lanes: the dequantised coefficients, the sums
// in0 +- in4, in7 + in3 and in5 + in1, and a block with no AC terms'
// DC << PASS1_BITS wrap at 16 bits, and each pass's outputs saturate, the
// second's to -128..127 before the +128 shift.

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int16_t wrap16(int64_t x) { return (int16_t)(uint16_t)(x & 0xFFFF); }

inline int16_t sat16(int64_t x) { return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x); }

// One 8-point pass on in[0..7] (16-bit lanes); out[k] = the 32-bit results
// before the descale, in the order of jidctint.c's outputs 0..7.
void idct_1d(const int16_t* in, int64_t* out) {
  const int64_t z2 = in[2], z3 = in[6];
  const int64_t tmp2 = z2 * F0_541196100 + z3 * (F0_541196100 - F1_847759065);
  const int64_t tmp3 = z2 * (F0_541196100 + F0_765366865) + z3 * F0_541196100;
  const int64_t tmp0 = (int64_t)wrap16(in[0] + in[4]) * (1 << kConstBits);
  const int64_t tmp1 = (int64_t)wrap16(in[0] - in[4]) * (1 << kConstBits);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int64_t i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
  const int64_t s73 = wrap16(i7 + i3), s51 = wrap16(i5 + i1);
  const int64_t z3o = s73 * (F1_175875602 - F1_961570560) + s51 * F1_175875602;
  const int64_t z4o = s73 * F1_175875602 + s51 * (F1_175875602 - F0_390180644);
  const int64_t o0 = i7 * (F0_298631336 - F0_899976223) + i1 * -F0_899976223 + z3o;
  const int64_t o3 = i7 * -F0_899976223 + i1 * (F1_501321110 - F0_899976223) + z4o;
  const int64_t o1 = i5 * (F2_053119869 - F2_562915447) + i3 * -F2_562915447 + z4o;
  const int64_t o2 = i5 * -F2_562915447 + i3 * (F3_072711026 - F2_562915447) + z3o;
  out[0] = tmp10 + o3;
  out[7] = tmp10 - o3;
  out[1] = tmp11 + o2;
  out[6] = tmp11 - o2;
  out[2] = tmp12 + o1;
  out[5] = tmp12 - o1;
  out[3] = tmp13 + o0;
  out[4] = tmp13 - o0;
}

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];  // pass 1's output, [row][column]
  bool ac_zero = true;
  for (int k = 8; k < 64; k++) ac_zero = ac_zero && in[k] == 0;
  if (ac_zero) {
    for (int c = 0; c < 8; c++) {
      const int16_t dc = wrap16((int64_t)wrap16((int64_t)in[c] * q[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t col[8];
      int64_t o[8];
      for (int r = 0; r < 8; r++) col[r] = wrap16((int64_t)in[r * 8 + c] * q[r * 8 + c]);
      idct_1d(col, o);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = sat16(descale(o[r], kConstBits - kPass1Bits));
    }
  }
  for (int r = 0; r < 8; r++) {
    int64_t o[8];
    idct_1d(ws + r * 8, o);
    uint8_t* op = out + (size_t)r * stride;
    for (int c = 0; c < 8; c++) {
      int64_t v = sat16(descale(o[c], kConstBits + kPass1Bits + 3));
      v = v < -128 ? -128 : v > 127 ? 127 : v;
      op[c] = (uint8_t)(v + 128);
    }
  }
}

// ---------- upsampling (libjpeg's jdsample.c defaults) ----------

// `in` holds a component's dw x dh samples (row stride `stride`); the result
// is (hx * dw) x (vy * dh). Rows above the first and below the last repeat
// them, as libjpeg's context rows do.
std::vector<uint8_t> upsample(const uint8_t* in, int stride, int dw, int dh, int hx, int vy) {
  const int ow = hx * dw, oh = vy * dh;
  std::vector<uint8_t> out((size_t)ow * oh);
  auto row = [&](int r) { return in + (size_t)(r < 0 ? 0 : r >= dh ? dh - 1 : r) * stride; };
  if (hx == 2 && vy == 1 && dw > 2) {
    for (int r = 0; r < dh; r++) {
      const uint8_t* ip = row(r);
      uint8_t* op = &out[(size_t)r * ow];
      op[0] = ip[0];
      op[1] = (uint8_t)((ip[0] * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        int v = ip[x] * 3;
        op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
      }
      op[2 * dw - 2] = (uint8_t)((ip[dw - 1] * 3 + ip[dw - 2] + 1) >> 2);
      op[2 * dw - 1] = ip[dw - 1];
    }
  } else if (hx == 1 && vy == 2) {
    for (int r = 0; r < dh; r++) {
      for (int v = 0; v < 2; v++) {
        const uint8_t* p0 = row(r);
        const uint8_t* p1 = row(v == 0 ? r - 1 : r + 1);
        const int bias = v == 0 ? 1 : 2;
        uint8_t* op = &out[(size_t)(2 * r + v) * ow];
        for (int x = 0; x < dw; x++) op[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
      }
    }
  } else if (hx == 2 && vy == 2 && dw > 2) {
    for (int r = 0; r < dh; r++) {
      for (int v = 0; v < 2; v++) {
        const uint8_t* p0 = row(r);
        const uint8_t* p1 = row(v == 0 ? r - 1 : r + 1);
        uint8_t* op = &out[(size_t)(2 * r + v) * ow];
        int thiscol = p0[0] * 3 + p1[0];
        int nextcol = p0[1] * 3 + p1[1];
        op[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
        op[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 2; x < dw; x++) {
          nextcol = p0[x] * 3 + p1[x];
          op[2 * x - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          op[2 * x - 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        op[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        op[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
      }
    }
  } else {  // replication: libjpeg's h2v1, h2v2 (narrow rows) and int upsamplers
    for (int r = 0; r < oh; r++) {
      const uint8_t* ip = row(r / vy);
      uint8_t* op = &out[(size_t)r * ow];
      for (int x = 0; x < ow; x++) op[x] = ip[x / hx];
    }
  }
  return out;
}

// ---------- the decoder ----------

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {
    memset(dc_L_, 0, sizeof dc_L_);
    memset(dc_U_, 1, sizeof dc_U_);
    memset(ac_K_, 5, sizeof ac_K_);
  }

  void run(std::vector<uint8_t>* gray, int* w, int* h);

 private:
  // The file, then libjpeg's stdio source at end of file: EOI markers.
  int byte_at(size_t p) const { return p < n_ ? d_[p] : ((p - n_) & 1) ? 0xD9 : 0xFF; }
  int get() { return byte_at(pos_++); }
  int get16() {
    int hi = get();
    return (hi << 8) | get();
  }
  int next_marker();
  void skip_segment();
  void sof(int marker);
  void dht();
  void dqt();
  void dri();
  void dac();
  void app(int marker);
  void sos();
  void setup_color();
  void derive_table(bool dc, int slot, HuffTable* t);
  void mcu_grid(Component** sc, int n, int* mcus_x, int* mcus_y) const;
  int16_t* mcu_block(Component* c, int n, int my, int mx, int yy, int xx, int16_t* scratch);
  void decode_scan(Component** comps, int ncomp, int ss, int se, int ah, int al,
                   const HuffTable* dct, const HuffTable* act);
  void skip_scan();
  void output(std::vector<uint8_t>* gray, int* w, int* h);
  bool smoothing_ok();
  void smooth_idct(Component& c, uint8_t* raw, int pw);

  // entropy-coded data (libjpeg's bit reader)
  void fill(int need);
  int peek_fill() {
    if (nbits_ < 8) fill(0);
    return nbits_;
  }
  int bits(int n) {
    if (nbits_ < n) fill(n);
    nbits_ -= n;
    return (int)((buf_ >> nbits_) & ((1u << n) - 1));
  }
  int huff(const HuffTable& t);
  void read_restart();
  void process_restart(Component** comps, int ncomp);
  void resync(int desired);

  // arithmetic-coded data (libjpeg's jdarith.c)
  int arith_bit(uint8_t* st);
  void arith_reset(Component** sc, int n, bool dc, bool ac);
  bool arith_dc(int i, int tbl, int* diff);
  bool arith_ac(int tbl, int16_t* blk, int ss, int se, int al);
  bool arith_ac_refine(int tbl, int16_t* blk, int ss, int se, int al);
  void decode_scan_arith(Component** sc, int n, int ss, int se, int ah, int al);

  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 2;  // past SOI
  int marker_ = 0;  // a marker read but not yet handled (libjpeg's unread_marker)

  bool seen_sof_ = false, progressive_ = false, arith_ = false, seen_sos_ = false,
       multi_scan_ = true;
  bool saw_jfif_ = false, saw_adobe_ = false, rgb_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0, ncomp_ = 0, maxh_ = 1, maxv_ = 1;
  Component comp_[4];
  HuffSpec dc_spec_[4], ac_spec_[4];
  bool qdefined_[4] = {};
  uint16_t qtab_[4][64] = {};
  int restart_interval_ = 0;

  uint64_t buf_ = 0;
  int nbits_ = 0;
  bool insufficient_ = false;
  int restarts_to_go_ = 0, next_restart_ = 0, eobrun_ = 0;
  int scans_ = 0;           // SOS markers read (libjpeg's input_scan_number)
  int last_good_row_ = 0;   // last iMCU row entered with data left (libjpeg's last_good_iMCU_row)
  int latch_[4][10], prev_latch_[4][10];

  // DAC conditioning (libjpeg's arith_dc_L, arith_dc_U, arith_ac_K, reset at SOI)
  uint8_t dc_L_[16], dc_U_[16], ac_K_[16];
  // The arithmetic decoder: registers C, A and CT (-16 before the first two
  // bytes, -1 after a bad code), the statistics bins of each table slot and
  // each scan component's DC context.
  int64_t c_ = 0, a_ = 0;
  int ct_ = 0;
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  uint8_t fixed_bin_ = kFixedState;
  int dc_context_[4] = {};
};

int Decoder::next_marker() {
  for (;;) {
    int c = get();
    while (c != 0xFF) c = get();
    do c = get(); while (c == 0xFF);
    if (c != 0) return c;
  }
}

void Decoder::skip_segment() {
  int len = get16() - 2;
  if (len > 0) pos_ += (size_t)len;
}

void Decoder::sof(int marker) {
  if (seen_sof_) fail();
  seen_sof_ = true;
  progressive_ = marker == 0xC2 || marker == 0xCA;
  arith_ = marker == 0xC9 || marker == 0xCA;
  int len = get16() - 2;
  int prec = get();
  height_ = get16();
  width_ = get16();
  ncomp_ = get();
  len -= 6;
  if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) fail();
  if (len != ncomp_ * 3) fail();
  if (prec != 8 || height_ > 65500 || width_ > 65500 || ncomp_ > 4) fail();
  for (int i = 0; i < ncomp_; i++) {
    Component& c = comp_[i];
    c.id = get();
    int s = get();
    c.h = s >> 4;
    c.v = s & 15;
    c.tq = get();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail();
    if (c.h > maxh_) maxh_ = c.h;
    if (c.v > maxv_) maxv_ = c.v;
  }
  for (int i = 0; i < ncomp_; i++) {
    Component& c = comp_[i];
    c.bw = (int)(((int64_t)width_ * c.h + 8 * maxh_ - 1) / (8 * maxh_));
    c.bh = (int)(((int64_t)height_ * c.v + 8 * maxv_ - 1) / (8 * maxv_));
    c.dw = (int)(((int64_t)width_ * c.h + maxh_ - 1) / maxh_);
    c.dh = (int)(((int64_t)height_ * c.v + maxv_ - 1) / maxv_);
    c.sbw = (c.bw + c.h - 1) / c.h * c.h;
    c.sbh = (c.bh + c.v - 1) / c.v * c.v;
  }
}

void Decoder::dht() {
  int len = get16() - 2;
  while (len > 16) {
    int index = get();
    HuffSpec s;
    s.defined = true;
    int count = 0;
    for (int i = 1; i <= 16; i++) {
      s.bits[i] = (uint8_t)get();
      count += s.bits[i];
    }
    len -= 17;
    if (count > 256 || count > len) fail();
    for (int i = 0; i < count; i++) s.vals[i] = (uint8_t)get();
    len -= count;
    bool ac = index & 0x10;
    if (ac) index -= 0x10;
    if (index < 0 || index >= 4) fail();
    (ac ? ac_spec_ : dc_spec_)[index] = s;
  }
  if (len != 0) fail();
}

void Decoder::dqt() {
  int len = get16() - 2;
  while (len > 0) {
    int n = get();
    int prec = n >> 4;
    n &= 15;
    if (n >= 4) fail();
    for (int i = 0; i < 64; i++) qtab_[n][kNatural[i]] = (uint16_t)(prec ? get16() : get());
    qdefined_[n] = true;
    len -= prec ? 129 : 65;
  }
  if (len != 0) fail();
}

// DAC (arithmetic conditioning): indices 0-15 set a DC table's L (low
// nibble) and U, 16-31 an AC table's K.
void Decoder::dac() {
  int len = get16() - 2;
  while (len > 0) {
    int index = get(), val = get();
    len -= 2;
    if (index >= 32) fail();
    if (index >= 16) {
      ac_K_[index - 16] = (uint8_t)val;
    } else {
      dc_L_[index] = (uint8_t)(val & 15);
      dc_U_[index] = (uint8_t)(val >> 4);
      if (dc_L_[index] > dc_U_[index]) fail();
    }
  }
  if (len != 0) fail();
}

void Decoder::dri() {
  if (get16() != 4) fail();
  restart_interval_ = get16();
}

void Decoder::app(int marker) {
  int len = get16() - 2;
  uint8_t b[14];
  int n = len >= 14 ? 14 : len > 0 ? len : 0;
  for (int i = 0; i < n; i++) b[i] = (uint8_t)get();
  if (marker == 0xE0 && n >= 14 && !memcmp(b, "JFIF\0", 5)) saw_jfif_ = true;
  if (marker == 0xEE && n >= 12 && !memcmp(b, "Adobe", 5)) {
    saw_adobe_ = true;
    adobe_transform_ = b[11];
  }
  if (len > n) pos_ += (size_t)(len - n);
}

// libjpeg's default_decompress_parms and jinit_color_deconverter for gray
// output: which components are needed, and whether the conversion exists.
void Decoder::setup_color() {
  if (ncomp_ == 1) {
    comp_[0].needed = true;
    return;
  }
  if (ncomp_ != 3) fail();  // CMYK, YCCK or unknown: no conversion to gray
  if (saw_jfif_) {
    rgb_ = false;
  } else if (saw_adobe_) {
    rgb_ = adobe_transform_ == 0;
  } else {
    rgb_ = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
  }
  for (int i = 0; i < 3; i++) comp_[i].needed = rgb_ || i == 0;
}

void Decoder::sos() {
  if (!seen_sof_) fail();
  int len = get16();
  int n = get();
  if (len != n * 2 + 6 || n < 1 || n > 4) fail();
  Component* sc[4];
  for (int i = 0; i < n; i++) {
    int id = get(), t = get();
    // libjpeg-turbo's lookup: the first component with this id whose index
    // is not below the scan position, and not one the scan already has.
    Component* found = nullptr;
    for (int k = i; k < ncomp_ && !found; k++)
      if (comp_[k].id == id) found = &comp_[k];
    if (!found) fail();
    for (int k = 0; k < i; k++)
      if (sc[k] == found) fail();
    found->dc_tbl = t >> 4;
    found->ac_tbl = t & 15;
    sc[i] = found;
  }
  int ss = get(), se = get(), a = get();
  int ah = a >> 4, al = a & 15;
  next_restart_ = 0;
  scans_++;
  if (!seen_sos_) {
    seen_sos_ = true;
    multi_scan_ = n < ncomp_ || progressive_;
    setup_color();
    for (int i = 0; i < ncomp_; i++) {
      Component& c = comp_[i];
      if (c.needed && (maxh_ % c.h || maxv_ % c.v)) fail();  // fractional upsampling
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1, c.prev_coef_bits[k] = 0;
      // A progressive file keeps every component: refinement scans read
      // the coefficients so far, and smoothing reads every scan's progress.
      if (c.needed || progressive_) c.coef.assign((size_t)c.sbw * c.sbh * 64, 0);
    }
  } else if (!multi_scan_) {
    fail();  // a second scan in a single-scan file (libjpeg: EOI expected)
  }
  for (int i = 0; i < n; i++) {
    Component* c = sc[i];
    if (c->latched) continue;
    if (c->tq >= 4 || !qdefined_[c->tq]) fail();
    memcpy(c->q, qtab_[c->tq], sizeof c->q);
    c->latched = true;
  }
  if (progressive_) {
    bool bad = false;
    if (ss == 0) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se > 63 || n != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail();
    // The progression status. jdphuff.c also keeps the previous scan's
    // for smoothing; jdarith.c does not, and needs none: its scans read to
    // their end, so smoothing reads every row with the current status.
    for (int i = 0; i < n; i++) {
      Component* c = sc[i];
      if (!arith_)
        for (int k = ss < 1 ? ss : 1; k <= (se > 9 ? se : 9); k++)
          c->prev_coef_bits[k] = scans_ > 1 ? c->coef_bits[k] : 0;
      for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
    }
  } else {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  int blocks = 0;
  for (int i = 0; i < n; i++) blocks += n == 1 ? 1 : sc[i]->h * sc[i]->v;
  if (blocks > 10) fail();
  if (arith_) {  // table slots 0-15 (4-bit fields), no tables to derive
    decode_scan_arith(sc, n, ss, se, ah, al);
    return;
  }
  HuffTable dct[4], act[4];
  for (int i = 0; i < n; i++) {
    Component* c = sc[i];
    if (!progressive_ || (ss == 0 && ah == 0)) derive_table(true, c->dc_tbl, &dct[i]);
    if (!progressive_ || ss != 0) derive_table(false, c->ac_tbl, &act[i]);
  }
  // A sequential scan of one component that the output does not use is
  // skipped whole: its bits affect no other scan.
  if (n == 1 && !sc[0]->needed && !progressive_) {
    skip_scan();
    return;
  }
  decode_scan(sc, n, ss, se, ah, al, dct, act);
}

void Decoder::derive_table(bool dc, int slot, HuffTable* t) {
  if (slot >= 4) fail();
  HuffSpec* spec = dc ? dc_spec_ : ac_spec_;
  if (!spec[slot].defined && slot < 2 && !progressive_) spec[slot] = standard_table(dc, slot);
  if (!spec[slot].defined) fail();
  derive(spec[slot], dc, t);
}

void Decoder::skip_scan() {
  for (;;) {
    int c = get();
    if (c != 0xFF) continue;
    do c = get(); while (c == 0xFF);
    if (c == 0 || (c >= 0xD0 && c <= 0xD7)) continue;
    marker_ = c;
    return;
  }
}

void Decoder::fill(int need) {
  while (nbits_ <= 56 && !marker_) {
    int c = get();
    if (c == 0xFF) {
      int c2;
      do c2 = get(); while (c2 == 0xFF);
      if (c2 != 0) {
        marker_ = c2;
        break;
      }
    }
    buf_ = (buf_ << 8) | (uint64_t)c;
    nbits_ += 8;
  }
  if (nbits_ < need) {  // past the segment's end: zero bits, as libjpeg feeds
    insufficient_ = true;
    buf_ <<= 57 - nbits_;
    nbits_ = 57;
  }
}

int Decoder::huff(const HuffTable& t) {
  int l;
  if (peek_fill() >= 8) {
    int e = t.look[(buf_ >> (nbits_ - 8)) & 0xFF];
    if (e) {
      nbits_ -= e >> 8;
      return e & 0xFF;
    }
    l = 9;
  } else {
    l = 1;
  }
  int32_t code = bits(l);
  while (code > t.maxcode[l]) {
    code = (code << 1) | bits(1);
    l++;
  }
  if (l > 16) return 0;  // libjpeg: "Corrupt JPEG data: bad Huffman code", value 0
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

void Decoder::resync(int desired) {
  int m = marker_;
  for (;;) {
    int action;
    if (m < 0xC0) {
      action = 2;
    } else if (m < 0xD0 || m > 0xD7) {
      action = 3;
    } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      marker_ = 0;
      return;
    }
    if (action == 3) return;
    m = marker_ = next_marker();
  }
}

// libjpeg's read_restart_marker.
void Decoder::read_restart() {
  if (!marker_) marker_ = next_marker();
  if (marker_ == 0xD0 + next_restart_) {
    marker_ = 0;
  } else {
    resync(next_restart_);
  }
  next_restart_ = (next_restart_ + 1) & 7;
}

void Decoder::process_restart(Component** comps, int ncomp) {
  nbits_ = 0;
  buf_ = 0;
  read_restart();
  for (int i = 0; i < ncomp; i++) comps[i]->last_dc = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  if (!marker_) insufficient_ = false;
}

// A scan of one component has one block an MCU; an interleaved scan the
// components' h x v blocks.
void Decoder::mcu_grid(Component** sc, int n, int* mcus_x, int* mcus_y) const {
  if (n == 1) {
    *mcus_x = sc[0]->bw;
    *mcus_y = sc[0]->bh;
  } else {
    *mcus_x = (width_ + 8 * maxh_ - 1) / (8 * maxh_);
    *mcus_y = (height_ + 8 * maxv_ - 1) / (8 * maxv_);
  }
}

// Block (yy, xx) of component c in MCU (my, mx): its stored block, or the
// zeroed scratch block when the component's coefficients are not kept.
int16_t* Decoder::mcu_block(Component* c, int n, int my, int mx, int yy, int xx,
                            int16_t* scratch) {
  if (c->coef.empty()) {
    memset(scratch, 0, 64 * sizeof(int16_t));
    return scratch;
  }
  return c->block(n == 1 ? my : my * c->v + yy, n == 1 ? mx : mx * c->h + xx);
}

void Decoder::decode_scan(Component** sc, int n, int ss, int se, int ah, int al,
                          const HuffTable* dct, const HuffTable* act) {
  for (int i = 0; i < n; i++) sc[i]->last_dc = 0;
  buf_ = 0;
  nbits_ = 0;
  insufficient_ = false;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;

  int mcus_x, mcus_y;
  mcu_grid(sc, n, &mcus_x, &mcus_y);
  int16_t scratch[64];
  const int p1 = 1 << al, m1 = -1 * (1 << al);

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (!insufficient_) last_good_row_ = n == 1 ? my / sc[0]->v : my;
      if (restart_interval_ && restarts_to_go_ == 0) process_restart(sc, n);
      const bool dc_refine = progressive_ && ss == 0 && ah != 0;
      if (!insufficient_ || dc_refine) {
        for (int i = 0; i < n; i++) {
          Component* c = sc[i];
          const int bh = n == 1 ? 1 : c->v, bwid = n == 1 ? 1 : c->h;
          for (int yy = 0; yy < bh; yy++) {
            for (int xx = 0; xx < bwid; xx++) {
              int16_t* blk = mcu_block(c, n, my, mx, yy, xx, scratch);
              if (!progressive_) {
                int s = huff(dct[i]);
                if (s) s = extend(bits(s), s);
                c->last_dc += s;
                blk[0] = (int16_t)c->last_dc;
                for (int k = 1; k < 64; k++) {
                  int rs = huff(act[i]);
                  int r = rs >> 4;
                  s = rs & 15;
                  if (s) {
                    k += r;
                    blk[kNatural[k]] = (int16_t)extend(bits(s), s);
                  } else {
                    if (r != 15) break;
                    k += 15;
                  }
                }
              } else if (ss == 0 && ah == 0) {  // DC, first scan
                int s = huff(dct[i]);
                if (s) s = extend(bits(s), s);
                int64_t dc = (int64_t)c->last_dc + s;
                if (dc > INT32_MAX || dc < INT32_MIN) fail();
                c->last_dc = (int)dc;
                blk[0] = (int16_t)(uint32_t)((uint32_t)c->last_dc << al);
              } else if (ss == 0) {  // DC, refinement: one bit a block
                if (bits(1)) blk[0] = (int16_t)(blk[0] | p1);
              } else if (ah == 0) {  // AC, first scan
                if (eobrun_ > 0) {
                  eobrun_--;
                } else {
                  for (int k = ss; k <= se; k++) {
                    int rs = huff(act[i]);
                    int r = rs >> 4, s = rs & 15;
                    if (s) {
                      k += r;
                      int v = extend(bits(s), s);
                      blk[kNatural[k]] = (int16_t)(uint32_t)((uint32_t)v << al);
                    } else if (r == 15) {
                      k += 15;
                    } else {
                      eobrun_ = 1 << r;
                      if (r) eobrun_ += bits(r);
                      eobrun_--;
                      break;
                    }
                  }
                }
              } else {  // AC, refinement
                int k = ss;
                if (eobrun_ == 0) {
                  for (; k <= se; k++) {
                    int rs = huff(act[i]);
                    int r = rs >> 4, s = rs & 15;
                    if (s) {
                      s = bits(1) ? p1 : m1;
                    } else if (r != 15) {
                      eobrun_ = 1 << r;
                      if (r) eobrun_ += bits(r);
                      break;
                    }
                    do {
                      int16_t* coef = blk + kNatural[k];
                      if (*coef != 0) {
                        if (bits(1) && (*coef & p1) == 0)
                          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                      } else if (--r < 0) {
                        break;
                      }
                      k++;
                    } while (k <= se);
                    if (s) blk[kNatural[k]] = (int16_t)s;
                  }
                }
                if (eobrun_ > 0) {
                  for (; k <= se; k++) {
                    int16_t* coef = blk + kNatural[k];
                    if (*coef != 0 && bits(1) && (*coef & p1) == 0)
                      *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                  }
                  eobrun_--;
                }
              }
            }
          }
        }
      }
      if (restart_interval_) restarts_to_go_--;
    }
  }
  nbits_ = 0;
  buf_ = 0;
}

// ---------- arithmetic decoding (T.81 Annex D, F.1.4.4, F.2.4, G.1.3, G.2) ----------

// One binary decision with statistics bin *st: libjpeg's arith_decode. The
// bin holds the state index (low 7 bits) and the MPS (bit 7). Bytes come in
// as libjpeg reads them: FF 00 is data FF, any other marker is latched and
// zero bytes follow it.
int Decoder::arith_bit(uint8_t* st) {
  while (a_ < 0x8000) {  // D.2.6: renormalisation and data input
    if (--ct_ < 0) {
      int data = 0;
      if (!marker_) {
        data = get();
        if (data == 0xFF) {
          do data = get(); while (data == 0xFF);
          if (data == 0) {
            data = 0xFF;
          } else {
            marker_ = data;
            data = 0;
          }
        }
      }
      c_ = (c_ << 8) | data;
      if ((ct_ += 8) < 0 && ++ct_ == 0) a_ = 0x8000;  // two initial bytes read
    }
    a_ <<= 1;
  }
  int sv = *st;
  const ArithState& e = kArithStates[sv & 0x7F];
  const int64_t qe = e.qe;
  const int nm = e.nmps, nl = (e.sw << 7) | e.nlps;
  int64_t temp = a_ - qe;  // D.2.4 and D.2.5: decode, then estimate
  a_ = temp;
  temp <<= ct_;
  if (c_ >= temp) {
    c_ -= temp;
    if (a_ < qe) {  // conditional exchange: the MPS
      a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nm);
    } else {
      a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (a_ < 0x8000) {
    if (a_ < qe) {  // conditional exchange: the LPS
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = (uint8_t)((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

// The start of a scan or of a restart interval: the bins of the tables the
// scan codes, the DC predictions and contexts, and C, A and CT.
void Decoder::arith_reset(Component** sc, int n, bool dc, bool ac) {
  for (int i = 0; i < n; i++) {
    if (dc) {
      memset(dc_stats_[sc[i]->dc_tbl], 0, sizeof dc_stats_[0]);
      sc[i]->last_dc = 0;
      dc_context_[i] = 0;
    }
    if (ac) memset(ac_stats_[sc[i]->ac_tbl], 0, sizeof ac_stats_[0]);
  }
  c_ = 0;
  a_ = 0;
  ct_ = -16;
}

// Figures F.19 and F.21-F.24: the DC difference of scan component i with
// table tbl, and its context for the next block. False for a magnitude
// that overflows (libjpeg's JWRN_ARITH_BAD_CODE).
bool Decoder::arith_dc(int i, int tbl, int* diff) {
  uint8_t* st = dc_stats_[tbl] + dc_context_[i];
  *diff = 0;
  if (arith_bit(st) == 0) {
    dc_context_[i] = 0;
    return true;
  }
  const int sign = arith_bit(st + 1);
  st += 2 + sign;
  int m = arith_bit(st);
  if (m) {
    st = dc_stats_[tbl] + 20;  // X1
    while (arith_bit(st)) {
      if ((m <<= 1) == 0x8000) return false;
      st++;
    }
  }
  if (m < ((1 << dc_L_[tbl]) >> 1))  // F.1.4.4.1.2: the next context
    dc_context_[i] = 0;
  else if (m > ((1 << dc_U_[tbl]) >> 1))
    dc_context_[i] = 12 + sign * 4;
  else
    dc_context_[i] = 4 + sign * 4;
  int v = m;
  st += 14;  // M bins
  while (m >>= 1)
    if (arith_bit(st)) v |= m;
  v += 1;
  *diff = sign ? -v : v;
  return true;
}

// Figure F.20 with F.21-F.24: AC coefficients ss..se of a block, first
// (or only) pass, scaled by 2^al. False past se or on a magnitude overflow.
bool Decoder::arith_ac(int tbl, int16_t* blk, int ss, int se, int al) {
  uint8_t* const bins = ac_stats_[tbl];
  for (int k = ss; k <= se; k++) {
    uint8_t* st = bins + 3 * (k - 1);
    if (arith_bit(st)) break;  // EOB
    while (arith_bit(st + 1) == 0) {
      st += 3;
      if (++k > se) return false;
    }
    const int sign = arith_bit(&fixed_bin_);
    st += 2;
    int m = arith_bit(st);
    if (m && arith_bit(st)) {
      m <<= 1;
      st = bins + (k <= ac_K_[tbl] ? 189 : 217);  // X2: low or high band
      while (arith_bit(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st++;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_bit(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    blk[kNatural[k]] = (int16_t)(uint32_t)((uint32_t)v << al);
  }
  return true;
}

// G.1.3.3: the AC refinement pass. Past EOBx, the last coefficient an
// earlier pass made nonzero, an EOB decision precedes each coefficient.
bool Decoder::arith_ac_refine(int tbl, int16_t* blk, int ss, int se, int al) {
  uint8_t* const bins = ac_stats_[tbl];
  const int p1 = 1 << al, m1 = -p1;
  int kex = se;
  while (kex > 0 && !blk[kNatural[kex]]) kex--;
  for (int k = ss; k <= se; k++) {
    uint8_t* st = bins + 3 * (k - 1);
    if (k > kex && arith_bit(st)) break;  // EOB
    for (;;) {
      int16_t* coef = blk + kNatural[k];
      if (*coef) {  // nonzero before: a correction bit
        if (arith_bit(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (arith_bit(st + 1)) {  // newly nonzero: its sign
        *coef = (int16_t)(arith_bit(&fixed_bin_) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) return false;
    }
  }
  return true;
}

// One arithmetic-coded scan. Unlike the Huffman decoder, every MCU is
// decoded (a marker only feeds zeros), so every iMCU row counts as good;
// after a bad code (CT = -1) the rest of the restart interval is left as it
// stands, except in a DC refinement scan, which has no bad codes.
void Decoder::decode_scan_arith(Component** sc, int n, int ss, int se, int ah, int al) {
  const bool dc_first = !progressive_ || (ss == 0 && ah == 0);
  const bool ac = !progressive_ || ss != 0;
  arith_reset(sc, n, dc_first, ac);
  restarts_to_go_ = restart_interval_;
  int mcus_x, mcus_y;
  mcu_grid(sc, n, &mcus_x, &mcus_y);
  int16_t scratch[64];
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      last_good_row_ = n == 1 ? my / sc[0]->v : my;
      if (restart_interval_) {
        if (restarts_to_go_ == 0) {
          read_restart();
          arith_reset(sc, n, dc_first, ac);
          restarts_to_go_ = restart_interval_;
        }
        restarts_to_go_--;
      }
      if (progressive_ && ss == 0 && ah != 0) {  // DC refinement: one bit a block
        for (int i = 0; i < n; i++) {
          Component* c = sc[i];
          const int bh = n == 1 ? 1 : c->v, bwid = n == 1 ? 1 : c->h;
          for (int yy = 0; yy < bh; yy++)
            for (int xx = 0; xx < bwid; xx++) {
              int16_t* blk = mcu_block(c, n, my, mx, yy, xx, scratch);
              if (arith_bit(&fixed_bin_)) blk[0] = (int16_t)(blk[0] | (1 << al));
            }
        }
        continue;
      }
      bool ok = ct_ != -1;
      for (int i = 0; i < n && ok; i++) {
        Component* c = sc[i];
        const int bh = n == 1 ? 1 : c->v, bwid = n == 1 ? 1 : c->h;
        for (int yy = 0; yy < bh && ok; yy++) {
          for (int xx = 0; xx < bwid && ok; xx++) {
            int16_t* blk = mcu_block(c, n, my, mx, yy, xx, scratch);
            if (dc_first) {
              int diff;
              ok = arith_dc(i, c->dc_tbl, &diff);
              if (!ok) break;
              c->last_dc = (c->last_dc + diff) & 0xFFFF;
              blk[0] = (int16_t)(uint32_t)((uint32_t)c->last_dc << al);
              if (progressive_) continue;
              ok = arith_ac(c->ac_tbl, blk, 1, 63, 0);
            } else if (ah == 0) {
              ok = arith_ac(c->ac_tbl, blk, ss, se, al);
            } else {
              ok = arith_ac_refine(c->ac_tbl, blk, ss, se, al);
            }
          }
        }
      }
      if (!ok) ct_ = -1;
    }
  }
}

// libjpeg-turbo's smoothing_ok: every component latched, with nonzero
// quantisers for the DC and the first 9 AC coefficients and a DC scan, and
// some of those AC coefficients not yet at full precision.
bool Decoder::smoothing_ok() {
  if (!progressive_) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (int ci = 0; ci < ncomp_; ci++) {
    Component& c = comp_[ci];
    if (!c.latched) return false;
    for (int k : kPos)
      if (c.q[k] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    latch_[ci][0] = c.coef_bits[0];
    for (int k = 1; k < 10; k++) {
      prev_latch_[ci][k] = scans_ > 1 ? c.prev_coef_bits[k] : -1;
      latch_[ci][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// libjpeg-turbo's decompress_smooth_data for one component: each block's
// DC and first 9 AC coefficients (natural order 0, 1, 8, 16, 9, 2, 3, 10,
// 17, 24) from the DC values of a 5 x 5 window, where the coefficient is
// still zero and not known to full precision, then the IDCT.
void Decoder::smooth_idct(Component& c, uint8_t* raw, int pw) {
  const int ci = (int)(&c - comp_);
  const int total_rows = (height_ + 8 * maxv_ - 1) / (8 * maxv_);
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
                Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
  int16_t ws[64];
  auto predict = [](int64_t q, int64_t num, int al, bool clamp) {
    int pred;
    if (num >= 0) {
      pred = (int)(((q << 7) + num) / (q << 8));
      if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = (int)(((q << 7) - num) / (q << 8));
      if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return (int16_t)pred;
  };
  for (int r = 0; r < total_rows; r++) {
    int block_rows = c.v;
    if (r == total_rows - 1) {
      block_rows = c.bh % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int* bits = r > last_good_row_ ? prev_latch_[ci] : latch_[ci];
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    for (int b = 0; b < block_rows; b++) {
      // libjpeg-turbo's choice of neighbour rows, which looks two block
      // rows away only within the iMCU row or from the third (or to the
      // last but one) iMCU row on, whatever the rows that exist.
      const int row = r * c.v + b;
      const int prev = b > 0 || r > 0 ? row - 1 : row;
      const int prev2 = b > 1 || r > 1 ? row - 2 : prev;
      const int next = b < block_rows - 1 || r < total_rows - 1 ? row + 1 : row;
      const int next2 = b < block_rows - 2 || r + 1 < total_rows - 1 ? row + 2 : next;
      const int rows5[5] = {prev2, prev, row, next, next2};
      auto dc = [&](int k, int col) { return (int)c.block(rows5[k], col)[0]; };
      int D[26];  // D[1..25]: DC01..DC25, five rows of five columns
      for (int k = 0; k < 5; k++)
        for (int j = 1; j <= 5; j++) D[k * 5 + j] = dc(k, 0);
      const int last_col = c.bw - 1;
      for (int bx = 0; bx <= last_col; bx++) {
        memcpy(ws, c.block(row, bx), sizeof ws);
        if (bx == 0 && bx < last_col)
          for (int k = 0; k < 5; k++) D[k * 5 + 4] = dc(k, bx + 1);
        if (bx + 1 < last_col)
          for (int k = 0; k < 5; k++) D[k * 5 + 5] = dc(k, bx + 2);
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {
          int64_t num = Q00 * (change_dc ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] -
                                            13 * D[9] + 3 * D[10] - 3 * D[11] + 38 * D[12] -
                                            38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
                                            13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25])
                                         : (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]));
          ws[1] = predict(Q01, num, al, true);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {
          int64_t num = Q00 * (change_dc ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] +
                                            13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16] -
                                            13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
                                            3 * D[22] + 3 * D[23] + 3 * D[24] + D[25])
                                         : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]));
          ws[8] = predict(Q10, num, al, true);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {
          int64_t num = Q00 * (change_dc ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                                            14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18] +
                                            2 * D[19] + D[23])
                                         : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]));
          ws[16] = predict(Q20, num, al, true);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {
          int64_t num = Q00 * (change_dc ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] +
                                            9 * D[19] + D[21] - D[25])
                                         : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] -
                                            D[20] + D[22] - D[24] + D[4] - D[6] + 10 * D[7] -
                                            10 * D[9]));
          ws[9] = predict(Q11, num, al, true);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {
          int64_t num = Q00 * (change_dc ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] -
                                            14 * D[13] + 7 * D[14] + D[15] + 2 * D[17] -
                                            5 * D[18] + 2 * D[19])
                                         : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]));
          ws[2] = predict(Q02, num, al, true);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)
            ws[3] = predict(Q03, Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]), al, true);
          if ((al = bits[7]) != 0 && ws[10] == 0)
            ws[10] = predict(Q12, Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]), al, true);
          if ((al = bits[8]) != 0 && ws[17] == 0)
            ws[17] = predict(Q21, Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]), al, true);
          if ((al = bits[9]) != 0 && ws[24] == 0)
            ws[24] = predict(Q30, Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]), al, true);
          int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] +
                               6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] +
                               42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16] +
                               6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21] -
                               6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
          ws[0] = predict(Q00, num, 0, false);
        }
        idct_islow(ws, c.q, raw + ((size_t)row * 8) * pw + bx * 8, pw);
        for (int k = 0; k < 5; k++)
          for (int j = 1; j <= 4; j++) D[k * 5 + j] = D[k * 5 + j + 1];
      }
    }
  }
}

void Decoder::output(std::vector<uint8_t>* gray, int* w, int* h) {
  std::vector<uint8_t> planes[3];
  const bool smooth = smoothing_ok();
  const int nout = rgb_ ? 3 : 1;
  for (int ci = 0; ci < nout; ci++) {
    Component& c = comp_[ci];
    const int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> raw((size_t)pw * ph);
    if (smooth) {
      smooth_idct(c, raw.data(), pw);
    } else {
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(c.block(by, bx), c.q, &raw[((size_t)by * 8) * pw + bx * 8], pw);
    }
    const int hx = maxh_ / c.h, vy = maxv_ / c.v;
    if (hx == 1 && vy == 1) {
      planes[ci].resize((size_t)width_ * height_);
      for (int y = 0; y < height_; y++)
        memcpy(&planes[ci][(size_t)y * width_], &raw[(size_t)y * pw], width_);
    } else {
      std::vector<uint8_t> up = upsample(raw.data(), pw, c.dw, c.dh, hx, vy);
      const int uw = hx * c.dw;
      planes[ci].resize((size_t)width_ * height_);
      for (int y = 0; y < height_; y++)
        memcpy(&planes[ci][(size_t)y * width_], &up[(size_t)y * uw], width_);
    }
  }
  if (rgb_) {
    // libjpeg's rgb_gray_convert: FIX(0.29900), FIX(0.58700), FIX(0.11400)
    // at 16 bits, ONE_HALF folded into the blue term.
    gray->resize((size_t)width_ * height_);
    for (size_t i = 0; i < gray->size(); i++)
      (*gray)[i] = (uint8_t)((19595 * planes[0][i] + 38470 * planes[1][i] +
                              7471 * planes[2][i] + 32768) >> 16);
  } else {
    *gray = std::move(planes[0]);
  }
  *w = width_;
  *h = height_;
}

void Decoder::run(std::vector<uint8_t>* gray, int* w, int* h) {
  for (;;) {
    int m = marker_ ? marker_ : next_marker();
    marker_ = 0;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
      sof(m);
    } else if (m == 0xC4) {
      dht();
    } else if (m == 0xDB) {
      dqt();
    } else if (m == 0xDD) {
      dri();
    } else if (m == 0xDA) {
      sos();
    } else if (m == 0xD9) {
      if (!seen_sos_) fail();  // no image
      break;
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // stray RSTn or TEM: no parameters
    } else if (m == 0xE0 || m == 0xEE) {
      app(m);
    } else if (m == 0xCC) {
      dac();
    } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
      skip_segment();  // other APPn, COM, DNL
    } else {
      fail();  // other SOFn (lossless, hierarchical), a second SOI, reserved markers
    }
  }
  output(gray, w, h);
}

}  // namespace

int decode_jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>* gray, int* w, int* h) {
  if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) return 2;
  try {
    Decoder dec(data, size);
    dec.run(gray, w, h);
  } catch (const Bad&) {
    return 2;
  } catch (const std::exception&) {  // an allocation a corrupt header asks for
    return 2;
  }
  return 0;
}

}  // namespace fmimg

// The arithmetic decoder's probability table, {Qe, NMPS, NLPS, SWITCH} a
// state, for a comparison with libjpeg's jpeg_aritab; returns the count.
extern "C" int fm_jpeg_arith_states(uint16_t* qe, uint8_t* nmps, uint8_t* nlps, uint8_t* sw) {
  const int n = (int)(sizeof fmimg::kArithStates / sizeof fmimg::kArithStates[0]);
  for (int i = 0; i < n; i++) {
    qe[i] = fmimg::kArithStates[i].qe;
    nmps[i] = fmimg::kArithStates[i].nmps;
    nlps[i] = fmimg::kArithStates[i].nlps;
    sw[i] = fmimg::kArithStates[i].sw;
  }
  return n;
}
