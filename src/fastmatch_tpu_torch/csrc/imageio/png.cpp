// PNG decoder with a hand-written inflate (RFC 1950/1951), to the 8-bit
// grayscale plane that libpng 1.6 gives for the transforms the image
// library has always set: strip_16, palette_to_rgb,
// expand_gray_1_2_4_to_8, tRNS_to_alpha, strip_alpha and
// rgb_to_gray_fixed(1, 29900, 58700), read row by row without
// png_set_interlace_handling.
//
// What that output is, in libpng's order of transforms:
// - gray below 8 bits is scaled by 255, 85 or 17; a palette index becomes
//   its entry (entries past the PLTE's count are black);
// - tRNS adds an alpha channel that strip_alpha does not take off, since
//   the library sets strip_alpha only for colour types with alpha: the
//   w bytes read of each (gray, alpha) row are the left half of the row's
//   pixels, each followed by its alpha (0 where the pixel is the tRNS
//   colour or the palette entry's alpha, else 255);
// - colour goes to gray with libpng's 15-bit coefficients 9797, 19234 and
//   13737 before the 16-bit samples are cut to their high byte: at 8 bits
//   the sum is truncated and gray pixels pass unchanged, at 16 bits it is
//   rounded. A gAMA or sRGB chunk makes libpng mix in linear light through
//   its gamma tables, which this file builds the way libpng does;
// - critical chunks must pass their CRC; ancillary ones that fail are
//   ignored; the IDAT chunks that inflate reads must pass theirs too.
//
// Adam7-interlaced files are refused (return 2): libpng, read this way,
// returns the passes' rows as image rows, not the image.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <vector>

#include "decode.h"

namespace fmimg {
namespace {

struct Bad {};
[[noreturn]] void fail() { throw Bad(); }

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

uint32_t crc32(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool ready = [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------- inflate ----------

// A canonical Huffman code: a 10-bit table for short codes, counts and
// sorted symbols for the rest (and for codes met with fewer bits at hand).
struct Code {
  static constexpr int kFast = 10;
  uint16_t fast[1 << kFast];  // (length << 9) | symbol, 0 if longer or invalid
  int16_t count[16];
  int16_t symbol[320];
};

enum BuildResult { kComplete, kIncomplete, kOversubscribed };

BuildResult build(Code* c, const uint8_t* lengths, int n, int* max_len) {
  memset(c->count, 0, sizeof c->count);
  for (int i = 0; i < n; i++) c->count[lengths[i]]++;
  c->count[0] = 0;
  int left = 1;
  *max_len = 0;
  for (int len = 1; len < 16; len++) {
    left <<= 1;
    left -= c->count[len];
    if (left < 0) return kOversubscribed;
    if (c->count[len]) *max_len = len;
  }
  int offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; len++) offs[len + 1] = offs[len] + c->count[len];
  for (int i = 0; i < n; i++)
    if (lengths[i]) c->symbol[offs[lengths[i]]++] = (int16_t)i;
  memset(c->fast, 0, sizeof c->fast);
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= Code::kFast; len++) {
    for (int i = 0; i < c->count[len]; i++, k++, code++) {
      uint32_t rev = 0;  // the code's bits in stream (LSB-first) order
      for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (uint32_t fill = rev; fill < (1u << Code::kFast); fill += 1u << len)
        c->fast[fill] = (uint16_t)((len << 9) | c->symbol[k]);
    }
    code <<= 1;
  }
  return left > 0 ? kIncomplete : kComplete;
}

// The zlib stream of consecutive IDAT chunks, inflated as zlib inflates it
// for libpng: `want` bytes for the rows, then on to the stream's end.
class Inflater {
 public:
  enum Status { kEnd, kDataError, kNoInput };

  Inflater(const std::vector<uint8_t>& in, size_t want) : in_(in), want_(want) {}

  Status run();

  std::vector<uint8_t> out;
  uint64_t bits_at_want = 0;  // bits consumed when the last row byte came out
  uint64_t bits_at_stop = 0;  // bits consumed (or needed) when run() returned
  bool past_want = false;     // output beyond the rows was begun before a data error

 private:
  bool have(int n) {  // n bits at hand, pulling bytes while there are any
    while (cnt_ < n) {
      if (pos_ >= in_.size()) return false;
      buf_ |= (uint64_t)in_[pos_++] << cnt_;
      cnt_ += 8;
    }
    return true;
  }
  uint32_t take(int n) {
    if (!have(n)) throw kNoInput;
    uint32_t v = (uint32_t)(buf_ & ((1ull << n) - 1));
    buf_ >>= n;
    cnt_ -= n;
    consumed_ += n;
    return v;
  }
  int decode(const Code& c, int max_len);
  void emit(uint8_t b) {
    if (out.size() == want_) past_want = true;
    out.push_back(b);
    if (out.size() == want_) bits_at_want = consumed_;
  }
  void trim();
  [[noreturn]] void data_error(int extra_bits) {
    bits_at_stop = consumed_ + extra_bits;
    throw kDataError;
  }

  const std::vector<uint8_t>& in_;
  size_t want_;
  size_t pos_ = 0;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  uint64_t consumed_ = 0;
  size_t dropped_ = 0;  // output bytes past the rows that were let go
};

int Inflater::decode(const Code& c, int max_len) {
  have(Code::kFast);
  uint16_t e = c.fast[buf_ & ((1u << Code::kFast) - 1)];
  if (e && (e >> 9) <= cnt_) {
    int len = e >> 9;
    buf_ >>= len;
    cnt_ -= len;
    consumed_ += len;
    return e & 511;
  }
  // Bit by bit (puff's decode): also the path of a code longer than the
  // bits at hand, which zlib resolves by pulling bytes one at a time.
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; len++) {
    if (!have(len)) throw kNoInput;
    code |= (int)((buf_ >> (len - 1)) & 1);
    int count = c.count[len];
    if (code - count < first) {
      buf_ >>= len;
      cnt_ -= len;
      consumed_ += len;
      return c.symbol[index + (code - first)];
    }
    if (len >= max_len) data_error(len);  // a code the incomplete set lacks
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  data_error(15);
}

void Inflater::trim() {
  // Past the rows only the last 32 KiB are needed, as a window.
  if (out.size() > want_ + (1u << 17)) {
    size_t cut = out.size() - want_ - (1u << 15);
    out.erase(out.begin() + want_, out.begin() + want_ + cut);
    dropped_ += cut;
  }
}

Inflater::Status Inflater::run() {
  static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                                        15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                                        67, 83, 99, 115, 131, 163, 195, 227, 258};
  static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                        2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
  static const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                                         17,   25,   33,   49,   65,   97,    129,   193,
                                         257,  385,  513,  769,  1025, 1537,  2049,  3073,
                                         4097, 6145, 8193, 12289, 16385, 24577};
  static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                         6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
  static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
  out.reserve(want_ < (1u << 26) ? want_ : (1u << 26));  // grows past that as data comes
  try {
    uint32_t cmf = take(8), flg = take(8);
    // zlib: method 8, the check, no preset dictionary; libpng: window <= 32K
    if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 || (flg & 32))
      data_error(0);
    uint32_t adler_a = 1, adler_b = 0;
    size_t adler_from = 0;
    auto adler_update = [&]() {
      // The check covers every output byte, dropped ones included: fold
      // in what is about to be let go.
      for (size_t i = adler_from; i < out.size(); i++) {
        adler_a = (adler_a + out[i]) % 65521;
        adler_b = (adler_b + adler_a) % 65521;
      }
      adler_from = out.size();
    };
    Code lit, dist;
    bool last = false;
    while (!last) {
      last = take(1);
      uint32_t type = take(2);
      if (type == 0) {
        int skip = cnt_ & 7;
        take(skip);
        uint32_t len = take(16), nlen = take(16);
        if (len != (~nlen & 0xFFFF)) data_error(0);
        for (uint32_t i = 0; i < len; i++) emit((uint8_t)take(8));
      } else if (type == 1 || type == 2) {
        int lit_max, dist_max;
        if (type == 1) {
          uint8_t l[288];
          for (int i = 0; i < 288; i++) l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
          build(&lit, l, 288, &lit_max);
          uint8_t d[30];
          for (int i = 0; i < 30; i++) d[i] = 5;
          build(&dist, d, 30, &dist_max);
        } else {
          int nlit = take(5) + 257, ndist = take(5) + 1, ncode = take(4) + 4;
          if (nlit > 286 || ndist > 30) data_error(0);
          uint8_t l[320] = {};
          for (int i = 0; i < ncode; i++) l[kOrder[i]] = (uint8_t)take(3);
          Code lens;
          int lens_max;
          if (build(&lens, l, 19, &lens_max) != kComplete) data_error(0);
          memset(l, 0, sizeof l);
          int i = 0;
          while (i < nlit + ndist) {
            int sym = decode(lens, lens_max);
            if (sym < 16) {
              l[i++] = (uint8_t)sym;
              continue;
            }
            int rep, val = 0;
            if (sym == 16) {
              if (i == 0) data_error(0);
              val = l[i - 1];
              rep = 3 + take(2);
            } else if (sym == 17) {
              rep = 3 + take(3);
            } else {
              rep = 11 + take(7);
            }
            if (i + rep > nlit + ndist) data_error(0);
            while (rep--) l[i++] = (uint8_t)val;
          }
          if (l[256] == 0) data_error(0);  // no end-of-block code
          BuildResult r = build(&lit, l, nlit, &lit_max);
          if (r == kOversubscribed || (r == kIncomplete && lit_max != 1)) data_error(0);
          r = build(&dist, l + nlit, ndist, &dist_max);
          if (r == kOversubscribed || (r == kIncomplete && dist_max != 1)) data_error(0);
        }
        for (;;) {
          int sym = decode(lit, lit_max);
          if (sym < 256) {
            emit((uint8_t)sym);
            continue;
          }
          if (sym == 256) break;
          sym -= 257;
          if (sym >= 29) data_error(0);
          int len = kLenBase[sym] + (int)take(kLenExtra[sym]);
          int dsym = decode(dist, dist_max);
          if (dsym >= 30) data_error(0);
          size_t d = kDistBase[dsym] + take(kDistExtra[dsym]);
          if (out.size() >= want_) past_want = true;
          if (d > out.size() + dropped_) data_error(0);
          for (int k = 0; k < len; k++) emit(out[out.size() - d]);
        }
      } else {
        data_error(0);
      }
      if (out.size() > want_ + (1u << 17)) {
        adler_update();
        trim();
        adler_from = out.size();
      }
    }
    adler_update();
    take(cnt_ & 7);
    uint32_t check = take(8) << 24;
    check |= take(8) << 16;
    check |= take(8) << 8;
    check |= take(8);
    if (check != ((adler_b << 16) | adler_a)) data_error(0);
    bits_at_stop = consumed_;
    return kEnd;
  } catch (Status s) {
    if (s == kNoInput) bits_at_stop = consumed_;
    return s;
  }
}

// ---------- libpng's gamma tables (pngrtran.c, png.c) ----------

inline bool gamma_significant(int64_t g) { return g < 95000 || g > 105000; }

int64_t reciprocal(int64_t a) {
  double r = std::floor(1e10 / (double)a + .5);
  return r <= 2147483647. && r >= -2147483648. ? (int64_t)r : 0;
}

int64_t product2(int64_t a, int64_t b) {
  double r = (double)a * 1e-5;
  r *= (double)b;
  r = std::floor(r + .5);
  return r <= 2147483647. && r >= -2147483648. ? (int64_t)r : 0;
}

std::vector<uint8_t> table8(int64_t g) {
  std::vector<uint8_t> t(256);
  for (int i = 0; i < 256; i++) {
    if (gamma_significant(g) && i > 0 && i < 255)
      t[i] = (uint8_t)std::floor(255 * std::pow(i / 255., (double)g * .00001) + .5);
    else
      t[i] = (uint8_t)i;
  }
  return t;
}

uint16_t gamma16_correct(unsigned v, int64_t g) {
  if (v > 0 && v < 65535)
    return (uint16_t)std::floor(65535 * std::pow((int)v / 65535., (double)g * .00001) + .5);
  return (uint16_t)v;
}

// Indexed [(v & 0xff) >> shift][v >> 8], flattened to [.. * 256 + ..].
std::vector<uint16_t> table16(unsigned shift, int64_t g) {
  const unsigned num = 1u << (8 - shift), max = (1u << (16 - shift)) - 1, half = 1u << (15 - shift);
  const double fmax = 1.0 / (double)((1 << (16 - shift)) - 1);
  std::vector<uint16_t> t(num * 256);
  for (unsigned i = 0; i < num; i++) {
    for (unsigned j = 0; j < 256; j++) {
      uint32_t ig = (j << (8 - shift)) + i;
      if (gamma_significant(g)) {
        t[i * 256 + j] = (uint16_t)std::floor(65535. * std::pow(ig * fmax, (double)g * .00001) + .5);
      } else {
        if (shift != 0) ig = (ig * 65535u + half) / max;
        t[i * 256 + j] = (uint16_t)ig;
      }
    }
  }
  return t;
}

std::vector<uint16_t> table16to8(unsigned shift, int64_t g) {
  const unsigned num = 1u << (8 - shift);
  const uint32_t max = (1u << (16 - shift)) - 1;
  std::vector<uint16_t> t(num * 256);
  uint32_t last = 0;
  for (unsigned i = 0; i < 255; i++) {
    uint16_t out = (uint16_t)(i * 257u);
    uint32_t bound = gamma16_correct(out + 128u, g);
    bound = (bound * max + 32768u) / 65535u + 1u;
    while (last < bound) {
      t[(last & (0xffu >> shift)) * 256 + (last >> (8 - shift))] = out;
      last++;
    }
  }
  while (last < (num << 8)) {
    t[(last & (0xffu >> shift)) * 256 + (last >> (8 - shift))] = 65535u;
    last++;
  }
  return t;
}

// png_set_rgb_to_gray_fixed(1, 29900, 58700): red and green scaled to 15
// bits without rounding, blue the remainder.
constexpr uint32_t kRc = 29900u * 32768u / 100000u, kGc = 58700u * 32768u / 100000u,
                   kBc = 32768u - kRc - kGc;

int decode_png_impl(const uint8_t* d, size_t n, std::vector<uint8_t>* gray, int* w, int* h) {
  size_t p = 8;
  bool have_ihdr = false, have_plte = false;
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = 0, interlace = 0;
  uint8_t palette[256][3] = {};
  // libpng's colorspace record, as far as it decides the gamma.
  int64_t gamma = 0;
  bool have_gamma = false, from_gama = false, from_srgb = false, have_intent = false,
       cs_invalid = false, have_sbit = false;
  // tRNS: the transparent gray or RGB sample, or the palette's alphas.
  bool have_trns = false;
  uint32_t num_palette = 0, trns_rgb[3] = {};
  uint8_t trns_alpha[256];
  memset(trns_alpha, 0xFF, sizeof trns_alpha);
  int sig_bit = 0;
  auto check_gamma = [&](int64_t g, int from) {
    if (have_gamma) {
      double r = std::floor((double)gamma * 100000. / (double)g + .5);
      if (!(r <= 2147483647. && r >= -2147483648.) || gamma_significant((int64_t)r))
        return from_srgb || from == 2 ? from == 2 : from == 1;
    }
    return true;
  };
  std::vector<uint8_t> idat;
  std::vector<size_t> chunk_start;  // each IDAT's offset in `idat`
  std::vector<bool> chunk_crc_ok;
  for (;;) {
    if (p + 8 > n) fail();
    uint32_t len = be32(d + p);
    const uint8_t* type = d + p + 4;
    if (len > 0x7FFFFFFFu) fail();
    for (int i = 0; i < 4; i++) {
      int c = type[i];
      if (c < 65 || c > 122 || (c > 90 && c < 97)) fail();
    }
    if (p + 12 + (size_t)len > n) fail();
    const uint8_t* data = d + p + 8;
    const bool crc_ok = crc32(type, 4 + (size_t)len) == be32(data + len);
    const bool critical = !(type[0] & 32);
    auto is = [&](const char* name) { return !memcmp(type, name, 4); };
    if (is("IHDR")) {
      if (have_ihdr || len != 13 || !crc_ok) fail();
      width = be32(data);
      height = be32(data + 4);
      depth = data[8];
      ctype = data[9];
      interlace = data[12];
      if (width == 0 || height == 0 || width > 1000000 || height > 1000000) fail();
      bool ok = (ctype == 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16)) ||
                (ctype == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
                ((ctype == 2 || ctype == 4 || ctype == 6) && (depth == 8 || depth == 16));
      if (!ok || data[10] != 0 || data[11] != 0 || interlace > 1) fail();
      have_ihdr = true;
    } else if (is("IDAT")) {
      if (!have_ihdr || (ctype == 3 && !have_plte)) fail();
      // The consecutive IDATs hold the stream; libpng reads no further.
      while (p + 8 <= n && !memcmp(d + p + 4, "IDAT", 4)) {
        uint32_t l = be32(d + p);
        if (l > 0x7FFFFFFFu || p + 12 + (size_t)l > n) break;
        chunk_start.push_back(idat.size());
        chunk_crc_ok.push_back(crc32(d + p + 4, 4 + (size_t)l) == be32(d + p + 8 + l));
        idat.insert(idat.end(), d + p + 8, d + p + 8 + l);
        p += 12 + (size_t)l;
      }
      break;
    } else if (critical) {
      if (!have_ihdr || !crc_ok) fail();
      if (is("PLTE")) {
        if (have_plte) fail();
        have_plte = true;
        if (ctype == 3) {
          if (len == 0 || len > 768 || len % 3) fail();
          uint32_t num = len / 3;
          if (num > (1u << depth)) num = 1u << depth;
          memcpy(palette, data, num * 3);
          num_palette = num;
        }
      } else {
        fail();  // IEND before IDAT, or an unknown critical chunk
      }
    } else {
      static const char* kKnown[] = {"bKGD", "cHRM", "eXIf", "gAMA", "hIST", "iCCP",
                                     "iTXt", "oFFs", "pCAL", "pHYs", "sBIT", "sCAL",
                                     "sPLT", "sRGB", "tEXt", "tIME", "tRNS", "zTXt"};
      bool known = false;
      for (const char* k : kKnown) known = known || is(k);
      if (known && !have_ihdr) fail();
      const bool in_place = !have_plte && crc_ok;
      if (is("gAMA") && in_place && len == 4) {
        uint32_t u = be32(data);
        int64_t g = u <= 0x7FFFFFFFu ? (int64_t)u : -1;
        if (g < 16 || g > 625000000 || from_gama) {
          cs_invalid = true;
        } else if (!cs_invalid && check_gamma(g, 1)) {
          gamma = g;
          have_gamma = from_gama = true;
        }
      } else if (is("sRGB") && in_place && len == 1 && !cs_invalid) {
        if (have_intent || data[0] >= 4) {
          cs_invalid = true;
        } else {
          gamma = 45455;
          have_gamma = have_intent = from_srgb = true;
        }
      } else if (is("tRNS") && crc_ok && !have_trns) {
        if (ctype == 0 && len == 2) {
          trns_rgb[0] = (uint32_t)data[0] << 8 | data[1];
          have_trns = true;
        } else if (ctype == 2 && len == 6) {
          for (int k = 0; k < 3; k++) trns_rgb[k] = (uint32_t)data[2 * k] << 8 | data[2 * k + 1];
          have_trns = true;
        } else if (ctype == 3 && have_plte && len > 0 && len <= num_palette) {
          memcpy(trns_alpha, data, len);
          have_trns = true;
        }
      } else if (is("sBIT") && in_place && !have_sbit && (ctype & 2)) {
        if (len == (ctype == 6 ? 4u : 3u)) {
          const int sd = ctype == 3 ? 8 : depth;
          bool valid = true;
          for (uint32_t i = 0; i < len; i++) valid = valid && data[i] != 0 && data[i] <= sd;
          if (valid) {
            have_sbit = true;
            sig_bit = data[0] > data[1] ? data[0] : data[1];
            if (data[2] > sig_bit) sig_bit = data[2];
          }
        }
      }
    }
    p += 12 + (size_t)len;
  }
  if (interlace) fail();  // see the file's header comment

  const int channels = ctype == 2 ? 3 : ctype == 4 ? 2 : ctype == 6 ? 4 : 1;
  const int pixel_bits = channels * depth;
  const size_t rowbytes = ((size_t)width * pixel_bits + 7) / 8;
  const int bpp = pixel_bits >= 8 ? pixel_bits / 8 : 1;
  const size_t want = (rowbytes + 1) * height;

  Inflater inf(idat, want);
  Inflater::Status st = inf.run();
  if (inf.out.size() < want) fail();  // not enough image data
  if (st == Inflater::kNoInput) fail();
  if (st == Inflater::kDataError && !inf.past_want) {
    // zlib goes on past the last row byte within libpng's read of at most
    // 8192 bytes of one chunk: an error seen there fails the row; one
    // seen later is libpng's benign "after the image" error.
    const uint64_t last_byte = (inf.bits_at_want + 7) / 8 - 1;
    size_t c = 0;
    while (c + 1 < chunk_start.size() && chunk_start[c + 1] <= last_byte) c++;
    const uint64_t piece_end = chunk_start[c] + ((last_byte - chunk_start[c]) / 8192 + 1) * 8192;
    const uint64_t chunk_end = c + 1 < chunk_start.size() ? chunk_start[c + 1] : idat.size();
    if ((inf.bits_at_stop + 7) / 8 <= (piece_end < chunk_end ? piece_end : chunk_end)) fail();
  }
  const uint64_t read_to = (inf.bits_at_stop + 7) / 8;  // bytes libpng handed to zlib
  for (size_t c = 0; c < chunk_start.size(); c++)
    if (chunk_start[c] < read_to || (chunk_start[c] == read_to && c == 0))
      if (!chunk_crc_ok[c]) fail();

  // rgb_to_gray in linear light when the file's gamma is significant.
  const bool color = ctype & 2;
  int64_t file_gamma = gamma, screen_gamma;
  if (file_gamma != 0) {
    screen_gamma = reciprocal(file_gamma);
  } else {
    file_gamma = screen_gamma = 100000;
  }
  const bool gamma_tables = color && (gamma_significant(file_gamma) || gamma_significant(screen_gamma));
  std::vector<uint8_t> g8_table, g8_to1, g8_from1;
  std::vector<uint16_t> g16_table, g16_to1, g16_from1;
  unsigned shift = 0;
  if (gamma_tables) {
    if (depth <= 8) {
      int64_t r2 = (int64_t)std::floor(1e15 / (double)file_gamma / (double)screen_gamma + .5);
      g8_table = table8(r2);
      g8_to1 = table8(reciprocal(file_gamma));
      g8_from1 = table8(reciprocal(screen_gamma));
    } else {
      shift = sig_bit > 0 && sig_bit < 16 ? 16 - sig_bit : 0;
      if (shift < 5) shift = 5;
      if (shift > 8) shift = 8;
      g16_table = table16to8(shift, product2(file_gamma, screen_gamma));
      g16_to1 = table16(shift, reciprocal(file_gamma));
      g16_from1 = table16(shift, reciprocal(screen_gamma));
    }
  }
  auto gray8 = [&](unsigned r, unsigned g, unsigned b) -> uint8_t {
    if (r == g && r == b) return (uint8_t)(gamma_tables ? g8_table[r] : r);
    if (!gamma_tables) return (uint8_t)((kRc * r + kGc * g + kBc * b) >> 15);
    return g8_from1[(kRc * g8_to1[r] + kGc * g8_to1[g] + kBc * g8_to1[b] + 16384) >> 15];
  };
  auto lookup16 = [&](const std::vector<uint16_t>& t, unsigned v) {
    return t[((v & 0xff) >> shift) * 256 + (v >> 8)];
  };
  auto gray16 = [&](unsigned r, unsigned g, unsigned b) -> uint8_t {
    unsigned v;
    if (!gamma_tables) {
      v = (kRc * r + kGc * g + kBc * b + 16384) >> 15;
    } else if (r == g && r == b) {
      v = lookup16(g16_table, r);
    } else {
      unsigned lin = (kRc * lookup16(g16_to1, r) + kGc * lookup16(g16_to1, g) +
                      kBc * lookup16(g16_to1, b) + 16384) >> 15;
      v = lookup16(g16_from1, lin & 0xFFFF);
    }
    return (uint8_t)(v >> 8);
  };

  // The transparent gray at 8 bits, as png_do_expand compares it.
  const uint32_t trns_gray = depth == 16 ? trns_rgb[0]
                             : depth == 8 ? trns_rgb[0] & 0xFF
                                          : (trns_rgb[0] & ((1u << depth) - 1)) * (255u / ((1u << depth) - 1));
  gray->assign((size_t)width * height, 0);
  std::vector<uint8_t> pix(width), alpha(have_trns ? width : 0);
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
  const uint8_t* src = inf.out.data();
  for (uint32_t y = 0; y < height; y++, src += rowbytes + 1) {
    const int filter = src[0];
    const uint8_t* raw = src + 1;
    if (filter > 4) fail();
    for (size_t i = 0; i < rowbytes; i++) {
      const int a = i >= (size_t)bpp ? cur[i - bpp] : 0, b = prev[i],
                c = i >= (size_t)bpp ? prev[i - bpp] : 0;
      int pred = 0;
      switch (filter) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int pa = b - c, pb = a - c, pc = pa + pb;
          pa = pa < 0 ? -pa : pa;
          pb = pb < 0 ? -pb : pb;
          pc = pc < 0 ? -pc : pc;
          pred = pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
          break;
        }
        default: break;
      }
      cur[i] = (uint8_t)(raw[i] + pred);
    }
    uint8_t* dst = pix.data();
    const uint8_t* s = cur.data();
    for (uint32_t x = 0; x < width; x++) {
      switch (ctype) {
        case 0:
          if (depth == 16) {
            dst[x] = s[2 * x];
            if (have_trns) alpha[x] = ((uint32_t)s[2 * x] << 8 | s[2 * x + 1]) == trns_gray ? 0 : 255;
          } else if (depth == 8) {
            dst[x] = s[x];
            if (have_trns) alpha[x] = s[x] == trns_gray ? 0 : 255;
          } else {
            const int per = 8 / depth, shift_bits = 8 - depth * (1 + (int)(x % per));
            const unsigned v = (s[x / per] >> shift_bits) & ((1u << depth) - 1);
            dst[x] = (uint8_t)(v * (255u / ((1u << depth) - 1)));
            if (have_trns) alpha[x] = dst[x] == trns_gray ? 0 : 255;
          }
          break;
        case 4:
          dst[x] = depth == 16 ? s[4 * x] : s[2 * x];
          break;
        case 3: {
          unsigned idx;
          if (depth == 8) {
            idx = s[x];
          } else {
            const int per = 8 / depth, shift_bits = 8 - depth * (1 + (int)(x % per));
            idx = (s[x / per] >> shift_bits) & ((1u << depth) - 1);
          }
          dst[x] = gray8(palette[idx][0], palette[idx][1], palette[idx][2]);
          if (have_trns) alpha[x] = trns_alpha[idx];
          break;
        }
        default: {  // RGB, RGBA
          if (depth == 8) {
            const uint8_t* q = s + (size_t)x * channels;
            dst[x] = gray8(q[0], q[1], q[2]);
            if (have_trns)
              alpha[x] = q[0] == (trns_rgb[0] & 0xFF) && q[1] == (trns_rgb[1] & 0xFF) &&
                                 q[2] == (trns_rgb[2] & 0xFF) ? 0 : 255;
          } else {
            const uint8_t* q = s + (size_t)x * channels * 2;
            const unsigned r = (q[0] << 8) | q[1], g = (q[2] << 8) | q[3], b = (q[4] << 8) | q[5];
            dst[x] = gray16(r, g, b);
            if (have_trns)
              alpha[x] = r == trns_rgb[0] && g == trns_rgb[1] && b == trns_rgb[2] ? 0 : 255;
          }
        }
      }
    }
    uint8_t* out_row = gray->data() + (size_t)y * width;
    if (have_trns) {
      for (uint32_t x = 0; x < width; x++) out_row[x] = x & 1 ? alpha[x / 2] : pix[x / 2];
    } else {
      memcpy(out_row, pix.data(), width);
    }
    prev.swap(cur);
  }
  *w = (int)width;
  *h = (int)height;
  return 0;
}

}  // namespace

int decode_png(const uint8_t* data, size_t size, std::vector<uint8_t>* gray, int* w, int* h) {
  if (size < 8) return 2;
  try {
    return decode_png_impl(data, size, gray, w, h);
  } catch (const Bad&) {
    return 2;
  } catch (const std::exception&) {  // an allocation a corrupt header asks for
    return 2;
  }
}

}  // namespace fmimg
