// fastmatch-tpu-torch image I/O: JPEG, PNG and PGM/PPM decoded straight to
// grayscale float32 in [0,1], and a bilinear resize.
//
// The decoders are the library's own (jpeg.cpp, png.cpp, with a hand-written
// inflate), so it builds with g++ and -lpthread alone; they give libjpeg's
// and libpng's 8-bit gray output for the transforms the C ABI has always
// asked of them. The PNM reader and the resize are unchanged from the JAX
// package's native/imageio.cpp.
//
// C ABI (ctypes-friendly); all functions return 0 on success, and
// fm_load_gray returns 1 when the file cannot be opened and 2 when it
// cannot be decoded.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>

#include "decode.h"

extern "C" {

struct FmImage {
  float* data;  // grayscale, row-major, [0,1]
  int w;
  int h;
};

static float* alloc_f(int n) { return (float*)malloc(sizeof(float) * n); }

// ---------- JPEG / PNG (whole file in memory) ----------

static int load_coded(FILE* f, bool jpeg, FmImage* out) {
  std::vector<uint8_t> bytes;
  uint8_t buf[65536];
  size_t got;
  while ((got = fread(buf, 1, sizeof buf, f)) > 0) bytes.insert(bytes.end(), buf, buf + got);
  std::vector<uint8_t> gray;
  int w = 0, h = 0;
  int rc = jpeg ? fmimg::decode_jpeg(bytes.data(), bytes.size(), &gray, &w, &h)
                : fmimg::decode_png(bytes.data(), bytes.size(), &gray, &w, &h);
  if (rc != 0) return rc;
  const size_t n = (size_t)w * h;
  out->data = (float*)malloc(sizeof(float) * n);
  if (!out->data) return 2;
  out->w = w;
  out->h = h;
  for (size_t i = 0; i < n; i++) out->data[i] = gray[i] * (1.0f / 255.0f);
  return 0;
}

// ---------- PGM / PPM (P5 / P6 binary) ----------

static int pnm_token(FILE* f, char* buf, int cap) {
  int c;
  do {
    c = fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = fgetc(f);
    }
  } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
  int i = 0;
  while (c != EOF && c > ' ' && i < cap - 1) {
    buf[i++] = (char)c;
    c = fgetc(f);
  }
  buf[i] = 0;
  return i > 0 ? 0 : 1;
}

static int load_pnm(FILE* f, FmImage* out) {
  char tok[64];
  if (pnm_token(f, tok, 64)) return 2;
  int chans;
  if (!strcmp(tok, "P5")) chans = 1;
  else if (!strcmp(tok, "P6")) chans = 3;
  else return 2;
  if (pnm_token(f, tok, 64)) return 2;
  int w = atoi(tok);
  if (pnm_token(f, tok, 64)) return 2;
  int h = atoi(tok);
  if (pnm_token(f, tok, 64)) return 2;
  int maxv = atoi(tok);
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 255) return 2;
  size_t n = (size_t)w * h * chans;
  unsigned char* raw = (unsigned char*)malloc(n);
  if (fread(raw, 1, n, f) != n) {
    free(raw);
    return 2;
  }
  out->data = alloc_f(w * h);
  out->w = w;
  out->h = h;
  float inv = 1.0f / maxv;
  for (int i = 0; i < w * h; i++) {
    if (chans == 1) {
      out->data[i] = raw[i] * inv;
    } else {
      const unsigned char* p = raw + 3 * (size_t)i;
      out->data[i] = (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]) * inv;
    }
  }
  free(raw);
  return 0;
}

// ---------- public API ----------

static const unsigned char kPngSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

int fm_load_gray(const char* path, float** data, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  unsigned char magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  FmImage img{nullptr, 0, 0};
  int rc = 2;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) rc = load_coded(f, true, &img);
  else if (got >= 8 && !memcmp(magic, kPngSignature, 8)) rc = load_coded(f, false, &img);
  else if (got >= 2 && magic[0] == 'P' && (magic[1] == '5' || magic[1] == '6'))
    rc = load_pnm(f, &img);
  fclose(f);
  if (rc == 0) {
    *data = img.data;
    *w = img.w;
    *h = img.h;
  } else if (img.data) {
    free(img.data);
  }
  return rc;
}

// Bilinear resize (separate so callers can batch-normalize sizes for the
// static-shape detector).
int fm_resize_bilinear(const float* src, int sw, int sh, float* dst, int dw, int dh) {
  if (!src || !dst || sw <= 0 || sh <= 0 || dw <= 0 || dh <= 0) return 1;
  const float sx = (float)sw / dw, sy = (float)sh / dh;
  for (int y = 0; y < dh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)fy;
    if (fy < 0) { fy = 0; y0 = 0; }
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)fx;
      if (fx < 0) { fx = 0; x0 = 0; }
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      const float* r0 = src + (size_t)y0 * sw;
      const float* r1 = src + (size_t)y1 * sw;
      dst[(size_t)y * dw + x] =
          (1 - wy) * ((1 - wx) * r0[x0] + wx * r0[x1]) +
          wy * ((1 - wx) * r1[x0] + wx * r1[x1]);
    }
  }
  return 0;
}

void fm_free(float* p) { free(p); }

}  // extern "C"
