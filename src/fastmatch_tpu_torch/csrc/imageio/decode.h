// The image library's in-house decoders (no third-party headers).
//
// Each decoder takes a whole file in memory and writes its 8-bit grayscale
// plane (row-major, w * h bytes) to `gray`. It returns 0, or 2 when the
// file cannot be decoded; the codes are fm_load_gray's.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace fmimg {

// JPEG (ITU-T T.81, Huffman or arithmetic coding: baseline, extended and
// progressive) with libjpeg's JCS_GRAYSCALE output: the Y component of YCbCr and gray files,
// libjpeg's fixed-point mix of Adobe RGB files.
int decode_jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>* gray, int* w, int* h);

// PNG (non-interlaced) with libpng's strip_16, palette_to_rgb,
// expand_gray_1_2_4_to_8, tRNS_to_alpha, strip_alpha and
// rgb_to_gray_fixed(1, 29900, 58700), in libpng's order.
int decode_png(const uint8_t* data, size_t size, std::vector<uint8_t>* gray, int* w, int* h);

}  // namespace fmimg
