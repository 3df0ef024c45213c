// Baseline JPEG codec of the port's host IO library (recordio.cc).
//
// Written from the standard (ITU-T T.81): sequential DCT, Huffman coding,
// 8-bit samples, 1 or 3 components, sampling 4:4:4, 4:2:2 and 4:2:0,
// restart markers.  The decoder's arithmetic follows the IJG reference
// decoder at its defaults (the integer "islow" IDCT, triangle ("fancy")
// chroma upsampling, the fixed-point YCbCr->RGB tables), so its pixels
// are the ones libjpeg gives for the same file.  A progressive,
// arithmetic-coded, lossless or 12-bit file is refused with a message.
// The encoder writes baseline JFIF: 4:2:0 YCbCr (or one gray
// component), the Annex K tables scaled by the IJG quality formula.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace mxtpu_jpeg {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

// Frame size and component count (1 or 3) from the headers alone.
Status ReadInfo(const uint8_t* data, size_t size, int* width, int* height,
                int* comps, std::string* err);

// Decode into interleaved 8-bit samples: out_comps 3 gives RGB (a gray
// file replicated), 1 gives gray (the luma of a color file).
Status Decode(const uint8_t* data, size_t size, int out_comps,
              std::vector<uint8_t>* out, int* width, int* height,
              std::string* err);

// Encode interleaved samples (comps 3: RGB, comps 1: gray) at an IJG
// quality in [1, 100].
Status Encode(const uint8_t* pixels, int width, int height, int comps,
              int quality, std::vector<uint8_t>* out, std::string* err);

}  // namespace mxtpu_jpeg
