// Baseline JPEG codec (see jpeg.h).  Section numbers refer to ITU-T T.81.
#include "jpeg.h"

#include <cmath>
#include <cstring>

namespace mxtpu_jpeg {
namespace {

// zigzag position -> natural (row-major) position; 16 extra entries so a
// run past the end of a corrupt block stays inside the block (T.81 A.3.6)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// Huffman tables (T.81 C, F.2.2.3)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint16_t look[1 << kLookBits];  // (length << 8) | value, 0 = slow path

  bool Build() {
    int code = 0, k = 0;
    memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          const int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] =
                static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      if (code > (1 << l)) return false;  // over-subscribed table
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded segment reader: byte stuffing (F.1.2.3), fill bytes, and
// zeros once a marker is reached, as the IJG decoder does.
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool marker = false;  // p points at the 0xFF of a marker

  BitReader(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}

  void Fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            p = q - 1;
            marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }
  uint32_t Peek(int n) {
    if (bits < n) Fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void Skip(int n) {
    buf <<= n;
    bits -= n;
  }
  int Receive(int s) {
    if (s == 0) return 0;
    const int v = static_cast<int>(Peek(s));
    Skip(s);
    return v;
  }
  int Decode(const Huffman& h) {
    if (bits < 16) Fill();
    const uint16_t e = h.look[buf >> (64 - kLookBits)];
    if (e >> 8) {
      Skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        Skip(l);
        return h.vals[(h.valptr[l] + code - h.mincode[l]) & 0xFF];
      }
    }
    Skip(16);  // no such code: corrupt data decodes as 0, like the IJG
    return 0;
  }
  // Restart (F.2.2.5 / E.2.4): drop the buffered bits and move past the
  // next RSTn marker.
  void Restart() {
    buf = 0;
    bits = 0;
    marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        return;
      }
      if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) break;  // not RST
      ++p;
    }
  }
};

inline int Extend(int v, int s) {  // F.2.2.1, HUFF_EXTEND
  return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// Inverse DCT: the IJG "islow" integer algorithm (Loeffler, Ligtenberg and
// Moschytz, 13-bit constants, 2 extra bits between passes), with its
// range limit, so that the samples equal libjpeg's.
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

// the intermediates are 64-bit, as libjpeg-turbo's JLONG (long) on LP64
// hosts: corrupt coefficients never wrap where libjpeg's would not
inline int64_t Descale(int64_t x, int n) {
  return (x + (static_cast<int64_t>(1) << (n - 1))) >> n;
}

// post-IDCT range limit: index (x & 1023) for an unbiased sample x
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;  // x in [-512, 511]
      int v = x + 128;
      t[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
};
const RangeLimit kRange;

void IdctIslow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
               int stride) {
  int32_t ws[64];  // the IJG workspace: int
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      const int32_t dc = in[0] * static_cast<int32_t>(q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = in[16] * static_cast<int64_t>(q[16]);
    int64_t z3 = in[48] * static_cast<int64_t>(q[48]);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * static_cast<int64_t>(q[0]);
    z3 = in[32] * static_cast<int64_t>(q[32]);
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * static_cast<int64_t>(q[56]);
    tmp1 = in[40] * static_cast<int64_t>(q[40]);
    tmp2 = in[24] * static_cast<int64_t>(q[24]);
    tmp3 = in[8] * static_cast<int64_t>(q[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int d = kConstBits - kPass1Bits;
    w[0] = static_cast<int32_t>(Descale(tmp10 + tmp3, d));
    w[56] = static_cast<int32_t>(Descale(tmp10 - tmp3, d));
    w[8] = static_cast<int32_t>(Descale(tmp11 + tmp2, d));
    w[48] = static_cast<int32_t>(Descale(tmp11 - tmp2, d));
    w[16] = static_cast<int32_t>(Descale(tmp12 + tmp1, d));
    w[40] = static_cast<int32_t>(Descale(tmp12 - tmp1, d));
    w[24] = static_cast<int32_t>(Descale(tmp13 + tmp0, d));
    w[32] = static_cast<int32_t>(Descale(tmp13 - tmp0, d));
  }
  const int d = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      const uint8_t v = kRange.t[Descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[Descale(tmp10 + tmp3, d) & 1023];
    o[7] = kRange.t[Descale(tmp10 - tmp3, d) & 1023];
    o[1] = kRange.t[Descale(tmp11 + tmp2, d) & 1023];
    o[6] = kRange.t[Descale(tmp11 - tmp2, d) & 1023];
    o[2] = kRange.t[Descale(tmp12 + tmp1, d) & 1023];
    o[5] = kRange.t[Descale(tmp12 - tmp1, d) & 1023];
    o[3] = kRange.t[Descale(tmp13 + tmp0, d) & 1023];
    o[4] = kRange.t[Descale(tmp13 - tmp0, d) & 1023];
  }
}

// ---------------------------------------------------------------------------
// Color conversion tables (the IJG fixed-point ones, 16 fraction bits)
// ---------------------------------------------------------------------------

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t Fix(double x) {
  return static_cast<int32_t>(x * (1 << kScaleBits) + 0.5);
}

struct YccToRgb {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccToRgb() {
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((Fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = static_cast<int>((Fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -Fix(0.71414) * x;
      cb_g[i] = -Fix(0.34414) * x + kOneHalf;
    }
  }
};
const YccToRgb kYcc;

inline uint8_t Clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;           // Huffman tables of the current scan
  int pred = 0;                 // DC predictor
  int plane_w = 0, plane_h = 0;  // decoded plane, padded to whole MCUs
  int dw = 0, dh = 0;            // downsampled size (the real samples)
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  std::string* err;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  Component comp[3];

  Decoder(const uint8_t* d, size_t n, std::string* e)
      : data(d), size(n), err(e) {}

  Status Fail(Status s, const char* msg) {
    if (err) *err = msg;
    return s;
  }
  int U16(size_t at) const { return (data[at] << 8) | data[at + 1]; }

  Status ParseHeaders(bool stop_at_frame) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8)
      return Fail(kCorrupt, "not a JPEG file (no SOI marker)");
    pos = 2;
    while (true) {
      while (pos < size && data[pos] != 0xFF) ++pos;  // skip garbage
      while (pos < size && data[pos] == 0xFF) ++pos;  // fill bytes
      if (pos >= size) return Fail(kCorrupt, "JPEG data ends before a scan");
      const int m = data[pos++];
      if (m == 0xD9) return Fail(kCorrupt, "JPEG file has no scan");
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (pos + 2 > size) return Fail(kCorrupt, "truncated JPEG marker");
      const int len = U16(pos);
      if (len < 2 || pos + len > size)
        return Fail(kCorrupt, "truncated JPEG marker segment");
      const size_t seg = pos + 2, seg_end = pos + len;
      pos = seg_end;
      switch (m) {
        case 0xC0:
        case 0xC1: {
          Status s = ParseFrame(seg, seg_end);
          if (s != kOk) return s;
          if (stop_at_frame) return kOk;
          break;
        }
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          return Fail(kUnsupported,
                      "progressive JPEG is not supported (baseline "
                      "sequential only)");
        case 0xC3:
        case 0xC5:
        case 0xC7:
        case 0xC9:
        case 0xCB:
        case 0xCD:
        case 0xCF:
          return Fail(kUnsupported,
                      "lossless, hierarchical or arithmetic-coded JPEG is "
                      "not supported (baseline sequential only)");
        case 0xC4: {
          Status s = ParseHuffman(seg, seg_end);
          if (s != kOk) return s;
          break;
        }
        case 0xDB: {
          Status s = ParseQuant(seg, seg_end);
          if (s != kOk) return s;
          break;
        }
        case 0xDD:
          if (len < 4) return Fail(kCorrupt, "bad DRI marker");
          restart_interval = U16(seg);
          break;
        case 0xE0:
          if (len >= 7 && memcmp(data + seg, "JFIF", 5) == 0) jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && memcmp(data + seg, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[seg + 11];
          }
          break;
        case 0xDA: {
          if (!frame) return Fail(kCorrupt, "JPEG scan before its frame");
          pos = seg - 2;  // the scan header; DecodeScan moves past its data
          return kOk;
        }
        default:
          break;  // APPn, COM, DNL, ...: skipped
      }
    }
  }

  Status ParseFrame(size_t at, size_t end) {
    if (frame) return Fail(kUnsupported, "JPEG with several frames");
    if (end - at < 6) return Fail(kCorrupt, "bad SOF marker");
    const int precision = data[at];
    if (precision != 8)
      return Fail(kUnsupported, "only 8-bit JPEG samples are supported");
    height = U16(at + 1);
    width = U16(at + 3);
    ncomp = data[at + 5];
    if (width <= 0 || height <= 0)
      return Fail(kUnsupported, "JPEG with no width or height (DNL)");
    if (ncomp != 1 && ncomp != 3)
      return Fail(kUnsupported,
                  "only 1- or 3-component JPEG files are supported");
    if (end - at < static_cast<size_t>(6 + 3 * ncomp))
      return Fail(kCorrupt, "bad SOF marker");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = data[at + 6 + 3 * i];
      c.h = data[at + 7 + 3 * i] >> 4;
      c.v = data[at + 7 + 3 * i] & 15;
      c.tq = data[at + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return Fail(kCorrupt, "bad JPEG sampling factors");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    if (ncomp == 3) {
      for (int i = 0; i < ncomp; ++i) {
        const int fh = hmax / comp[i].h, fv = vmax / comp[i].v;
        const bool ok = hmax % comp[i].h == 0 && vmax % comp[i].v == 0 &&
                        ((fh == 1 && fv == 1) || (fh == 2 && fv == 1) ||
                         (fh == 2 && fv == 2));
        if (!ok)
          return Fail(kUnsupported,
                      "JPEG chroma sampling other than 4:4:4, 4:2:2 or "
                      "4:2:0 is not supported");
      }
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.plane_w = mcux * c.h * 8;
      c.plane_h = mcuy * c.v * 8;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
    }
    frame = true;
    return kOk;
  }

  Status ParseHuffman(size_t at, size_t end) {
    while (at < end) {
      if (end - at < 17) return Fail(kCorrupt, "bad DHT marker");
      const int tc = data[at] >> 4, th = data[at] & 15;
      if (tc > 1 || th > 3) return Fail(kCorrupt, "bad DHT marker");
      Huffman& h = tc ? ac[th] : dc[th];
      int count = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        h.bits[l] = data[at + l];
        count += h.bits[l];
      }
      if (count > 256 || end - at < static_cast<size_t>(17 + count))
        return Fail(kCorrupt, "bad DHT marker");
      memcpy(h.vals, data + at + 17, count);
      if (!h.Build()) return Fail(kCorrupt, "bad Huffman table");
      at += 17 + count;
    }
    return kOk;
  }

  Status ParseQuant(size_t at, size_t end) {
    while (at < end) {
      const int pq = data[at] >> 4, tq = data[at] & 15;
      if (tq > 3 || pq > 1) return Fail(kCorrupt, "bad DQT marker");
      const size_t n = pq ? 128 : 64;
      if (end - at < 1 + n) return Fail(kCorrupt, "bad DQT marker");
      for (int k = 0; k < 64; ++k)
        quant[tq][kNatural[k]] = pq ? static_cast<uint16_t>(U16(at + 1 + 2 * k))
                                    : data[at + 1 + k];
      quant_defined[tq] = true;
      at += 1 + n;
    }
    return kOk;
  }

  void DecodeBlock(BitReader& br, Component& c, int16_t* coef) {
    memset(coef, 0, 64 * sizeof(int16_t));
    const int t = br.Decode(dc[c.td]);
    const int diff = t ? Extend(br.Receive(t), t) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(c.pred);
    const Huffman& h = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      const int rs = br.Decode(h);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(Extend(br.Receive(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // One scan: its header at pos, its entropy-coded data after it.
  Status DecodeScan() {
    const int len = U16(pos);
    const size_t hdr = pos + 2;
    const int ns = data[hdr];
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns)
      return Fail(kCorrupt, "bad SOS marker");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int id = data[hdr + 1 + 2 * i];
      int ci = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) ci = j;
      if (ci < 0) return Fail(kCorrupt, "SOS names an unknown component");
      sc[i] = &comp[ci];
      sc[i]->td = data[hdr + 2 + 2 * i] >> 4;
      sc[i]->ta = data[hdr + 2 + 2 * i] & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3 || !dc[sc[i]->td].defined ||
          !ac[sc[i]->ta].defined)
        return Fail(kCorrupt, "JPEG scan uses an undefined Huffman table");
      if (!quant_defined[sc[i]->tq])
        return Fail(kCorrupt, "JPEG component uses an undefined quant table");
      sc[i]->pred = 0;
      if (sc[i]->plane.empty())
        sc[i]->plane.assign(
            static_cast<size_t>(sc[i]->plane_w) * sc[i]->plane_h, 0);
    }
    const size_t spectral = hdr + 1 + 2 * ns;
    if (data[spectral] != 0 || data[spectral + 1] != 63 ||
        data[spectral + 2] != 0)
      return Fail(kUnsupported,
                  "progressive JPEG is not supported (baseline sequential "
                  "only)");
    BitReader br(data + pos + len, data + size);
    int16_t coef[64];
    int restarts_left = restart_interval;
    auto restart = [&]() {
      if (restart_interval == 0) return;
      if (restarts_left == 0) {
        br.Restart();
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        restarts_left = restart_interval;
      }
      --restarts_left;
    };
    if (ns == 1) {  // non-interleaved: the component's own block grid
      Component& c = *sc[0];
      const int bw = (c.dw + 7) / 8, bh = (c.dh + 7) / 8;
      for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
          restart();
          DecodeBlock(br, c, coef);
          IdctIslow(coef, quant[c.tq],
                    c.plane.data() + static_cast<size_t>(by * 8) * c.plane_w +
                        bx * 8,
                    c.plane_w);
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          restart();
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v) {
              for (int h = 0; h < c.h; ++h) {
                DecodeBlock(br, c, coef);
                const size_t y0 = static_cast<size_t>((my * c.v + v) * 8);
                const int x0 = (mx * c.h + h) * 8;
                IdctIslow(coef, quant[c.tq],
                          c.plane.data() + y0 * c.plane_w + x0, c.plane_w);
              }
            }
          }
        }
      }
    }
    // move to the marker after the entropy-coded data
    const uint8_t* p = br.p;
    const uint8_t* end = data + size;
    while (p + 1 < end &&
           !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
             !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      ++p;
    pos = static_cast<size_t>(p - data);
    return kOk;
  }

  // After a scan: on to the next scan (kOk, pos at its header), or the
  // end of the image (kCorrupt with no message).
  bool NextScan() {
    while (pos + 1 < size) {
      if (data[pos] != 0xFF) {
        ++pos;
        continue;
      }
      const int m = data[pos + 1];
      if (m == 0xFF) {
        ++pos;
        continue;
      }
      pos += 2;
      if (m == 0xD9) return false;
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (pos + 2 > size) return false;
      const int len = U16(pos);
      const size_t seg = pos + 2, seg_end = pos + len;
      if (len < 2 || seg_end > size) return false;
      if (m == 0xDA) return true;  // pos at the scan header
      if (m == 0xC4) {
        if (ParseHuffman(seg, seg_end) != kOk) return false;
      } else if (m == 0xDB) {
        if (ParseQuant(seg, seg_end) != kOk) return false;
      } else if (m == 0xDD && len >= 4) {
        restart_interval = U16(seg);
      }
      pos = seg_end;
    }
    return false;
  }

  bool IsRgb() const {  // the IJG colorspace guess for 3 components
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // One component at full resolution: a copy, or the IJG triangle filter
  // ("fancy" upsampling) over the real samples, edges replicated.
  void Upsample(const Component& c, std::vector<uint8_t>* full) const {
    full->resize(static_cast<size_t>(width) * height);
    const int fh = hmax / c.h, fv = vmax / c.v;
    const uint8_t* pl = c.plane.data();
    const int pw = c.plane_w;
    if (fh == 1 && fv == 1) {
      for (int y = 0; y < height; ++y)
        memcpy(full->data() + static_cast<size_t>(y) * width,
               pl + static_cast<size_t>(y) * pw, width);
      return;
    }
    std::vector<uint8_t> row(2 * static_cast<size_t>(c.dw) + 2);
    const bool fancy = c.dw > 2;
    for (int y = 0; y < height; ++y) {
      uint8_t* o = row.data();
      if (fv == 1) {  // h2v1
        const uint8_t* in = pl + static_cast<size_t>(y) * pw;
        if (!fancy) {
          for (int x = 0; x < c.dw; ++x) o[2 * x] = o[2 * x + 1] = in[x];
        } else {
          int v = in[0];
          *o++ = static_cast<uint8_t>(v);
          *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
          const uint8_t* ip = in + 1;
          for (int n = c.dw - 2; n > 0; --n, ++ip) {
            v = ip[0] * 3;
            *o++ = static_cast<uint8_t>((v + ip[-1] + 1) >> 2);
            *o++ = static_cast<uint8_t>((v + ip[1] + 2) >> 2);
          }
          v = ip[0];
          *o++ = static_cast<uint8_t>((v * 3 + ip[-1] + 1) >> 2);
          *o++ = static_cast<uint8_t>(v);
        }
      } else {  // h2v2
        const int r = y >> 1;
        int r1 = (y & 1) ? r + 1 : r - 1;
        if (r1 < 0) r1 = 0;
        if (r1 > c.dh - 1) r1 = c.dh - 1;
        const uint8_t* i0 = pl + static_cast<size_t>(r) * pw;
        const uint8_t* i1 = pl + static_cast<size_t>(r1) * pw;
        if (!fancy) {
          for (int x = 0; x < c.dw; ++x) o[2 * x] = o[2 * x + 1] = i0[x];
        } else {
          int this_sum = i0[0] * 3 + i1[0];
          int next_sum = i0[1] * 3 + i1[1];
          *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
          *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          int last_sum = this_sum;
          this_sum = next_sum;
          for (int x = 2; x < c.dw; ++x) {
            next_sum = i0[x] * 3 + i1[x];
            *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
            *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
          }
          *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        }
      }
      memcpy(full->data() + static_cast<size_t>(y) * width, row.data(),
             width);
    }
  }

  Status Run(int out_comps, std::vector<uint8_t>* out) {
    Status s = ParseHeaders(false);
    if (s != kOk) return s;
    bool any_scan = false;
    do {
      s = DecodeScan();
      if (s != kOk) return s;
      any_scan = true;
    } while (NextScan());
    if (!any_scan) return Fail(kCorrupt, "JPEG file has no scan");
    for (int i = 0; i < ncomp; ++i)
      if (comp[i].plane.empty())
        comp[i].plane.assign(
            static_cast<size_t>(comp[i].plane_w) * comp[i].plane_h, 0);
    const size_t npix = static_cast<size_t>(width) * height;
    out->resize(npix * out_comps);
    uint8_t* o = out->data();
    std::vector<uint8_t> c0, c1, c2;
    Upsample(comp[0], &c0);
    if (ncomp == 1 || out_comps == 1) {
      if (out_comps == 1) {
        memcpy(o, c0.data(), npix);
      } else {
        for (size_t i = 0; i < npix; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = c0[i];
      }
      return kOk;
    }
    Upsample(comp[1], &c1);
    Upsample(comp[2], &c2);
    if (IsRgb()) {
      for (size_t i = 0; i < npix; ++i) {
        o[3 * i] = c0[i];
        o[3 * i + 1] = c1[i];
        o[3 * i + 2] = c2[i];
      }
      return kOk;
    }
    for (size_t i = 0; i < npix; ++i) {
      const int y = c0[i], cb = c1[i], cr = c2[i];
      o[3 * i] = Clamp255(y + kYcc.cr_r[cr]);
      o[3 * i + 1] = Clamp255(
          y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> kScaleBits));
      o[3 * i + 2] = Clamp255(y + kYcc.cb_b[cb]);
    }
    return kOk;
  }
};

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// Annex K.1, natural order
const uint8_t kStdLuminanceQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChrominanceQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCode {
  uint16_t code[256];
  uint8_t len[256];
  HuffCode(const uint8_t* bits, const uint8_t* vals) {
    memset(len, 0, sizeof(len));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        len[vals[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t buf = 0;
  int bits = 0;
  explicit BitWriter(std::vector<uint8_t>* o) : out(o) {}
  void Put(uint32_t v, int n) {  // n <= 16
    buf = (buf << n) | (v & ((1u << n) - 1));
    bits += n;
    while (bits >= 8) {
      const uint8_t b = static_cast<uint8_t>(buf >> (bits - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0x00);  // byte stuffing
      bits -= 8;
    }
  }
  void Flush() {  // pad with 1-bits (F.1.2.3)
    if (bits > 0) Put(0x7F, 8 - bits);
    buf = 0;
  }
};

// The IJG quality scaling (jcparam.c), limited to baseline's 8 bits.
void ScaleQuant(const uint8_t* base, int quality, uint8_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[i] = static_cast<uint8_t>(t);
  }
}

struct Fdct {
  double c[8][8];  // c[u][x] = C(u)/2 * cos((2x+1) u pi / 16)
  Fdct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u == 0 ? std::sqrt(0.5) : 1.0) * 0.5 *
                  std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0);
  }
  // samples (level-shifted by the caller) -> coefficients, natural order
  void Forward(const double* in, double* out) const {
    double tmp[64];
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int x = 0; x < 8; ++x) s += c[u][x] * in[y * 8 + x];
        tmp[y * 8 + u] = s;
      }
    for (int v = 0; v < 8; ++v)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int y = 0; y < 8; ++y) s += c[v][y] * tmp[y * 8 + u];
        out[v * 8 + u] = s;
      }
  }
};
const Fdct kFdct;

void PutMarker(std::vector<uint8_t>* o, int m) {
  o->push_back(0xFF);
  o->push_back(static_cast<uint8_t>(m));
}
void PutU16(std::vector<uint8_t>* o, int v) {
  o->push_back(static_cast<uint8_t>(v >> 8));
  o->push_back(static_cast<uint8_t>(v & 0xFF));
}
void PutDht(std::vector<uint8_t>* o, int tc_th, const uint8_t* bits,
            const uint8_t* vals) {
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += bits[l];
  PutMarker(o, 0xC4);
  PutU16(o, 2 + 1 + 16 + n);
  o->push_back(static_cast<uint8_t>(tc_th));
  for (int l = 1; l <= 16; ++l) o->push_back(bits[l]);
  for (int i = 0; i < n; ++i) o->push_back(vals[i]);
}

int BitLength(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}

void EncodeBlock(BitWriter& bw, const double* samples, const uint8_t* q,
                 const HuffCode& dc, const HuffCode& ac, int* pred) {
  double coef[64];
  kFdct.Forward(samples, coef);
  int zz[64];
  for (int k = 0; k < 64; ++k) {
    const int n = kNatural[k];
    const double v = coef[n] / q[n];
    zz[k] = static_cast<int>(v < 0 ? -std::floor(-v + 0.5) : std::floor(v + 0.5));
  }
  const int diff = zz[0] - *pred;
  *pred = zz[0];
  int nb = BitLength(diff);
  bw.Put(dc.code[nb], dc.len[nb]);
  if (nb) bw.Put(diff < 0 ? diff - 1 : diff, nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = zz[k];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.Put(ac.code[0xF0], ac.len[0xF0]);
      run -= 16;
    }
    nb = BitLength(v);
    const int rs = (run << 4) | nb;
    bw.Put(ac.code[rs], ac.len[rs]);
    bw.Put(v < 0 ? v - 1 : v, nb);
    run = 0;
  }
  if (run > 0) bw.Put(ac.code[0x00], ac.len[0x00]);
}

}  // namespace

Status ReadInfo(const uint8_t* data, size_t size, int* width, int* height,
                int* comps, std::string* err) {
  Decoder d(data, size, err);
  Status s = d.ParseHeaders(true);
  if (s != kOk) return s;
  *width = d.width;
  *height = d.height;
  *comps = d.ncomp;
  return kOk;
}

Status Decode(const uint8_t* data, size_t size, int out_comps,
              std::vector<uint8_t>* out, int* width, int* height,
              std::string* err) {
  Decoder d(data, size, err);
  Status s = d.Run(out_comps == 1 ? 1 : 3, out);
  if (s != kOk) return s;
  *width = d.width;
  *height = d.height;
  return kOk;
}

Status Encode(const uint8_t* pixels, int width, int height, int comps,
              int quality, std::vector<uint8_t>* out, std::string* err) {
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535 ||
      (comps != 1 && comps != 3)) {
    if (err) *err = "JPEG encode needs 1 or 3 components and sides of 1-65535";
    return kUnsupported;
  }
  uint8_t ql[64], qc[64];
  ScaleQuant(kStdLuminanceQuant, quality, ql);
  ScaleQuant(kStdChrominanceQuant, quality, qc);
  out->clear();
  PutMarker(out, 0xD8);
  // JFIF APP0: version 1.01, no density units, 1:1
  const uint8_t app0[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  PutMarker(out, 0xE0);
  PutU16(out, 2 + sizeof(app0));
  out->insert(out->end(), app0, app0 + sizeof(app0));
  const int ntables = comps == 3 ? 2 : 1;
  for (int t = 0; t < ntables; ++t) {
    const uint8_t* q = t ? qc : ql;
    PutMarker(out, 0xDB);
    PutU16(out, 2 + 65);
    out->push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) out->push_back(q[kNatural[k]]);
  }
  PutMarker(out, 0xC0);
  PutU16(out, 8 + 3 * comps);
  out->push_back(8);
  PutU16(out, height);
  PutU16(out, width);
  out->push_back(static_cast<uint8_t>(comps));
  for (int c = 0; c < comps; ++c) {
    out->push_back(static_cast<uint8_t>(c + 1));
    out->push_back(comps == 3 && c == 0 ? 0x22 : 0x11);
    out->push_back(c == 0 ? 0 : 1);
  }
  PutDht(out, 0x00, kDcLumBits, kDcVals);
  PutDht(out, 0x10, kAcLumBits, kAcLumVals);
  if (comps == 3) {
    PutDht(out, 0x01, kDcChromBits, kDcVals);
    PutDht(out, 0x11, kAcChromBits, kAcChromVals);
  }
  PutMarker(out, 0xDA);
  PutU16(out, 6 + 2 * comps);
  out->push_back(static_cast<uint8_t>(comps));
  for (int c = 0; c < comps; ++c) {
    out->push_back(static_cast<uint8_t>(c + 1));
    out->push_back(c == 0 ? 0x00 : 0x11);
  }
  out->push_back(0);
  out->push_back(63);
  out->push_back(0);

  // planes padded to whole MCUs by edge replication; RGB -> YCbCr with
  // the IJG fixed-point tables, chroma 2x2-averaged with an alternating
  // rounding bias (jccolor.c, jcsample.c)
  const int mcu = comps == 3 ? 16 : 8;
  const int pw = (width + mcu - 1) / mcu * mcu, ph = (height + mcu - 1) / mcu * mcu;
  std::vector<uint8_t> yp(static_cast<size_t>(pw) * ph), cbp, crp;
  if (comps == 3) {
    cbp.resize(yp.size());
    crp.resize(yp.size());
  }
  for (int y = 0; y < ph; ++y) {
    const int sy = y < height ? y : height - 1;
    for (int x = 0; x < pw; ++x) {
      const int sx = x < width ? x : width - 1;
      const uint8_t* px = pixels + (static_cast<size_t>(sy) * width + sx) * comps;
      const size_t i = static_cast<size_t>(y) * pw + x;
      if (comps == 1) {
        yp[i] = px[0];
        continue;
      }
      const int32_t r = px[0], g = px[1], b = px[2];
      yp[i] = static_cast<uint8_t>(
          (Fix(0.29900) * r + Fix(0.58700) * g + Fix(0.11400) * b + kOneHalf) >>
          kScaleBits);
      const int32_t off = (128 << kScaleBits) + kOneHalf - 1;
      cbp[i] = static_cast<uint8_t>(
          (-Fix(0.16874) * r - Fix(0.33126) * g + Fix(0.5) * b + off) >> kScaleBits);
      crp[i] = static_cast<uint8_t>(
          (Fix(0.5) * r - Fix(0.41869) * g - Fix(0.08131) * b + off) >> kScaleBits);
    }
  }
  const int cw = pw / 2, ch = ph / 2;
  std::vector<uint8_t> cbs, crs;
  if (comps == 3) {
    cbs.resize(static_cast<size_t>(cw) * ch);
    crs.resize(cbs.size());
    for (int y = 0; y < ch; ++y) {
      int bias = 1;
      for (int x = 0; x < cw; ++x) {
        const size_t a = static_cast<size_t>(2 * y) * pw + 2 * x, b = a + pw;
        cbs[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
            (cbp[a] + cbp[a + 1] + cbp[b] + cbp[b + 1] + bias) >> 2);
        crs[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
            (crp[a] + crp[a + 1] + crp[b] + crp[b + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  const HuffCode dcl(kDcLumBits, kDcVals), acl(kAcLumBits, kAcLumVals);
  const HuffCode dcc(kDcChromBits, kDcVals), acc(kAcChromBits, kAcChromVals);
  BitWriter bw(out);
  int pred[3] = {0, 0, 0};
  double blk[64];
  auto load = [&](const std::vector<uint8_t>& plane, int stride, int x0,
                  int y0) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        blk[y * 8 + x] =
            plane[static_cast<size_t>(y0 + y) * stride + x0 + x] - 128.0;
  };
  for (int my = 0; my < ph / mcu; ++my) {
    for (int mx = 0; mx < pw / mcu; ++mx) {
      for (int v = 0; v < mcu / 8; ++v)
        for (int h = 0; h < mcu / 8; ++h) {
          load(yp, pw, mx * mcu + h * 8, my * mcu + v * 8);
          EncodeBlock(bw, blk, ql, dcl, acl, &pred[0]);
        }
      if (comps == 3) {
        load(cbs, cw, mx * 8, my * 8);
        EncodeBlock(bw, blk, qc, dcc, acc, &pred[1]);
        load(crs, cw, mx * 8, my * 8);
        EncodeBlock(bw, blk, qc, dcc, acc, &pred[2]);
      }
    }
  }
  bw.Flush();
  PutMarker(out, 0xD9);
  return kOk;
}

}  // namespace mxtpu_jpeg
