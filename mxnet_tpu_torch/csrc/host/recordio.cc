// Host IO library of the port: RecordIO container, threaded JPEG
// decode-and-augment into float batches, and JPEG encode for pack_img.
//
// The port's own copy of the JAX package's ``src/recordio.cc``: the
// RecordIO reader and writer (dmlc recordio: magic-delimited records
// with escape-splitting) and the decode-and-augment arithmetic (SplitMix
// seeding, bilinear resize, affine warp, crop, mirror, HSL jitter,
// normalisation) are kept line for line, so the batches are the same.
// The JPEG codec is the port's own baseline one (jpeg.cc), in place of
// libjpeg, which the CUDA host does not carry; it decodes to libjpeg's
// pixels.  Symbols are renamed MXTPUTorch*.
//
// Build: g++ -O3 -std=c++17 -fPIC -Wall -shared recordio.cc jpeg.cc
//        -o librecordio.so -lpthread

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include "jpeg.h"

namespace {

constexpr uint32_t kMagic = 0xced7230a;

inline uint32_t EncodeLRec(uint32_t cflag, uint32_t length) {
  return (cflag << 29u) | length;
}
inline uint32_t DecodeFlag(uint32_t rec) { return (rec >> 29u) & 7u; }
inline uint32_t DecodeLength(uint32_t rec) {
  return rec & ((1u << 29u) - 1u);
}

// ---------------------------------------------------------------------------
// RecordIO writer
// ---------------------------------------------------------------------------

struct RecordIOWriter {
  FILE* fp;
  explicit RecordIOWriter(const char* path) { fp = fopen(path, "wb"); }
  ~RecordIOWriter() {
    if (fp) fclose(fp);
  }

  bool WriteRecord(const char* data, size_t size) {
    if (!fp) return false;
    // split the payload at any embedded magic words, like dmlc recordio
    const uint32_t* u32 =
        reinterpret_cast<const uint32_t*>(data);
    size_t n_u32 = size / 4;
    std::vector<size_t> splits;  // indices (in u32 units) of magic words
    for (size_t i = 0; i < n_u32; ++i) {
      if (u32[i] == kMagic) splits.push_back(i);
    }
    size_t begin = 0;
    if (splits.empty()) {
      WriteChunk(0, data, size);
    } else {
      for (size_t k = 0; k <= splits.size(); ++k) {
        size_t end_bytes = (k < splits.size()) ? splits[k] * 4 : size;
        uint32_t cflag = (k == 0) ? 1u : (k == splits.size()) ? 3u : 2u;
        WriteChunk(cflag, data + begin, end_bytes - begin);
        begin = end_bytes + ((k < splits.size()) ? 4 : 0);
      }
    }
    return true;
  }

  void WriteChunk(uint32_t cflag, const char* data, size_t size) {
    uint32_t magic = kMagic;
    uint32_t lrec = EncodeLRec(cflag, static_cast<uint32_t>(size));
    fwrite(&magic, 4, 1, fp);
    fwrite(&lrec, 4, 1, fp);
    if (size) fwrite(data, 1, size, fp);
    size_t pad = (4 - (size & 3u)) & 3u;
    uint32_t zero = 0;
    if (pad) fwrite(&zero, 1, pad, fp);
  }

  long Tell() { return fp ? ftell(fp) : -1; }
};

// ---------------------------------------------------------------------------
// RecordIO reader
// ---------------------------------------------------------------------------

struct RecordIOReader {
  FILE* fp;
  std::vector<char> buf;
  explicit RecordIOReader(const char* path) { fp = fopen(path, "rb"); }
  ~RecordIOReader() {
    if (fp) fclose(fp);
  }

  // returns pointer+size valid until next call; nullptr at EOF
  const char* NextRecord(size_t* out_size) {
    buf.clear();
    uint32_t cflag = 0;
    bool in_split = false;
    while (true) {
      uint32_t magic, lrec;
      if (fread(&magic, 4, 1, fp) != 1) return nullptr;
      if (magic != kMagic) return nullptr;  // corrupt
      if (fread(&lrec, 4, 1, fp) != 1) return nullptr;
      cflag = DecodeFlag(lrec);
      uint32_t len = DecodeLength(lrec);
      size_t old = buf.size();
      if (in_split) {
        // re-insert the escaped magic between continuation chunks
        uint32_t m = kMagic;
        buf.resize(old + 4);
        memcpy(buf.data() + old, &m, 4);
        old += 4;
      }
      buf.resize(old + len);
      if (len && fread(buf.data() + old, 1, len, fp) != len) return nullptr;
      size_t pad = (4 - (len & 3u)) & 3u;
      if (pad) fseek(fp, static_cast<long>(pad), SEEK_CUR);
      if (cflag == 0 || cflag == 3) break;
      in_split = true;
    }
    *out_size = buf.size();
    return buf.data();
  }

  void Seek(long pos) {
    if (fp) fseek(fp, pos, SEEK_SET);
  }
  long Tell() { return fp ? ftell(fp) : -1; }
};

// ---------------------------------------------------------------------------
// JPEG decode (jpeg.cc) + bilinear resize
// ---------------------------------------------------------------------------

// the reason the last decode on this thread failed, and whether the file
// was one the baseline codec does not take (a progressive JPEG, say)
thread_local std::string g_decode_error;
thread_local bool g_decode_unsupported = false;

// decode into RGB uint8, returns true on success
bool DecodeJpeg(const uint8_t* data, size_t size, std::vector<uint8_t>* out,
                int* out_w, int* out_h) {
  g_decode_error.clear();
  mxtpu_jpeg::Status s =
      mxtpu_jpeg::Decode(data, size, 3, out, out_w, out_h, &g_decode_error);
  g_decode_unsupported = s == mxtpu_jpeg::kUnsupported;
  return s == mxtpu_jpeg::kOk;
}

// bilinear resize RGB u8 -> RGB u8
void ResizeBilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                    int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * sw + x0) * 3 + c];
        float v01 = src[(y0 * sw + x1) * 3 + c];
        float v10 = src[(y1 * sw + x0) * 3 + c];
        float v11 = src[(y1 * sw + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * dw + x) * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

struct AugParams {
  int out_h, out_w;
  int rand_crop;     // 1: random crop position, 0: center crop
  int rand_mirror;   // 1: mirror with p=0.5
  float mean_r, mean_g, mean_b;
  float std_r, std_g, std_b;
  float max_random_scale, min_random_scale;
  uint64_t seed;
  // -- extended augmenters (reference image_aug_default.cc:1-585) --
  float max_rotate_angle;   // degrees, uniform in [-a, a]
  float max_shear_ratio;    // uniform in [-s, s]
  float max_aspect_ratio;   // crop aspect jitter: 1 + U(-m, m)
  int min_crop_size;        // random crop side in [min, max] (0 = off)
  int max_crop_size;
  float random_h;           // HSL jitter: hue degrees (cv HLS scale 0-180)
  float random_s;           // saturation delta, 0-255 scale
  float random_l;           // lightness delta, 0-255 scale
};

inline uint64_t SplitMix(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

inline float UniformPM(uint64_t* s, float amp) {
  // uniform in [-amp, amp]
  float r = static_cast<float>(SplitMix(s) % 100000) / 100000.0f;
  return (2.0f * r - 1.0f) * amp;
}

// Affine warp (rotation + x-shear about the image center) with bilinear
// sampling, zero border — the reference's cv::warpAffine step
// (image_aug_default.cc rotation/shear branch).
void WarpAffine(const uint8_t* src, int w, int h, float angle_deg,
                float shear, std::vector<uint8_t>* dst_vec) {
  const float a = angle_deg * 3.14159265358979f / 180.0f;
  const float ca = std::cos(a), sa = std::sin(a);
  // forward map M = R(a) * Shear(b);  dst = M * src_centered
  // inverse: src = M^{-1} * dst_centered
  const float m00 = ca, m01 = ca * shear - sa;
  const float m10 = sa, m11 = sa * shear + ca;
  const float det = m00 * m11 - m01 * m10;
  const float i00 = m11 / det, i01 = -m01 / det;
  const float i10 = -m10 / det, i11 = m00 / det;
  const float cx = (w - 1) * 0.5f, cy = (h - 1) * 0.5f;
  dst_vec->assign(static_cast<size_t>(w) * h * 3, 0);
  uint8_t* dst = dst_vec->data();
  for (int y = 0; y < h; ++y) {
    const float dy = y - cy;
    for (int x = 0; x < w; ++x) {
      const float dx = x - cx;
      const float sx = i00 * dx + i01 * dy + cx;
      const float sy = i10 * dx + i11 * dy + cy;
      if (sx < 0 || sy < 0 || sx > w - 1 || sy > h - 1) continue;
      const int x0 = static_cast<int>(sx), y0 = static_cast<int>(sy);
      const int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
      const float wx = sx - x0, wy = sy - y0;
      for (int c = 0; c < 3; ++c) {
        const float v =
            src[(y0 * w + x0) * 3 + c] * (1 - wy) * (1 - wx) +
            src[(y0 * w + x1) * 3 + c] * (1 - wy) * wx +
            src[(y1 * w + x0) * 3 + c] * wy * (1 - wx) +
            src[(y1 * w + x1) * 3 + c] * wy * wx;
        dst[(y * w + x) * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// RGB [0,255] <-> HSL (h in [0,360), s,l in [0,1]) for the color jitter
// (reference converts to cv HLS and adds per-channel deltas).
inline void RgbToHsl(float r, float g, float b, float* hh, float* ss,
                     float* ll) {
  r /= 255.0f; g /= 255.0f; b /= 255.0f;
  const float mx = r > g ? (r > b ? r : b) : (g > b ? g : b);
  const float mn = r < g ? (r < b ? r : b) : (g < b ? g : b);
  const float l = 0.5f * (mx + mn);
  float hgt = 0.0f, sat = 0.0f;
  const float d = mx - mn;
  if (d > 1e-6f) {
    sat = l > 0.5f ? d / (2.0f - mx - mn) : d / (mx + mn);
    if (mx == r) hgt = 60.0f * ((g - b) / d) + (g < b ? 360.0f : 0.0f);
    else if (mx == g) hgt = 60.0f * ((b - r) / d) + 120.0f;
    else hgt = 60.0f * ((r - g) / d) + 240.0f;
    if (hgt >= 360.0f) hgt -= 360.0f;
  }
  *hh = hgt; *ss = sat; *ll = l;
}

inline float HueToRgb(float p, float q, float t) {
  if (t < 0) t += 1;
  if (t > 1) t -= 1;
  if (t < 1.0f / 6) return p + (q - p) * 6 * t;
  if (t < 0.5f) return q;
  if (t < 2.0f / 3) return p + (q - p) * (2.0f / 3 - t) * 6;
  return p;
}

inline void HslToRgb(float hh, float ss, float ll, float* r, float* g,
                     float* b) {
  if (ss <= 1e-6f) {
    *r = *g = *b = ll * 255.0f;
    return;
  }
  const float q = ll < 0.5f ? ll * (1 + ss) : ll + ss - ll * ss;
  const float p = 2 * ll - q;
  const float hn = hh / 360.0f;
  *r = HueToRgb(p, q, hn + 1.0f / 3) * 255.0f;
  *g = HueToRgb(p, q, hn) * 255.0f;
  *b = HueToRgb(p, q, hn - 1.0f / 3) * 255.0f;
}

inline float Clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// decode one image, affine(rotate+shear), resize-with-scale,
// aspect/size-jittered crop, mirror, HSL jitter, normalize into
// out[3, out_h, out_w] (NCHW float32 like the reference iterator)
bool DecodeAugmentOne(const uint8_t* jpeg, size_t size,
                      const AugParams& p, uint64_t rng_seed, float* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!DecodeJpeg(jpeg, size, &rgb, &w, &h)) return false;
  uint64_t s = rng_seed;

  // affine: rotation + shear about the center (image_aug_default.cc)
  if (p.max_rotate_angle > 0 || p.max_shear_ratio > 0) {
    const float angle = UniformPM(&s, p.max_rotate_angle);
    const float shear = UniformPM(&s, p.max_shear_ratio);
    std::vector<uint8_t> warped;
    WarpAffine(rgb.data(), w, h, angle, shear, &warped);
    rgb.swap(warped);
  }

  // scale shorter side to out * random_scale, keep aspect
  float scale = 1.0f;
  if (p.max_random_scale > p.min_random_scale) {
    float r = static_cast<float>(SplitMix(&s) % 10000) / 10000.0f;
    scale = p.min_random_scale +
            r * (p.max_random_scale - p.min_random_scale);
  } else {
    scale = p.max_random_scale > 0 ? p.max_random_scale : 1.0f;
  }
  int short_side = w < h ? w : h;
  int target_short =
      static_cast<int>(scale * (p.out_h > p.out_w ? p.out_h : p.out_w));
  if (target_short < p.out_h) target_short = p.out_h;
  // size-jittered crops happen at crop resolution, then shrink to out —
  // keep the resized image big enough for the largest crop (only when
  // the jitter is actually enabled: both bounds set)
  if (p.min_crop_size > 0 && p.max_crop_size > target_short)
    target_short = p.max_crop_size;
  float rs = static_cast<float>(target_short) / short_side;
  int rw = static_cast<int>(w * rs + 0.5f), rh = static_cast<int>(h * rs + 0.5f);
  if (rw < p.out_w) rw = p.out_w;
  if (rh < p.out_h) rh = p.out_h;
  std::vector<uint8_t> resized(static_cast<size_t>(rw) * rh * 3);
  ResizeBilinear(rgb.data(), w, h, resized.data(), rw, rh);

  // crop rect: base size from [min,max]_crop_size (or out size), aspect
  // jittered by 1+U(-m,m) (image_aug_default.cc random crop branch);
  // the rect is then resized to (out_h, out_w) during the write loop.
  float cw = static_cast<float>(p.out_w), ch = static_cast<float>(p.out_h);
  if (p.max_crop_size > 0 && p.min_crop_size > 0) {
    const int span = p.max_crop_size - p.min_crop_size;
    const int base = p.min_crop_size +
        (span > 0 ? static_cast<int>(SplitMix(&s) % (span + 1)) : 0);
    cw = ch = static_cast<float>(base);
  }
  if (p.max_aspect_ratio > 0) {
    const float ratio = 1.0f + UniformPM(&s, p.max_aspect_ratio);
    const float sq = std::sqrt(ratio > 0.05f ? ratio : 0.05f);
    cw *= sq;
    ch /= sq;
  }
  if (cw > rw) cw = static_cast<float>(rw);
  if (ch > rh) ch = static_cast<float>(rh);
  const int max_x = rw - static_cast<int>(cw);
  const int max_y = rh - static_cast<int>(ch);
  int cx = max_x / 2, cy = max_y / 2;
  if (p.rand_crop) {
    cx = max_x > 0 ? static_cast<int>(SplitMix(&s) % (max_x + 1)) : 0;
    cy = max_y > 0 ? static_cast<int>(SplitMix(&s) % (max_y + 1)) : 0;
  }
  bool mirror = p.rand_mirror && (SplitMix(&s) & 1);

  // per-image HSL deltas (reference adds uniform deltas in cv HLS space:
  // h on the 0-180 scale => *2 to degrees, s/l on 0-255 => /255)
  const bool do_hsl = p.random_h > 0 || p.random_s > 0 || p.random_l > 0;
  float dh = 0, ds = 0, dl = 0;
  if (do_hsl) {
    dh = UniformPM(&s, p.random_h) * 2.0f;
    ds = UniformPM(&s, p.random_s) / 255.0f;
    dl = UniformPM(&s, p.random_l) / 255.0f;
  }

  const float mean[3] = {p.mean_r, p.mean_g, p.mean_b};
  const float stdv[3] = {p.std_r > 0 ? p.std_r : 1.0f,
                         p.std_g > 0 ? p.std_g : 1.0f,
                         p.std_b > 0 ? p.std_b : 1.0f};
  const float sx_step = cw / p.out_w, sy_step = ch / p.out_h;
  if (sx_step == 1.0f && sy_step == 1.0f && !do_hsl) {
    // degenerate crop (the pre-extension default): direct indexed copy,
    // no bilinear taps on the decode hot path
    for (int c = 0; c < 3; ++c) {
      for (int y = 0; y < p.out_h; ++y) {
        for (int x = 0; x < p.out_w; ++x) {
          const int xo = mirror ? (p.out_w - 1 - x) : x;
          const float v = resized[((cy + y) * rw + (cx + xo)) * 3 + c];
          out[(static_cast<size_t>(c) * p.out_h + y) * p.out_w + x] =
              (v - mean[c]) / stdv[c];
        }
      }
    }
    return true;
  }
  for (int y = 0; y < p.out_h; ++y) {
    const float fy = Clampf(cy + (y + 0.5f) * sy_step - 0.5f, 0,
                            static_cast<float>(rh - 1));
    const int y0 = static_cast<int>(fy);
    const int y1 = y0 + 1 < rh ? y0 + 1 : rh - 1;
    const float wy = fy - y0;
    for (int x = 0; x < p.out_w; ++x) {
      const int xo = mirror ? (p.out_w - 1 - x) : x;
      const float fx = Clampf(cx + (xo + 0.5f) * sx_step - 0.5f, 0,
                              static_cast<float>(rw - 1));
      const int x0 = static_cast<int>(fx);
      const int x1 = x0 + 1 < rw ? x0 + 1 : rw - 1;
      const float wx = fx - x0;
      float px[3];
      for (int c = 0; c < 3; ++c) {
        px[c] = resized[(y0 * rw + x0) * 3 + c] * (1 - wy) * (1 - wx) +
                resized[(y0 * rw + x1) * 3 + c] * (1 - wy) * wx +
                resized[(y1 * rw + x0) * 3 + c] * wy * (1 - wx) +
                resized[(y1 * rw + x1) * 3 + c] * wy * wx;
      }
      if (do_hsl) {
        float hh, ss2, ll;
        RgbToHsl(px[0], px[1], px[2], &hh, &ss2, &ll);
        hh += dh;
        if (hh < 0) hh += 360.0f;
        if (hh >= 360.0f) hh -= 360.0f;
        ss2 = Clampf(ss2 + ds, 0.0f, 1.0f);
        ll = Clampf(ll + dl, 0.0f, 1.0f);
        HslToRgb(hh, ss2, ll, &px[0], &px[1], &px[2]);
        for (int c = 0; c < 3; ++c) px[c] = Clampf(px[c], 0.0f, 255.0f);
      }
      for (int c = 0; c < 3; ++c) {
        out[(static_cast<size_t>(c) * p.out_h + y) * p.out_w + x] =
            (px[c] - mean[c]) / stdv[c];
      }
    }
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* MXTPUTorchRecordIOWriterCreate(const char* path) {
  auto* w = new RecordIOWriter(path);
  if (!w->fp) {
    delete w;
    return nullptr;
  }
  return w;
}

long MXTPUTorchRecordIOWriterTell(void* handle) {
  return static_cast<RecordIOWriter*>(handle)->Tell();
}

int MXTPUTorchRecordIOWriterWrite(void* handle, const char* data, size_t size) {
  return static_cast<RecordIOWriter*>(handle)->WriteRecord(data, size) ? 0
                                                                       : -1;
}

void MXTPUTorchRecordIOWriterFree(void* handle) {
  delete static_cast<RecordIOWriter*>(handle);
}

void* MXTPUTorchRecordIOReaderCreate(const char* path) {
  auto* r = new RecordIOReader(path);
  if (!r->fp) {
    delete r;
    return nullptr;
  }
  return r;
}

// returns size, or 0 at EOF; data copied into caller buffer if big enough
// (two-phase: call with buf=null to get size of next record? simpler:
//  keep last record in reader state)
const char* MXTPUTorchRecordIOReaderNext(void* handle, size_t* out_size) {
  return static_cast<RecordIOReader*>(handle)->NextRecord(out_size);
}

void MXTPUTorchRecordIOReaderSeek(void* handle, long pos) {
  static_cast<RecordIOReader*>(handle)->Seek(pos);
}

long MXTPUTorchRecordIOReaderTell(void* handle) {
  return static_cast<RecordIOReader*>(handle)->Tell();
}

void MXTPUTorchRecordIOReaderFree(void* handle) {
  delete static_cast<RecordIOReader*>(handle);
}

// Decode a batch of JPEGs in parallel into out[n, 3, h, w] float32.
// jpegs: array of pointers; sizes: per-image byte sizes.
// Returns number of failed decodes (failed slots are zero-filled).
// Extended entry: full augmenter parity with the reference's default
// image augmenter (image_aug_default.cc) — rotation, shear, aspect-
// ratio/size-jittered crop, HSL color jitter.
// err (err_len bytes, may be null) receives the message of the first
// image the baseline codec does not take (a progressive JPEG, say): the
// caller raises it, where a corrupt image only zero-fills its slot.
int MXTPUTorchDecodeBatchEx(const uint8_t** jpegs, const size_t* sizes,
                            int n, float* out, int out_h, int out_w,
                            int rand_crop, int rand_mirror, float mean_r,
                            float mean_g, float mean_b, float std_r,
                            float std_g, float std_b, float max_random_scale,
                            float min_random_scale, float max_rotate_angle,
                            float max_shear_ratio, float max_aspect_ratio,
                            int min_crop_size, int max_crop_size,
                            float random_h, float random_s, float random_l,
                            uint64_t seed, int nthreads, char* err,
                            int err_len) {
  AugParams p{out_h,  out_w,  rand_crop, rand_mirror,
              mean_r, mean_g, mean_b,    std_r,
              std_g,  std_b,  max_random_scale, min_random_scale, seed,
              max_rotate_angle, max_shear_ratio, max_aspect_ratio,
              min_crop_size, max_crop_size, random_h, random_s, random_l};
  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  if (nthreads > n) nthreads = n > 0 ? n : 1;
  std::atomic<int> next(0), failures(0);
  std::atomic<bool> have_err(false);
  if (err && err_len > 0) err[0] = 0;
  size_t img_elems = static_cast<size_t>(3) * out_h * out_w;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      float* dst = out + img_elems * i;
      if (!DecodeAugmentOne(jpegs[i], sizes[i], p, seed ^ (0x9e37u + i),
                            dst)) {
        memset(dst, 0, img_elems * sizeof(float));
        failures.fetch_add(1);
        if (g_decode_unsupported && err && err_len > 0 &&
            !have_err.exchange(true))
          snprintf(err, static_cast<size_t>(err_len), "image %d of the batch: %s",
                   i, g_decode_error.c_str());
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Back-compat entry (pre-extension signature): extended knobs off.
int MXTPUTorchDecodeBatch(const uint8_t** jpegs, const size_t* sizes, int n,
                          float* out, int out_h, int out_w, int rand_crop,
                          int rand_mirror, float mean_r, float mean_g,
                          float mean_b, float std_r, float std_g,
                          float std_b, float max_random_scale,
                          float min_random_scale, uint64_t seed,
                          int nthreads) {
  return MXTPUTorchDecodeBatchEx(jpegs, sizes, n, out, out_h, out_w,
                                 rand_crop, rand_mirror, mean_r, mean_g,
                                 mean_b, std_r, std_g, std_b,
                                 max_random_scale, min_random_scale, 0.0f,
                                 0.0f, 0.0f, 0, 0, 0.0f, 0.0f, 0.0f, seed,
                                 nthreads, nullptr, 0);
}

// -- the codec for pack_img / unpack_img -----------------------------------

// Frame size and components (1 or 3); 0 on success, else 1 (corrupt) or
// 2 (unsupported) with the message in err.
int MXTPUTorchJpegInfo(const uint8_t* data, size_t size, int* width,
                       int* height, int* comps, char* err, int err_len) {
  std::string msg;
  int s = mxtpu_jpeg::ReadInfo(data, size, width, height, comps, &msg);
  if (s && err && err_len > 0)
    snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
  return s;
}

// Decode into out[height, width, out_comps] (out_comps 1 or 3).
int MXTPUTorchJpegDecode(const uint8_t* data, size_t size, int out_comps,
                         uint8_t* out, size_t out_size, char* err,
                         int err_len) {
  std::string msg;
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  int s = mxtpu_jpeg::Decode(data, size, out_comps, &pixels, &w, &h, &msg);
  if (s == 0 && pixels.size() != out_size) {
    s = 1;
    msg = "output buffer does not match the image";
  }
  if (s) {
    if (err && err_len > 0)
      snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
    return s;
  }
  memcpy(out, pixels.data(), out_size);
  return 0;
}

// Encode pixels[height, width, comps] at an IJG quality; *out is freed
// with MXTPUTorchJpegFree.
int MXTPUTorchJpegEncode(const uint8_t* pixels, int width, int height,
                         int comps, int quality, uint8_t** out,
                         size_t* out_size, char* err, int err_len) {
  std::string msg;
  std::vector<uint8_t> buf;
  int s = mxtpu_jpeg::Encode(pixels, width, height, comps, quality, &buf,
                             &msg);
  if (s == 0) {
    *out = static_cast<uint8_t*>(malloc(buf.size()));
    if (*out == nullptr) {
      s = 1;
      msg = "out of memory";
    }
  }
  if (s) {
    if (err && err_len > 0)
      snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
    return s;
  }
  memcpy(*out, buf.data(), buf.size());
  *out_size = buf.size();
  return 0;
}

void MXTPUTorchJpegFree(uint8_t* p) { free(p); }

}  // extern "C"
