// fused_scale_bias_conv3x3.cu — Y = conv3x3(relu?(X * scale + bias), W),
// pad 1, stride 1 or 2: NHWC input X (N, H, W, C), NHWC output
// (N, OH, OW, F), f32 accumulation, Y in X's dtype (float32 or bfloat16).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py:_pallas_conv (body
// _kernel): the BatchNorm apply step and relu fused into the 3x3
// convolution that consumes them.
//
// An implicit GEMM: output row m = (n, oh, ow), nine taps t = (dy, dx),
// tap t reading input pixel (oh*s + dy - 1, ow*s + dx - 1).  A halo pixel
// is a zero row written AFTER the prologue (pallas_conv.py:56-62 pads the
// activated block), so it adds 0 and not relu(bias).  Strided rows are
// just other offsets: stride 2 at odd H or W needs no fallback (the TPU
// kernel's :153-157).
//
// Three routes, chosen by the caller (ops/fused_conv.py conv3x3_route)
// before the launch, never one because another failed:
// - sm90 (mxtpu_fused_scale_bias_conv3x3_sm90): bfloat16 with C a
//   multiple of 64 and F of 8, X, the weight and Y 16-byte aligned, every
//   shape of the ResNet training path.  The weight is the (F, 9C)
//   K-major matrix, K ordered tap-major (k = (3 dy + dx) C + c: the OIHW
//   weight as OHWI).  hopper_gemm.cuh's warp-specialised TMA + wgmma
//   pipeline with Im2colA as its A source (TMA's im2col mode: one box of
//   128 output pixels x 64 channels of one tap per K step, the halo and
//   the ragged last tile filled with zeros by TMA) and ConvPrologue below
//   as its hook.  A K step lies inside one tap because C % 64 == 0.
// - wmma / simt (mxtpu_fused_scale_bias_conv3x3, dtype 1 / 0): the other
//   bfloat16 shapes and float32, through prologue_gemm.cuh with the HWIO
//   weight, whose (3, 3, C, F) layout is the (9C, F) matrix as it lies.
//
// Bound: operations at the training path's shapes (2 * N*OH*OW * F * 9C
// flops; e.g. 32 x 56 x 56 x 64 -> 64 is 7.4 GFLOP against 26 MB).

#include "hopper_gemm.cuh"
#include "prologue_gemm.cuh"

namespace {

struct ConvSrc {
  int H, W, C, OH, OW, stride;
  __device__ void init(long long m, mxtpu::RowTable& r) const {
    const int ow = (int)(m % OW);
    const long long t = m / OW;
    const int oh = (int)(t % OH);
    const long long n = t / OH;
    r.base = n * H * W * C;
    r.ih0 = oh * stride - 1;
    r.iw0 = ow * stride - 1;
  }
  __device__ long long at(const mxtpu::RowTable& r, int tap) const {
    const int ih = r.ih0 + tap / 3, iw = r.iw0 + tap % 3;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return -1;
    return r.base + ((long long)ih * W + iw) * C;
  }
};

// The BatchNorm-apply prologue of fused_scale_bias_dot.cu's BnPrologue on
// the im2col A stage.  Thread tid of a consumer warpgroup rewrites the
// 16-byte chunks tid + 128 q (q < 4) of its warpgroup's 64 x 128-byte
// block: row r = tid / 8 + 16 q, one logical chunk (tid % 8) ^ (r % 8)
// for all four, so its eight channels are (kb 64) mod C + 8 that chunk
// (C % 64 == 0: a K step is one tap, kb 64 / C, and one channel block).
// A row whose input pixel of this tap lies in the halo is written 0
// after the affine (TMA filled it with zeros, which the affine would map
// to relu(bias)).  Which of the nine taps are live for each of the
// thread's four rows is worked out once per tile (a 9-bit mask per row,
// from the tile's first row m0); per K step that is one shift per row.
// Rows past M (the ragged last tile) are never stored, whatever they
// hold.
struct ConvPrologue {
  const float* scale;
  const float* bias;
  int relu;
  int C, H, W, OH, OW, stride;

  struct Regs {
    float4 s0, s1, b0, b1;
    uint32_t live[4];  // bit t: tap t of the row reads inside the image
  };

  __device__ __forceinline__ int chan0(int kb, int tid) const {
    return (kb * 64) % C + 8 * ((tid & 7) ^ ((tid >> 3) & 7));
  }

  __device__ __forceinline__ void load(Regs& r, int kb, int, int tid) const {
    const int c0 = chan0(kb, tid);
    r.s0 = __ldg(reinterpret_cast<const float4*>(scale + c0));
    r.s1 = __ldg(reinterpret_cast<const float4*>(scale + c0 + 4));
    r.b0 = __ldg(reinterpret_cast<const float4*>(bias + c0));
    r.b1 = __ldg(reinterpret_cast<const float4*>(bias + c0 + 4));
  }

  __device__ __forceinline__ void rows(Regs& r, int m0, int tid,
                                       int wg) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + wg * 64 + (tid >> 3) + 16 * q;
      const int ow = m % OW, t = m / OW;
      const int ih0 = (t % OH) * stride - 1, iw0 = ow * stride - 1;
      uint32_t live = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ih = ih0 + tap / 3, iw = iw0 + tap % 3;
        live |= (uint32_t)(ih >= 0 && ih < H && iw >= 0 && iw < W) << tap;
      }
      r.live[q] = live;
    }
  }

  __device__ __forceinline__ void operator()(Regs& r, uint8_t* a, int kb,
                                             int nk, int K, int tid, int wg,
                                             int m0) const {
    if (kb == 0) rows(r, m0, tid, wg);
    const int tap = (kb * 64) / C;
    const float s[8] = {r.s0.x, r.s0.y, r.s0.z, r.s0.w,
                        r.s1.x, r.s1.y, r.s1.z, r.s1.w};
    const float b[8] = {r.b0.x, r.b0.y, r.b0.z, r.b0.w,
                        r.b1.x, r.b1.y, r.b1.z, r.b1.w};
    load(r, kb + 1 == nk ? 0 : kb + 1, K, tid);  // the next step's
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4* chunk = reinterpret_cast<uint4*>(a + (tid + 128 * q) * 16);
      uint4 v = make_uint4(0, 0, 0, 0);
      if ((r.live[q] >> tap) & 1u) {
        v = *chunk;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(
              mxtpu::prologue(f.x, s[2 * j], b[2 * j], relu),
              mxtpu::prologue(f.y, s[2 * j + 1], b[2 * j + 1], relu));
        }
      }
      *chunk = v;
    }
    mxtpu::sm90::fence_proxy_async();
    mxtpu::sm90::warpgroup_bar(1 + wg);
  }
};

bool conv_shape_ok(long long H, long long W, long long OH, long long OW,
                   int stride) {
  return (stride == 1 || stride == 2) && OH == (H - 1) / stride + 1 &&
         OW == (W - 1) / stride + 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  w is the HWIO (3, 3, C, F) weight,
// contiguous; scale and bias are float32 (C,).  Returns the cudaError_t
// of the launch (0 = cudaSuccess).
extern "C" int mxtpu_fused_scale_bias_conv3x3(
    const void* x, const void* w, const float* scale, const float* bias,
    void* y, long long N, long long H, long long W, long long C, long long F,
    long long OH, long long OW, int stride, int relu, int dtype,
    void* stream) {
  if (!conv_shape_ok(H, W, OH, OW, stride)) return (int)cudaErrorInvalidValue;
  if (H * W * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  mxtpu::Problem p{x, w, scale, bias, y, N * OH * OW, F, C, 9, relu};
  const ConvSrc src{(int)H, (int)W, (int)C, (int)OH, (int)OW, stride};
  return mxtpu::launch(p, src, dtype, static_cast<cudaStream_t>(stream));
}

// The sm90 route: bfloat16 x (N, H, W, C), w_fk (F, 9C) K-major (the
// OHWI weight), y (N, OH, OW, F); scale and bias float32 (C,), 16-byte
// aligned; C a multiple of 64, F of 8, x, w_fk and y 16-byte aligned.
// bn (64, 128, 256), stages and grid (persistent blocks, at most one per
// SM) are the caller's plan (ops/fused.py _sm90_plan).  Returns the
// cudaError_t of the launch.
extern "C" int mxtpu_fused_scale_bias_conv3x3_sm90(
    const void* x, const void* w_fk, const float* scale, const float* bias,
    void* y, long long N, long long H, long long W, long long C, long long F,
    long long OH, long long OW, int stride, int relu, int bn, int stages,
    int grid, void* stream) {
  const long long M = N * OH * OW;
  if (!conv_shape_ok(H, W, OH, OW, stride) || N <= 0 || C <= 0 ||
      C % 64 != 0 || M >= (1LL << 31) || H >= (1LL << 31) ||
      W >= (1LL << 31) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_fk) |
        reinterpret_cast<uintptr_t>(scale) |
        reinterpret_cast<uintptr_t>(bias)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!mxtpu::sm90::encode_im2col3x3(&ma, x, N, H, W, C, stride) ||
      !mxtpu::sm90::encode_kmajor(&mb, w_fk, F, 9 * C, bn))
    return (int)cudaErrorInvalidValue;
  const mxtpu::sm90::Im2colA asrc{(int)C, (int)OH, (int)OW, stride};
  const ConvPrologue pro{scale,  bias,    relu,    (int)C,
                         (int)H, (int)W,  (int)OH, (int)OW, stride};
  return mxtpu::sm90::launch_maps(ma, mb, asrc, pro,
                                  mxtpu::sm90::NoEpilogue{}, y, M, F, 9 * C,
                                  bn, stages, grid,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
