// fused_scale_bias_dot.cu — Y = (relu?)(X * scale + bias) @ W with the
// per-K-column affine applied to X on its way into the product, rounded
// to X's dtype before the product, f32 accumulation, Y in X's dtype
// (float32 or bfloat16).  X is (M, K) row-major.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py:_pallas_forward
// (body _kernel): the BatchNorm apply step fused into the 1x1 convolution
// that consumes it, so the normalized activation never reaches memory.
// The stride-2 1x1 convolution gets a contiguous subsampled X from its
// caller (fuse.py _bn_relu_conv, as the JAX lowering slices it there).
//
// Three routes, chosen by the caller (ops/fused.py gemm_route) before the
// launch, never one because another failed:
// - sm90 (mxtpu_fused_scale_bias_dot_sm90): bfloat16 whose K and N are
//   multiples of 8 and whose X, W and Y are 16-byte aligned, every shape
//   of the ResNet training path.  W is the 1x1 weight as it lies, (N, K)
//   K-major.  The warp-specialised TMA + wgmma pipeline of hopper_gemm.cuh
//   with the prologue below as its hook: when a stage's A box has landed,
//   each consumer warpgroup rewrites its own 64 rows in place, chunk by
//   16-byte chunk (the channels of a chunk recovered from the 128-byte
//   swizzle), then fences the writes to the async proxy and synchronises
//   its 128 threads before its wgmma.  Channels k >= K are written as 0
//   AFTER the affine: TMA fills them with zeros, which the affine would
//   map to relu(bias[k]), and a read of scale/bias there would be out of
//   bounds (pallas_fused.py pads K the same way).
// - wmma / simt (mxtpu_fused_scale_bias_dot, dtype 1 / 0): the other
//   bfloat16 shapes and float32, through prologue_gemm.cuh with W as a
//   contiguous (K, N) matrix.
//
// Bound: at the training path's shapes the bytes (X and Y streams) bound
// the M = 100352 and M = 25088 shapes and the operations the K, N >= 512
// shapes at M = 6272 and 1568 (2*M*N*K flops against (M*K + K*N + M*N) *
// itemsize bytes; e.g. M = 100352, K = 64, N = 256 is 3.3 GFLOP against
// 64 MB).  The persistent grid keeps the next tile's loads in flight
// while a tile's prologue, product and epilogue run, which is what a
// one-K-step (K = 64) shape needs.

#include "hopper_gemm.cuh"
#include "prologue_gemm.cuh"

namespace {

// Row m of X starts at m * K; one tap.
struct DotSrc {
  long long K;
  __device__ void init(long long m, mxtpu::RowTable& r) const {
    r.base = m * K;
  }
  __device__ long long at(const mxtpu::RowTable& r, int) const {
    return r.base;
  }
};

// The BatchNorm-apply prologue as hopper_gemm.cuh's A hook.  Thread tid
// of a consumer warpgroup rewrites the 16-byte chunks tid + 128 q (q < 4)
// of the warpgroup's 64 x 128-byte block: row r = tid / 8 + 16 q,
// physical chunk tid % 8, so its logical chunk (tid % 8) ^ (r % 8) and
// therefore its eight channels k0 .. k0 + 7 are the same for all four:
// their scale and bias are loaded once per K step, one step ahead.  K is
// a multiple of 8 on this route, so a chunk lies wholly inside K or
// wholly past it; past K it is written as zeros.  scale and bias are
// 16-byte aligned (the caller's copies).
struct BnPrologue {
  const float* scale;
  const float* bias;
  int relu;

  struct Regs {
    float4 s0, s1, b0, b1;
  };

  __device__ __forceinline__ static int chan0(int kb, int tid) {
    return kb * 64 + 8 * ((tid & 7) ^ ((tid >> 3) & 7));
  }

  __device__ __forceinline__ void load(Regs& r, int kb, int K,
                                       int tid) const {
    const int k0 = chan0(kb, tid);
    if (k0 < K) {
      r.s0 = __ldg(reinterpret_cast<const float4*>(scale + k0));
      r.s1 = __ldg(reinterpret_cast<const float4*>(scale + k0 + 4));
      r.b0 = __ldg(reinterpret_cast<const float4*>(bias + k0));
      r.b1 = __ldg(reinterpret_cast<const float4*>(bias + k0 + 4));
    }
  }

  __device__ __forceinline__ float act(float x, float s, float b) const {
    return mxtpu::prologue(x, s, b, relu);
  }

  __device__ __forceinline__ void operator()(Regs& r, uint8_t* a, int kb,
                                             int nk, int K, int tid, int wg,
                                             int) const {
    const bool in = chan0(kb, tid) < K;
    const float s[8] = {r.s0.x, r.s0.y, r.s0.z, r.s0.w,
                        r.s1.x, r.s1.y, r.s1.z, r.s1.w};
    const float b[8] = {r.b0.x, r.b0.y, r.b0.z, r.b0.w,
                        r.b1.x, r.b1.y, r.b1.z, r.b1.w};
    load(r, kb + 1 == nk ? 0 : kb + 1, K, tid);  // the next step's
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4* chunk = reinterpret_cast<uint4*>(a + (tid + 128 * q) * 16);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (in) {
        v = *chunk;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(
              act(f.x, s[2 * j], b[2 * j]),
              act(f.y, s[2 * j + 1], b[2 * j + 1]));
        }
      }
      *chunk = v;
    }
    mxtpu::sm90::fence_proxy_async();
    mxtpu::sm90::warpgroup_bar(1 + wg);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  w is a contiguous (K, N) matrix;
// scale and bias are float32 (K,).  Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" int mxtpu_fused_scale_bias_dot(const void* x, const void* w,
                                          const float* scale,
                                          const float* bias, void* y,
                                          long long M, long long N,
                                          long long K, int relu, int dtype,
                                          void* stream) {
  mxtpu::Problem p{x, w, scale, bias, y, M, N, K, 1, relu};
  return mxtpu::launch(p, DotSrc{K}, dtype,
                       static_cast<cudaStream_t>(stream));
}

// The sm90 route: bfloat16 x (M, K), w (N, K) K-major, y (M, N); scale
// and bias float32 (K,); K and N multiples of 8, x, w and y 16-byte
// aligned, scale and bias too.  bn (64, 128, 256), stages and grid
// (persistent blocks, at most one per SM) are the caller's plan
// (ops/fused.py _sm90_plan).  Returns the cudaError_t of the launch.
extern "C" int mxtpu_fused_scale_bias_dot_sm90(
    const void* x, const void* w, const float* scale, const float* bias,
    void* y, long long M, long long N, long long K, int relu, int bn,
    int stages, int grid, void* stream) {
  const BnPrologue pro{scale, bias, relu};
  return mxtpu::sm90::launch(x, w, pro, mxtpu::sm90::NoEpilogue{}, y, M, N,
                             K, bn, stages, grid,
                             static_cast<cudaStream_t>(stream));
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
