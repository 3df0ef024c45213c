// fused_dot_epilogue.cu — Y = clip?(relu?(X @ W^T + bias)) with the bias
// add, relu and clip applied to the f32 accumulator before the one store,
// Y in X's dtype (float32 or bfloat16).  X is (M, K) row-major; W is the
// FullyConnected weight as it lies, (N, K) row-major, so the GEMM's B
// operand is W read transposed; bias is float32 (N,) or absent.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py:_dot_epi_pallas
// (body _dot_epi_kernel), which keeps an f32 accumulator in VMEM across a
// sequential K grid axis and applies the epilogue at the last K step.
// Here one thread block owns an output tile and loops over K itself; the
// epilogue runs on the accumulator registers: (acc + bias), then relu,
// then clip, then one rounding, the order of the reference's
// `acc + b; maximum(y, 0); clip(y, lo, hi)` (NaN propagates).
//
// Three routes, chosen by the caller (ops/fused.py gemm_route) before the
// launch, never one because another failed:
// - sm90 (mxtpu_fused_dot_epilogue_sm90): bfloat16 whose K and N are
//   multiples of 8 and whose X, W and Y are 16-byte aligned, the
//   transformer LM's path.  The warp-specialised TMA + wgmma pipeline of
//   hopper_gemm.cuh with this file's epilogue as its hook, at the tile
//   width, stage count and persistent grid the caller planned.
// - wmma (mxtpu_fused_dot_epilogue, dtype 1): the other bfloat16 shapes.
//   Tiling follows prologue_gemm.cuh without its prologue: WMMA 16x16x16
//   fragments (f32 accumulators), a 128 x 128 output tile, BK = 32, eight
//   warps of 64 x 32, two shared stages with the next K tile prefetched
//   into registers, 16-byte loads when K is a multiple of 8 and X and W
//   are 16-byte aligned.  W's tile is staged as Bs[n][k] and read as a
//   column-major matrix_b.  Ragged M, N and K are masked.
// - simt (dtype 0): float32, a SIMT FMA path (64 x 64 tile, 4 x 4
//   micro-tiles per thread).
//
// Bound: operations at the transformer LM's shape (M = 8192, K = 512,
// N = 2048: 17.2 GFLOP against 44 MB; 17.4 us of bf16 tensor-core time
// against 13 us of memory time).  Only the sm90 route reaches the tensor
// cores' rate (wgmma); the wmma route stays as the yardstick.
//
// Launch contract: runs on the caller's stream, does not synchronise,
// allocates nothing; the entry points return cudaGetLastError().

#include "hopper_gemm.cuh"
#include "prologue_gemm.cuh"

namespace {

using mxtpu::from_f32;
using mxtpu::load8;
using mxtpu::Vec8;

// bias add (when there is a bias), relu, clip: NaN propagates
__device__ __forceinline__ float epilogue_value(float acc, float b,
                                                bool has_bias, int relu,
                                                int has_clip, float lo,
                                                float hi) {
  float v = has_bias ? __fadd_rn(acc, b) : acc;
  if (relu && v < 0.0f) v = 0.0f;
  if (has_clip) {
    if (v < lo) v = lo;
    if (v > hi) v = hi;
  }
  return v;
}

struct Epi {
  const void* x;
  const void* w;
  const float* bias;  // nullptr: no bias
  void* y;
  long long M, N, K;
  int relu, has_clip;
  float lo, hi;

  __device__ __forceinline__ float apply(float acc, long long n) const {
    return epilogue_value(acc, bias ? bias[n] : 0.0f, bias != nullptr, relu,
                          has_clip, lo, hi);
  }
};

// The same epilogue as the hook of hopper_gemm.cuh's sm90 mainloop.
struct Sm90Epi {
  const float* bias;  // nullptr: no bias
  int N;
  int relu, has_clip;
  float lo, hi;

  __device__ __forceinline__ float2 bias2(int n) const {
    return (bias && n < N) ? make_float2(bias[n], bias[n + 1])
                           : make_float2(0.0f, 0.0f);
  }
  __device__ __forceinline__ float operator()(float acc, float b) const {
    return epilogue_value(acc, b, bias != nullptr, relu, has_clip, lo, hi);
  }
};

// ---------------------------------------------------------------------------
// bfloat16: WMMA
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDS = BK + 8;  // bf16 per smem row of either operand

template <bool VEC>
__global__ void __launch_bounds__(THREADS) dot_epilogue_bf16(Epi p) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BN * LDS];

  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* Y = static_cast<__nv_bfloat16*>(p.y);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;

  // each thread moves rows ld_row and ld_row + 64, k .. k + 7 of both
  // the X tile (rows m) and the W tile (rows n)
  const int ld_row = tid >> 2, ld_col = (tid & 3) * 8;
  const long long nk = (p.K + BK - 1) / BK;
  Vec8 a_in[2], b_in[2];

  auto load = [&](long long kt) {
    const long long k = kt * BK + ld_col;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = m0 + ld_row + 64 * i;
      const long long n = n0 + ld_row + 64 * i;
      const bool am = m < p.M, bn = n < p.N;
      a_in[i] = load8<VEC>(am ? X + m * p.K + k : X, am ? p.K - k : 0);
      b_in[i] = load8<VEC>(bn ? W + n * p.K + k : W, bn ? p.K - k : 0);
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (ld_row + 64 * i) * LDS + ld_col;
      *reinterpret_cast<uint4*>(&As[buf][r]) = a_in[i].raw;
      *reinterpret_cast<uint4*>(&Bs[buf][r]) = b_in[i].raw;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  store(0);
  __syncthreads();
  for (long long kt = 0; kt < nk; ++kt) {
    const int buf = (int)(kt & 1);
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(
            af[i], &As[buf][(warp_m * 64 + i * 16) * LDS + ks], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            bfr[j], &Bs[buf][(warp_n * 32 + j * 16) * LDS + ks], LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each fragment through the warp's scratch (the A stages are
  // free after the last barrier), then bias / relu / clip, masked stores
  float* sc = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = lane * 8 + q;
        const long long m = m0 + warp_m * 64 + i * 16 + (e >> 4);
        const long long n = n0 + warp_n * 32 + j * 16 + (e & 15);
        if (m < p.M && n < p.N)
          Y[m * p.N + n] = from_f32<__nv_bfloat16>(p.apply(sc[e], n));
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// float32: SIMT FMA.  64 x 64 output tile, BK = 16, 16 x 16 threads, each
// accumulating a 4 x 4 micro-tile strided by 16.  Both operands are
// staged k-major (As[k][m], Bs[k][n]) from K-contiguous rows.
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS) dot_epilogue_f32(Epi p) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Bs[FK][FN + 4];

  const float* X = static_cast<const float*>(p.x);
  const float* W = static_cast<const float*>(p.w);
  float* Y = static_cast<float*>(p.y);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * FM;
  const long long n0 = (long long)blockIdx.y * FN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int ld_k = tid & 15, ld_r0 = tid >> 4;  // rows ld_r0 + 16 i
  for (long long k0 = 0; k0 < p.K; k0 += FK) {
    const long long k = k0 + ld_k;
    const bool kv = k < p.K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ld_r0 + 16 * i;
      const long long m = m0 + r, n = n0 + r;
      As[ld_k][r] = (kv && m < p.M) ? X[m * p.K + k] : 0.0f;
      Bs[ld_k][r] = (kv && n < p.N) ? W[n * p.K + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n < p.N) Y[m * p.N + n] = p.apply(acc[i][j], n);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias: float32 (N,) or NULL.  clip
// applies [lo, hi] when has_clip.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" int mxtpu_fused_dot_epilogue(const void* x, const void* w,
                                        const float* bias, void* y,
                                        long long M, long long N, long long K,
                                        int relu, int has_clip, float lo,
                                        float hi, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (dtype != 0 && dtype != 1) ||
      (N + FN - 1) / FN > 65535)
    return (int)cudaErrorInvalidValue;
  const Epi p{x, w, bias, y, M, N, K, relu, has_clip, lo, hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((unsigned)((M + BM - 1) / BM),
                    (unsigned)((N + BN - 1) / BN));
    const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (vec)
      dot_epilogue_bf16<true><<<grid, THREADS, 0, s>>>(p);
    else
      dot_epilogue_bf16<false><<<grid, THREADS, 0, s>>>(p);
  } else {
    const dim3 grid((unsigned)((M + FM - 1) / FM),
                    (unsigned)((N + FN - 1) / FN));
    dot_epilogue_f32<<<grid, FTHREADS, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// The sm90 route: bfloat16 x (M, K), w (N, K), y (M, N); K and N
// multiples of 8, x, w and y 16-byte aligned.  bn (64, 128, 256), stages
// and grid (persistent blocks, at most one per SM) are the caller's plan
// (ops/fused.py _sm90_plan).  Returns the cudaError_t of the launch.
extern "C" int mxtpu_fused_dot_epilogue_sm90(
    const void* x, const void* w, const float* bias, void* y, long long M,
    long long N, long long K, int relu, int has_clip, float lo, float hi,
    int bn, int stages, int grid, void* stream) {
  const Sm90Epi epi{bias, (int)N, relu, has_clip, lo, hi};
  return mxtpu::sm90::launch(x, w, mxtpu::sm90::NoPrologue{}, epi, y, M, N,
                             K, bn, stages, grid,
                             static_cast<cudaStream_t>(stream));
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
