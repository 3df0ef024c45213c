// prologue_gemm.cuh — a tiled GEMM whose A operand passes through the
// BatchNorm-apply prologue on its way into shared memory:
//
//   Y[m, n] = sum_t sum_c A_t[m, c] * W[t*C + c, n]
//   A_t[m, c] = round_T(act(X[src.at(m, t) + c] * scale[c] + bias[c]))
//               or 0 where src.at(m, t) < 0 or c >= C.
//
// Shared by fused_scale_bias_dot.cu (one tap: A_0 = X, a (M, K) matrix)
// and fused_scale_bias_conv3x3.cu (nine taps: A_t is the NHWC input
// shifted by tap t, the implicit GEMM of a 3x3 convolution with HWIO
// weights, whose (3, 3, C, F) layout is already the (9C, F) matrix W).
//
// The prologue is the TPU kernels' (pallas_fused.py:58-63,
// pallas_conv.py:56-62): the affine in f32 (multiply and add rounded
// separately, as in the plain PyTorch versions), relu, then rounded to
// X's dtype BEFORE the product; zeros (the conv's halo, ragged edges) are
// written after the prologue, so a padded position contributes 0 and not
// relu(bias).  Products accumulate in f32; Y is stored in X's dtype.
//
// Bound: at the training path's shapes the product (2*M*N*K flops) bounds
// these kernels, well above the bytes.  This first version is simple and
// right: one block per (BM x BN) output tile, a loop over K in BK steps,
// each step staged global -> registers (prologue) -> shared memory.
// bfloat16 multiplies on the tensor cores through WMMA 16x16x16 fragments
// (f32 accumulators), with 16-byte loads and the next tile prefetched
// into registers; float32 takes a simpler SIMT FMA path (the tensor
// cores have no full-precision f32 mode).  Ragged M, N and C are masked;
// there is no divisibility requirement.  wgmma and TMA are for a later
// version.
//
// Launch contract: runs on the caller's stream, does not synchronise,
// allocates nothing; the entry points return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mxtpu {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float prologue(float x, float s, float b,
                                          int relu) {
  const float v = __fadd_rn(__fmul_rn(x, s), b);
  return (relu && v < 0.0f) ? 0.0f : v;  // NaN propagates, as torch.relu
}

// One GEMM problem.  M output rows, N output columns, C channels per
// tap, `taps` taps: the reduction runs over taps * C.
struct Problem {
  const void* x;
  const void* w;
  const float* scale;
  const float* bias;
  void* y;
  long long M, N, C;
  int taps;
  int relu;
};

// Per-tile row table: for each of the tile's rows, where its input rows
// start (Src::init) and, for the current tap, the offset of its first
// channel in X or -1 (Src::at).
struct RowTable {
  long long base;
  int ih0, iw0;
};

// ---------------------------------------------------------------------------
// bfloat16: WMMA on the tensor cores.  128 x 128 output tile, BK = 32,
// eight warps in a 2 x 4 grid, each warp 64 x 32 (4 x 2 fragments).
//
// Each thread moves 8 consecutive channels (A) or columns (B) at a time:
// one 16-byte load when C and N are multiples of 8 and X and W are
// 16-byte aligned (VEC), else 8 masked scalar loads.  The next K tile is
// loaded into registers while the warps multiply the current one out of
// shared memory; the prologue is applied as the registers are written to
// the other of two shared-memory stages, so one barrier per K tile
// remains and the load latency hides behind the WMMA work.
// ---------------------------------------------------------------------------

namespace bf16cfg {
constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDA = BK + 8;   // bf16 elements per A row in smem
constexpr int LDB = BN + 8;   // bf16 elements per B row in smem
}  // namespace bf16cfg

// 8 bf16 values in flight for one A or B vector, and which are real.
struct Vec8 {
  uint4 raw;
  unsigned mask;  // bit j: element j lies inside the problem
};

template <bool VEC>
__device__ __forceinline__ Vec8 load8(const __nv_bfloat16* ptr,
                                      long long avail) {
  // avail: how many of the 8 elements at ptr lie inside the problem
  Vec8 v;
  v.raw = make_uint4(0, 0, 0, 0);
  v.mask = 0;
  if (avail <= 0) return v;
  if (VEC) {  // avail >= 8 by the alignment contract
    v.raw = *reinterpret_cast<const uint4*>(ptr);
    v.mask = 0xffu;
    return v;
  }
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v.raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < avail) {
      e[j] = ptr[j];
      v.mask |= 1u << j;
    }
  }
  return v;
}

template <typename Src, bool VEC>
__global__ void __launch_bounds__(bf16cfg::THREADS)
    gemm_bf16_wmma(Problem p, Src src) {
  using namespace bf16cfg;
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * LDB];

  const __nv_bfloat16* X = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* Y = static_cast<__nv_bfloat16*>(p.y);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;

  // A: rows a_row and a_row + 64, channels a_col .. a_col + 7 of the tile
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;
  // B: rows b_row and b_row + 16, columns b_col .. b_col + 7 of the tile
  const int b_row = tid >> 4, b_col = (tid & 15) * 8;
  RowTable rt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + a_row + 64 * i;
    rt[i] = RowTable{-1, 0, 0};
    if (m < p.M) src.init(m, rt[i]);
  }

  const long long nc = (p.C + BK - 1) / BK;
  const long long nk = (long long)p.taps * nc;
  Vec8 a_in[2], b_in[2];
  float s8[8], b8[8];

  auto load = [&](long long kt) {
    const int tap = (int)(kt / nc);
    const long long c0 = (kt - tap * nc) * BK;
    const long long c = c0 + a_col;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool in = c + j < p.C;
      s8[j] = in ? p.scale[c + j] : 0.0f;
      b8[j] = in ? p.bias[c + j] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long o = rt[i].base < 0 ? -1 : src.at(rt[i], tap);
      a_in[i] = load8<VEC>(X + (o < 0 ? 0 : o + c), o < 0 ? 0 : p.C - c);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long k = c0 + b_row + 16 * i;
      const long long n = n0 + b_col;
      const bool in = k < p.C;
      b_in[i] = load8<VEC>(in ? W + ((long long)tap * p.C + k) * p.N + n : W,
                           in ? p.N - n : 0);
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 out;
      const __nv_bfloat16* e =
          reinterpret_cast<const __nv_bfloat16*>(&a_in[i].raw);
      __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = ((a_in[i].mask >> j) & 1u)
                            ? prologue(to_f32(e[j]), s8[j], b8[j], p.relu)
                            : 0.0f;
        q[j] = from_f32<__nv_bfloat16>(v);
      }
      *reinterpret_cast<uint4*>(&As[buf][(a_row + 64 * i) * LDA + a_col]) =
          out;
      *reinterpret_cast<uint4*>(&Bs[buf][(b_row + 16 * i) * LDB + b_col]) =
          b_in[i].raw;  // masked elements were loaded as zeros
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
                     wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(
            af[i], &As[buf][(warp_m * 64 + i * 16) * LDA + ks], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            bfr[j], &Bs[buf][ks * LDB + warp_n * 32 + j * 16], LDB);
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
  // free after the last barrier), masked stores
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
          Y[m * p.N + n] = from_f32<__nv_bfloat16>(sc[e]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// float32: SIMT FMA.  64 x 64 output tile, BK = 16, 16 x 16 threads, each
// accumulating a 4 x 4 micro-tile strided by 16 (conflict-free smem reads).
// ---------------------------------------------------------------------------

namespace f32cfg {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
}  // namespace f32cfg

template <typename Src>
__global__ void __launch_bounds__(f32cfg::THREADS)
    gemm_f32_simt(Problem p, Src src) {
  using namespace f32cfg;
  __shared__ float As[BK][BM + 4];  // A transposed: As[k][m]
  __shared__ float Bs[BK][BN];
  __shared__ RowTable rows[BM];
  __shared__ long long off[BM];

  const float* X = static_cast<const float*>(p.x);
  const float* W = static_cast<const float*>(p.w);
  float* Y = static_cast<float*>(p.y);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;

  if (tid < BM) {
    const long long m = m0 + tid;
    RowTable r{-1, 0, 0};
    if (m < p.M) src.init(m, r);
    rows[tid] = r;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int a_col = tid & 15, a_row0 = tid >> 4;  // rows + 16 i
  const int b_col = tid & 63, b_row0 = tid >> 6;  // rows + 4 i

  for (int tap = 0; tap < p.taps; ++tap) {
    __syncthreads();
    if (tid < BM) {
      const RowTable r = rows[tid];
      off[tid] = r.base < 0 ? -1 : src.at(r, tap);
    }
    __syncthreads();
    for (long long c0 = 0; c0 < p.C; c0 += BK) {
      {
        const long long c = c0 + a_col;
        const bool cv = c < p.C;
        const float s = cv ? p.scale[c] : 0.0f;
        const float b = cv ? p.bias[c] : 0.0f;
#pragma unroll
        for (int r = a_row0; r < BM; r += THREADS / BK) {
          const long long o = off[r];
          As[a_col][r] = (cv && o >= 0) ? prologue(X[o + c], s, b, p.relu)
                                        : 0.0f;
        }
      }
      {
        const long long n = n0 + b_col;
        const bool nv = n < p.N;
#pragma unroll
        for (int k = b_row0; k < BK; k += THREADS / BN) {
          const long long c = c0 + k;
          Bs[k][b_col] = (nv && c < p.C)
                             ? W[((long long)tap * p.C + c) * p.N + n]
                             : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n < p.N) Y[m * p.N + n] = acc[i][j];
    }
  }
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
template <typename Src>
int launch(const Problem& p, const Src& src, int dtype, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.C <= 0 || p.taps <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const dim3 grid((unsigned)((p.M + bf16cfg::BM - 1) / bf16cfg::BM),
                    (unsigned)((p.N + bf16cfg::BN - 1) / bf16cfg::BN));
    // 16-byte loads: every row offset is a multiple of C (A) or N (B)
    const bool vec = p.C % 8 == 0 && p.N % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
    if (vec)
      gemm_bf16_wmma<Src, true><<<grid, bf16cfg::THREADS, 0, stream>>>(p,
                                                                       src);
    else
      gemm_bf16_wmma<Src, false><<<grid, bf16cfg::THREADS, 0, stream>>>(p,
                                                                        src);
  } else {
    const dim3 grid((unsigned)((p.M + f32cfg::BM - 1) / f32cfg::BM),
                    (unsigned)((p.N + f32cfg::BN - 1) / f32cfg::BN));
    gemm_f32_simt<Src><<<grid, f32cfg::THREADS, 0, stream>>>(p, src);
  }
  return (int)cudaGetLastError();
}

}  // namespace mxtpu
