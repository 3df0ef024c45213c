// flash_attention.cu — O = softmax(scale * Q K^T [causal mask]) V and the
// per-row log-sum-exp, for Q [BH, Tq, D] and K, V [BH, Tk, D], row-major.
// O is stored in Q's dtype (float32 or bfloat16), lse in float32 [BH, Tq].
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_attention.py:_flash_fwd
// (body _fwd_kernel).  The TPU kernel carries the online-softmax state
// (m, l, acc) in VMEM scratch across a sequential key-block grid axis;
// here one thread block owns a (bh, query tile) and loops over the key /
// value tiles itself, staging each in shared memory, with the state in
// registers.  The semantics are the reference's: scores scaled in f32,
// causal masking bottom-right aligned (row r sees key c iff
// r + Tk - Tq >= c), masked scores set to the finite NEG_INF = -1e30 (not
// -inf, so a row that has seen only masked keys gets exp(0) weights that
// the first live key's correction wipes out, as there), key tiles strictly
// above the diagonal skipped, O = acc / l with l = 0 read as 1, and
// lse = m + log(l).  Ragged Tq and Tk are masked: rows past Tq are not
// stored, keys past Tk are masked like the causal ones and their V rows
// are zeros.
//
// bfloat16: four warps, 64 query rows (16 per warp), 64-key tiles.  Both
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate).  The score fragment of QK^T has the layout of the A operand
// of the PV product, so P stays in registers; it is rounded to bf16 there
// (the reference keeps P in f32: a relative error of at most 2^-8 per
// term of O).  D is padded to a multiple of 16 with zeros in shared memory.
// float32: a SIMT path in full f32 (the tensor cores have no f32 mode):
// 32 query rows and 16-key tiles per block, 8 threads per query row.
//
// Bound: at the transformer LM's shape (BH = 128, T = 512, D = 64, causal,
// bf16) the kernel moves 33.8 MB (Q, K, V, O once, lse) against 4.3 GFLOP
// of live products: bytes bound it (10 us at 3.35 TB/s against 4.3 us of
// bf16 tensor-core time).  This first version stages tiles through
// registers with 16-byte loads and no cp.async/TMA pipeline; wgmma and TMA
// are for a later version.
//
// Launch contract: runs on the caller's stream, does not synchronise,
// allocates nothing; the entry point returns cudaGetLastError().  D must be
// a multiple of 8 up to 128, and Q, K, V 16-byte aligned (the wrapper,
// ops/attention.py, ensures both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_D = 128;

// ---------------------------------------------------------------------------
// bfloat16: mma.sync
// ---------------------------------------------------------------------------

constexpr int BQ = 64, BKV = 64, THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Rows r0 .. r0 + ROWS of a [T, D] matrix into a [ROWS, LD] shared tile,
// 8 elements (16 bytes) per load; zeros past T and past D.
template <int ROWS, int KD, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int T, int D) {
  constexpr int CHUNKS = KD / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < T && c < D)
      v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// KD: D rounded up to a multiple of 16
template <int KD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ Q,
                   const __nv_bfloat16* __restrict__ K,
                   const __nv_bfloat16* __restrict__ V,
                   __nv_bfloat16* __restrict__ O, float* __restrict__ LSE,
                   int tq, int tk, int d, float scale, int causal) {
  constexpr int LD = KD + 8;  // bf16 per shared row: conflict-free frags
  constexpr int KC = KD / 16;  // k-steps of QK^T
  constexpr int NC = KD / 8;   // n-chunks of the O accumulator
  constexpr int SC = BKV / 8;  // n-chunks of the score tile
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LD];

  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const __nv_bfloat16* q = Q + bh * tq * d;
  const __nv_bfloat16* k = K + bh * tk * d;
  const __nv_bfloat16* v = V + bh * tk * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16 + g;  // this thread's rows: wr and wr + 8

  // the query tile passes through Ks into registers (A fragments)
  load_tile<BQ, KD, LD>(Ks, q, q0, tq, d);
  __syncthreads();
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const __nv_bfloat16* p0 = Ks + wr * LD + kc * 16 + 2 * t4;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
    qa[kc][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[kc][1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[kc][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qa[kc][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }
  __syncthreads();

  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  const int offset = tk - tq;
  int n_tiles = (tk + BKV - 1) / BKV;
  if (causal) {
    const long long last = (long long)q0 + BQ - 1 + offset;
    const int need = last < 0 ? 0 : (int)(last / BKV) + 1;
    n_tiles = need < n_tiles ? need : n_tiles;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKV;
    load_tile<BKV, KD, LD>(Ks, k, k0, tk, d);
    load_tile<BKV, KD, LD>(Vs, v, k0, tk, d);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[SC][4];
#pragma unroll
    for (int n = 0; n < SC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
      const __nv_bfloat16* kp = Ks + (n * 8 + g) * LD + 2 * t4;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16(s[n], qa[kc],
                 *reinterpret_cast<const uint32_t*>(kp + kc * 16),
                 *reinterpret_cast<const uint32_t*>(kp + kc * 16 + 8));
    }

    // scale, mask, row max (rows wr: e = 0, 1; wr + 8: e = 2, 3)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < SC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + wr + ((e >> 1) << 3);
        const int col = k0 + n * 8 + 2 * t4 + (e & 1);
        const bool live = col < tk && (!causal || row + offset >= col);
        const float x = live ? s[n][e] * scale : NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < SC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // acc += P V: the score fragments of keys 16c .. 16c+15 are the A
    // operand; B pairs two keys of one V column
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      const __nv_bfloat16* vp = Vs + (c * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const __nv_bfloat16* col = vp + n * 8;
        mma_bf16(acc[n], pa, pack_raw(col[0], col[LD]),
                 pack_raw(col[8 * LD], col[9 * LD]));
      }
    }
    __syncthreads();  // the next tile overwrites Ks and Vs
  }

  // O = acc / l, lse = m + log(l); l = 0 reads as 1 (the reference's safe_l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + 8 * h;
    if (row >= tq) continue;
    const float sl = l[h] > 0.0f ? l[h] : 1.0f;
    const float inv = 1.0f / sl;
    __nv_bfloat16* orow = O + (bh * tq + row) * d;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    }
    if (t4 == 0) LSE[bh * tq + row] = m[h] + logf(sl);
  }
}

// ---------------------------------------------------------------------------
// float32: SIMT
// ---------------------------------------------------------------------------

constexpr int FQ = 32, FK = 16, FTHREADS = 256, FCOLS = MAX_D / 8;

__global__ void __launch_bounds__(FTHREADS)
    flash_fwd_f32(const float* __restrict__ Q, const float* __restrict__ K,
                  const float* __restrict__ V, float* __restrict__ O,
                  float* __restrict__ LSE, int tq, int tk, int d, float scale,
                  int causal) {
  __shared__ float Qs[FQ][MAX_D + 1];
  __shared__ float Ks[FK][MAX_D + 1];
  __shared__ float Vs[FK][MAX_D];
  __shared__ float Ps[FQ][FK];

  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * FQ;
  const float* q = Q + bh * tq * d;
  const float* k = K + bh * tk * d;
  const float* v = V + bh * tk * d;
  const int tid = threadIdx.x;
  const int r = tid >> 3, sub = tid & 7;  // 8 threads per query row
  const int row = q0 + r;

  for (int i = tid; i < FQ * d; i += FTHREADS) {
    const int rr = i / d, c = i % d;
    Qs[rr][c] = q0 + rr < tq ? q[(long long)(q0 + rr) * d + c] : 0.0f;
  }

  float acc[FCOLS];
#pragma unroll
  for (int j = 0; j < FCOLS; ++j) acc[j] = 0.0f;
  float m = NEG_INF, l = 0.0f;

  const int offset = tk - tq;
  int n_tiles = (tk + FK - 1) / FK;
  if (causal) {
    const long long last = (long long)q0 + FQ - 1 + offset;
    const int need = last < 0 ? 0 : (int)(last / FK) + 1;
    n_tiles = need < n_tiles ? need : n_tiles;
  }

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * FK;
    __syncthreads();  // Qs written / the previous tile fully read
    for (int i = tid; i < FK * d; i += FTHREADS) {
      const int rr = i / d, c = i % d;
      const bool in = k0 + rr < tk;
      Ks[rr][c] = in ? k[(long long)(k0 + rr) * d + c] : 0.0f;
      Vs[rr][c] = in ? v[(long long)(k0 + rr) * d + c] : 0.0f;
    }
    __syncthreads();

    float s[2], mx = NEG_INF;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = sub * 2 + e;
      float dot = 0.0f;
      for (int kd = 0; kd < d; ++kd) dot = fmaf(Qs[r][kd], Ks[c][kd], dot);
      const int col = k0 + c;
      const bool live = col < tk && (!causal || row + offset >= col);
      s[e] = live ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[e]);
    }
#pragma unroll
    for (int w = 1; w < 8; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p = expf(s[e] - m_new);
      Ps[r][sub * 2 + e] = p;
      rs += p;
    }
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();  // the row's 8 threads (one warp) read each other's P
#pragma unroll
    for (int j = 0; j < FCOLS; ++j) {
      const int c = sub + 8 * j;
      if (c < d) {
        float a = acc[j] * corr;
#pragma unroll
        for (int kk = 0; kk < FK; ++kk) a = fmaf(Ps[r][kk], Vs[kk][c], a);
        acc[j] = a;
      }
    }
    __syncwarp();
  }

  if (row < tq) {
    const float sl = l > 0.0f ? l : 1.0f;
    float* orow = O + (bh * tq + row) * d;
#pragma unroll
    for (int j = 0; j < FCOLS; ++j) {
      const int c = sub + 8 * j;
      if (c < d) orow[c] = acc[j] / sl;
    }
    if (sub == 0) LSE[bh * tq + row] = m + logf(sl);
  }
}

template <int KD>
void launch_bf16(const void* q, const void* k, const void* v, void* o,
                 float* lse, long long bh, int tq, int tk, int d, float scale,
                 int causal, cudaStream_t stream) {
  const dim3 grid((unsigned)bh, (unsigned)((tq + BQ - 1) / BQ));
  flash_fwd_bf16<KD><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, tq, tk, d, scale, causal);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" int mxtpu_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     long long bh, long long tq, long long tk,
                                     int d, float scale, int causal, int dtype,
                                     void* stream) {
  // grid: x = bh, y = query tiles (at most 65535 of 32 rows)
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > MAX_D || d % 8 != 0 ||
      bh >= (1LL << 31) || tq > 65535LL * FQ || tk >= (1LL << 30) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((unsigned)bh, (unsigned)((tq + FQ - 1) / FQ));
    flash_fwd_f32<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, (int)tq,
        (int)tk, d, scale, causal);
    return (int)cudaGetLastError();
  }
  // one instantiation per D rounded up to a multiple of 16
  using Launch = void (*)(const void*, const void*, const void*, void*,
                          float*, long long, int, int, int, float, int,
                          cudaStream_t);
  static const Launch by_kd[MAX_D / 16] = {
      launch_bf16<16>, launch_bf16<32>,  launch_bf16<48>,  launch_bf16<64>,
      launch_bf16<80>, launch_bf16<96>, launch_bf16<112>, launch_bf16<128>};
  by_kd[(d + 15) / 16 - 1](q, k, v, o, lse, bh, (int)tq, (int)tk, d, scale,
                           causal, s);
  return (int)cudaGetLastError();
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
