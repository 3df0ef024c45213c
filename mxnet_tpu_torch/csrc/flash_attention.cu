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
// Three routes, chosen by the caller (ops/attention.py attention_route)
// before the launch, never one because another failed:
// - sm90 (mxtpu_flash_attention_sm90): bfloat16 with D 64 or 128 and
//   16-byte aligned Q, K, V, O, the LM's path.  Persistent: one block
//   per SM walks the (bh, 128-row query tile) tiles, the longest causal
//   ones first.  One producer warp loads each tile's Q (double-buffered)
//   and its 128-key K and V tiles into an mbarrier ring (4 stages at
//   D = 64, 2 at D = 128) through TMA, running ahead across tiles, from
//   3-D (D, T, BH) tensor maps (so that rows past T read zeros of their
//   own head, not the next head's), 128-byte swizzled, in 64-column
//   sub-tiles.  Two consumer
//   warpgroups (setmaxnreg 240; the producer's 24) each own 64 query
//   rows: S = Q K^T is a wgmma from shared memory (K as the K-major B,
//   as it lies), the two warpgroups taking turns to issue it (named
//   barriers) so that one's softmax overlaps the other's product; the
//   online softmax runs on the S accumulator in registers, in log2
//   units (one ex2 per probability), masking only the tiles that reach
//   past Tk or the diagonal; P is rounded to bf16 there and is the
//   register A operand of O += P V, a wgmma whose B is the V tile read
//   MN-major (wgmma's transposed B: V is [keys, D] with D contiguous).
//   The accumulator of S has the layout of the A fragment of the PV
//   product, so P never leaves registers.  The ring's depth and the tile
//   width were chosen by tools/torch_flash_tiles.py.
// - mma (mxtpu_flash_attention, dtype 1): the other bfloat16 head dims,
//   four warps, 64 query rows (16 per warp), 64-key tiles, both products
//   through mma.sync m16n8k16 (bf16 in, f32 accumulate), tiles staged
//   through registers; D padded to a multiple of 16 with zeros in shared
//   memory.  The first design, kept as the sm90 route's yardstick.
// - simt (mxtpu_flash_attention, dtype 0): float32 in full f32 (the
//   tensor cores have no f32 mode): 32 query rows and 16-key tiles per
//   block, 8 threads per query row.
// Both bf16 routes round P to bf16 for the PV product (the reference
// keeps P in f32: a relative error of at most 2^-8 per term of O).
//
// Bound: at the transformer LM's shape (BH = 128, T = 512, D = 64, causal,
// bf16) the kernel moves 33.8 MB (Q, K, V, O once, lse) against 4.3 GFLOP
// of live products: bytes bound it (10 us at 3.35 TB/s against 4.3 us of
// bf16 tensor-core time).
//
// Launch contract: runs on the caller's stream, does not synchronise,
// allocates nothing; the entry points return cudaGetLastError().  The mma
// and simt routes take D a multiple of 8 up to 128 and Q, K, V 16-byte
// aligned (the wrapper, ops/attention.py, ensures both).  The sm90 route
// links the CUDA driver API (cuTensorMapEncodeTiled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16 on Hopper: TMA + wgmma (the sm90 route)
// ---------------------------------------------------------------------------

namespace fa90 {

using namespace mxtpu::sm90;

constexpr int kBQ = 128;        // query rows per block: two warpgroups of 64
constexpr int kBKV = 128;       // keys per tile
// K/V ring: as many stages as fit beside the double-buffered Q, at most 4
// (4 at D = 64, 2 at D = 128)
template <int D>
constexpr int kStages = D == 64 ? 4 : 2;
constexpr int kThreads = 384;   // two consumer warpgroups and the producer
constexpr int kTurnBar = 3;     // named barriers 3 and 4: the S-product turns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x (MUFU.EX2; flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Named barrier `id` over both consumer warpgroups (256 threads): sync
// waits for the other warpgroup's arrive.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Bytes of one Q buffer and of one stage's K (or V) tile at head dim d:
// 64-column sub-tiles of 128-byte rows, each 1024-byte aligned.
__host__ __device__ constexpr int q_bytes(int d) { return kBQ * d * 2; }
__host__ __device__ constexpr int kv_bytes(int d) { return kBKV * d * 2; }
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + 2 * q_bytes(D) + kStages<D> * 2 * kv_bytes(D) +
         (4 + 2 * kStages<D>) * 8;
}
static_assert(smem_bytes<64>() <= kSmemLimit &&
                  smem_bytes<128>() <= kSmemLimit,
              "flash_fwd_sm90: shared memory");

// The work tiles of one launch: (bh, 128-row query tile), numbered so
// that the last query tiles, which have the most causal work, come first.
struct Tiles {
  int bh_count, n_qt, tq, tk, causal;
  __device__ __forceinline__ int count() const { return bh_count * n_qt; }
  __device__ __forceinline__ void at(int t, int& bh, int& q0) const {
    bh = t % bh_count;
    q0 = (n_qt - 1 - t / bh_count) * kBQ;
  }
  // key tiles of the query tile at q0: none strictly above the diagonal
  __device__ __forceinline__ int kv(int q0) const {
    int n = (tk + kBKV - 1) / kBKV;
    if (causal) {
      const long long last = (long long)q0 + kBQ - 1 + tk - tq;
      const int need = last < 0 ? 0 : (int)(last / kBKV) + 1;
      n = need < n ? need : n;
    }
    return n;
  }
};

// Persistent: block b takes tiles b, b + grid, ...  The producer runs
// ahead across tiles (Q double-buffered, K/V through the ring), so a
// tile's loads overlap the previous tile's last products and epilogue.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tma_q,
                   const __grid_constant__ CUtensorMap tma_k,
                   const __grid_constant__ CUtensorMap tma_v,
                   __nv_bfloat16* __restrict__ O, float* __restrict__ LSE,
                   const Tiles tiles, float scale) {
  constexpr int kSub = D / 64;          // 64-column sub-tiles
  constexpr int kQSub = kBQ * 128;      // bytes of one Q sub-tile
  constexpr int kKVSub = kBKV * 128;    // bytes of one K or V sub-tile
  constexpr int kStages = fa90::kStages<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                             // 2 x Q tile
  uint8_t* sk = sq + 2 * q_bytes(D);              // stages x K tile
  uint8_t* sv = sk + kStages * kv_bytes(D);       // stages x V tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + kStages * kv_bytes(D));
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;
  const int tq = tiles.tq, tk = tiles.tk, causal = tiles.causal;
  const int offset = tk - tq;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: per tile its Q, then its K/V tiles through the ring
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      int s = 0, qb = 0;
      uint32_t ph = 0, qph = 0;
      for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
        int bh, q0;
        tiles.at(t, bh, q0);
        mbar_wait(&q_empty[qb], qph ^ 1);
        mbar_expect_tx(&q_full[qb], q_bytes(D));
#pragma unroll
        for (int c = 0; c < kSub; ++c)
          tma_load_3d(sq + qb * q_bytes(D) + c * kQSub, &tma_q, &q_full[qb],
                      c * 64, q0, bh);
        const int n_kv = tiles.kv(q0);
        for (int j = 0; j < n_kv; ++j) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], 2 * kv_bytes(D));
#pragma unroll
          for (int c = 0; c < kSub; ++c) {
            tma_load_3d(sk + s * kv_bytes(D) + c * kKVSub, &tma_k, &full[s],
                        c * 64, j * kBKV, bh);
            tma_load_3d(sv + s * kv_bytes(D) + c * kKVSub, &tma_v, &full[s],
                        c * 64, j * kBKV, bh);
          }
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
        if (++qb == 2) {
          qb = 0;
          qph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each of every tile ------------------
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // accumulator layout of m64nNk16: register 4j + 2h + e holds row
    // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
    const int col0 = 2 * (lane % 4);
    const float scale2 = scale * kLog2e;
    int s = 0, qb = 0;
    uint32_t ph = 0, qph = 0;
    for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
      int bh, q0;
      tiles.at(t, bh, q0);
      const int n_kv = tiles.kv(q0);
      const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
      // m: the running row max of the scores in log2 units (scale log2 e
      // folded in), so that every probability is one ex2 of a difference
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
      const uint8_t* qw = sq + qb * q_bytes(D) + wg * 64 * 128;
      // the two warpgroups take turns to issue their S products
      // (warpgroup 0 first), so that one's softmax runs while the
      // other's product holds the tensor cores
      if (wg == 1 && n_kv > 0) turn_pass(kTurnBar);
      mbar_wait(&q_full[qb], qph);

      for (int j = 0; j < n_kv; ++j) {
        mbar_wait(&full[s], ph);
        const uint8_t* ks = sk + s * kv_bytes(D);
        const uint8_t* vs = sv + s * kv_bytes(D);

        // S = Q K^T: 64 rows x kBKV keys, D / 16 k16 steps
        float sc[kBKV / 2];
#pragma unroll
        for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.0f;
        fence_acc(sc);
        turn_wait(kTurnBar + wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma<kBKV>(sc, desc_sw128(qw + (kk / 4) * kQSub) + 2 * (kk % 4),
                      desc_sw128(ks + (kk / 4) * kKVSub) + 2 * (kk % 4),
                      kk != 0);
        wgmma_commit();
        // the other warpgroup's turn (each wait has one pass: warpgroup
        // 1 passed once up front, so it skips its last)
        if (wg == 0 || j + 1 < n_kv) turn_pass(kTurnBar + 1 - wg);
        wgmma_wait<0>();
        fence_acc(sc);

        // scale to log2 units, mask, row max (h = 0: row0; h = 1: row0 +
        // 8).  Only a tile that reaches past Tk or past the diagonal of
        // this warpgroup's first row needs the mask.
        const int k0 = j * kBKV;
        const bool masked =
            k0 + kBKV > tk ||
            (causal && k0 + kBKV - 1 > q0 + wg * 64 + offset);
        float mx[2] = {NEG_INF, NEG_INF};
        if (masked) {
#pragma unroll
          for (int jj = 0; jj < kBKV / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row0 + ((e >> 1) << 3);
              const int col = k0 + 8 * jj + col0 + (e & 1);
              const bool live = col < tk && (!causal || row + offset >= col);
              const float x = live ? sc[4 * jj + e] * scale2 : NEG_INF;
              sc[4 * jj + e] = x;
              mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        } else {
#pragma unroll
          for (int i = 0; i < kBKV / 2; ++i) {
            sc[i] *= scale2;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
          }
        }
        float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          corr[h] = ex2(m[h] - m_new);
          m[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < kBKV / 2; ++i) {
          const float p = ex2(sc[i] - m[(i >> 1) & 1]);
          sc[i] = p;
          rs[(i >> 1) & 1] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
          rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
          l[h] = l[h] * corr[h] + rs[h];
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

        // P as the A fragments of O += P V: keys 16c .. 16c + 15 are the
        // accumulator's column blocks 2c and 2c + 1, i.e. registers 8c ..
        // 8c + 7, which are exactly the m64k16 A fragment's a0 .. a3
        uint32_t pa[kBKV / 16][4];
#pragma unroll
        for (int c = 0; c < kBKV / 16; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[c][r] = pack_bf16(sc[8 * c + 2 * r], sc[8 * c + 2 * r + 1]);
        fence_acc(o);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kBKV / 16; ++c)
          wgmma_rs_tb<D>(o, pa[c], desc_sw128_mn(vs, kKVSub) + 128 * c, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with s
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      // this warpgroup's S products of the tile are done: its Q buffer
      // may be refilled
      if (lane == 0) mbar_arrive(&q_empty[qb]);
      if (++qb == 2) {
        qb = 0;
        qph ^= 1;
      }

      // O = o / l, lse = m ln 2 + log(l); l = 0 reads as 1 (the
      // reference's safe_l); a row that saw no live key keeps the
      // reference's m = NEG_INF
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= tq) continue;
        const float sl = l[h] > 0.0f ? l[h] : 1.0f;
        const float inv = 1.0f / sl;
        __nv_bfloat16* orow = O + ((long long)bh * tq + row) * D;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + col0) =
              __floats2bfloat162_rn(o[4 * jj + 2 * h] * inv,
                                    o[4 * jj + 2 * h + 1] * inv);
        if (lane % 4 == 0)
          LSE[(long long)bh * tq + row] =
              (m[h] == NEG_INF ? NEG_INF : m[h] * kLn2) + logf(sl);
      }
    }
  }
}

// A [BH, T, D] bf16 tensor as the 3-D (D, T, BH) map, read in
// (64, box_rows, 1) boxes with the 128-byte swizzle; rows past T read as
// zeros.
inline bool encode_rows(CUtensorMap* map, const void* base, long long bh,
                        long long t, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)(t * d * 2)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (cuTensorMapEncodeTiled(
          map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  small_tensor_fix(map, (unsigned long long)(bh * t * d * 2));
  return true;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long bh, long long tq, long long tk, float scale, int causal,
           int grid, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!encode_rows(&mq, q, bh, tq, D, kBQ) ||
      !encode_rows(&mk, k, bh, tk, D, kBKV) ||
      !encode_rows(&mv, v, bh, tk, D, kBKV))
    return (int)cudaErrorInvalidValue;
  auto* kernel = flash_fwd_sm90<D>;
  static unsigned configured = 0;
  const int err =
      raise_smem_limit(reinterpret_cast<const void*>(kernel), configured);
  if (err) return err;
  const Tiles tiles{(int)bh, (int)((tq + kBQ - 1) / kBQ), (int)tq, (int)tk,
                    causal};
  kernel<<<grid, kThreads, smem_bytes<D>(), stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, tiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace fa90

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

// The sm90 route: bfloat16 q [bh, tq, d], k and v [bh, tk, d], o like q,
// lse float32 [bh, tq]; d 64 or 128; q, k, v and o 16-byte aligned; grid
// persistent blocks (at most one per SM, at most one per (bh, 128-row
// query tile)).  Returns the cudaError_t of the launch (0 =
// cudaSuccess).
extern "C" int mxtpu_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          long long bh, long long tq,
                                          long long tk, int d, float scale,
                                          int causal, int grid,
                                          void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || tq >= (1LL << 30) ||
      tk >= (1LL << 30) || grid <= 0 ||
      bh * ((tq + fa90::kBQ - 1) / fa90::kBQ) >= (1LL << 31) ||
      (d != 64 && d != 128) ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? fa90::launch<64>(q, k, v, o, lse, bh, tq, tk, scale,
                                    causal, grid, s)
                 : fa90::launch<128>(q, k, v, o, lse, bh, tq, tk, scale,
                                     causal, grid, s);
}
