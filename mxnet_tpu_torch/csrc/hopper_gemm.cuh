// hopper_gemm.cuh — one warp-specialised, persistent bf16 GEMM mainloop for
// Hopper (sm_90a), written in raw PTX: TMA loads into a ring of shared
// stages guarded by mbarriers, wgmma from shared-memory descriptors, and
// a hook on each side of the product.
//
//   Y[m, n] = Epi(sum_k Pro(A)[m, k] * B[n, k], n),   Y bf16, (M, N)
//
// A (M, K) and B (N, K) are both K-major bf16 in device memory: B is a
// FullyConnected or 1x1-convolution weight as it lies.  Products
// accumulate in f32 registers; the epilogue hook maps each accumulator to
// the stored value, which is rounded to bf16 once.
//
// Shared by fused_dot_epilogue.cu (an epilogue hook: bias, relu, clip)
// and fused_scale_bias_dot.cu (a prologue hook: the BatchNorm apply step
// rewritten in place on the A stage).  Neither hook changes the
// mainloop.
//
// Block: three warpgroups.  Warpgroup 2 is the producer: it gives up its
// registers (setmaxnreg 40) and one of its threads issues the TMA loads
// (cp.async.bulk.tensor.2d, 128-byte swizzle) of a 128 x 64 A box and a
// BN x 64 B box per K step into stage s, whose `full` mbarrier counts the
// bytes in; it waits on the stage's `empty` mbarrier before reusing it.
// Warpgroups 0 and 1 are consumers (setmaxnreg 232): each owns 64 rows
// of the BM = 128 tile and issues wgmma.m64nBNk16 from descriptors of
// the stage, advancing them 32 bytes per k16 step, keeping one K step's
// wgmma group in flight while the next is issued.  Each of their eight
// warps arrives on `empty` once its K step's group has completed.
//
// Persistent grid: the caller launches at most one block per SM; block b
// walks output tiles b, b + grid, ... (row tiles outer, column tiles
// inner, so that the blocks in flight share A rows in L2).  The producer
// runs ahead across tiles, so the next tile's loads overlap this tile's
// epilogue, and with one K step per tile (K = 64) loads overlap products.
//
// Epilogue: per 64-column chunk, each consumer applies the hook to its
// accumulator registers, rounds to bf16 and writes them into its own
// padded staging tile (conflict-free), then the warpgroup stores the
// chunk to Y with 16-byte vector stores, masked at ragged M and N.
//
// Requirements (the caller's route rule checks them before launching):
// K and N multiples of 8 (TMA row strides and the 16-byte stores), A, B
// and Y 16-byte aligned.  Out-of-range rows and K columns of a box are
// zero-filled by TMA; a prologue that maps 0 elsewhere must write the
// padding back to 0 itself.
//
// Host side: the two tensor maps are encoded with cuTensorMapEncodeTiled
// on every call (the pointers change every step) and passed as
// __grid_constant__ parameters; each kernel instantiation raises its
// dynamic shared-memory limit once per device.  Link with -lcuda.
//
// Launch contract: runs on the caller's stream, does not synchronise,
// allocates nothing; launch() returns the cudaError_t of the launch.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtpu {
namespace sm90 {

constexpr int kBM = 128;            // rows per tile: two consumer warpgroups
constexpr int kBK = 64;             // K per stage: 128 bytes, one swizzle row
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kEpiLd = 64 + 8;      // bf16 per padded staging row
constexpr int kABytes = kBM * kBK * 2;
constexpr int kEpiBytes = kConsumers * 64 * kEpiLd * 2;
constexpr int kSmemLimit = 232448;  // 227 KB a block may use

// Dynamic shared memory of one block: 1024-byte alignment slack, the
// stages (A and B boxes and two mbarriers each), the staging tiles.
__host__ __device__ constexpr int smem_bytes(int bn, int stages) {
  return 1024 + stages * ((kBM + bn) * kBK * 2 + 16) + kEpiBytes;
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) of the threads that synchronise after it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the
// asynchronous wgmma's issue and wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile written by TMA with
// the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
// (SBO), leading offset 16 bytes (unused by the swizzled K-major form),
// layout 1 = 128B swizzle.  The tile base must be 1024-byte aligned; a
// k16 step inside the 128-byte row adds 32 bytes (2 in the address
// field), the swizzle being applied to the computed addresses.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, f32 += bf16 * bf16, both operands K-major
// from shared memory; scale_d = 0 overwrites the accumulators.
#define MXTPU_D8(i)                                                   \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]),                 \
      "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]),             \
      "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MXTPU_D8(0), MXTPU_D8(8), MXTPU_D8(16), MXTPU_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MXTPU_D8(0), MXTPU_D8(8), MXTPU_D8(16), MXTPU_D8(24), MXTPU_D8(32),
        MXTPU_D8(40), MXTPU_D8(48), MXTPU_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MXTPU_D8(0), MXTPU_D8(8), MXTPU_D8(16), MXTPU_D8(24), MXTPU_D8(32),
        MXTPU_D8(40), MXTPU_D8(48), MXTPU_D8(56), MXTPU_D8(64), MXTPU_D8(72),
        MXTPU_D8(80), MXTPU_D8(88), MXTPU_D8(96), MXTPU_D8(104), MXTPU_D8(112),
        MXTPU_D8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MXTPU_D8

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db, scale_d);
  else if constexpr (BN == 128)
    wgmma_n128(d, da, db, scale_d);
  else
    wgmma_n256(d, da, db, scale_d);
}

// ---------------------------------------------------------------------------
// Hooks.  A prologue is called by each consumer warpgroup on its own 64
// rows x 64 K columns of the A stage of K step kb that has just landed
// (128-byte swizzled: 16-byte chunk p of row r holds K columns kb*64 +
// 8*(p ^ (r & 7)) .. + 7), before the wgmma that reads them; it must make
// its writes visible to the async proxy and synchronise the warpgroup.
// Its per-thread Regs carry what it loaded for this step; load() fills
// them for step 0 before the first tile, and each call fills them for the
// next step (nk steps per tile, every tile over the same K range), so
// that the loads' latency hides behind a step's products.  An epilogue
// gives the bias pair of columns (n, n + 1) and maps an accumulator and
// its bias to the value stored.
// ---------------------------------------------------------------------------

struct NoPrologue {
  struct Regs {};
  __device__ __forceinline__ void load(Regs&, int, int, int) const {}
  __device__ __forceinline__ void operator()(Regs&, uint8_t*, int, int, int,
                                             int, int) const {}
};

struct NoEpilogue {
  __device__ __forceinline__ float2 bias2(int) const {
    return make_float2(0.0f, 0.0f);
  }
  __device__ __forceinline__ float operator()(float acc, float) const {
    return acc;
  }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int BN, class Pro, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90(const __grid_constant__ CUtensorMap tma_a,
              const __grid_constant__ CUtensorMap tma_b, const Pro pro,
              const Epi epi, __nv_bfloat16* __restrict__ y, int M, int N,
              int K, int stages) {
  constexpr int kBBytes = BN * kBK * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                                  // stages x A box
  uint8_t* sb = sa + stages * kABytes;                 // stages x B box
  __nv_bfloat16* sy =
      reinterpret_cast<__nv_bfloat16*>(sb + stages * kBBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sy + kConsumers * 64 * kEpiLd);
  uint64_t* empty = full + stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full -------------------
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers * 128) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], kABytes + kBBytes);
          tma_load(sa + s * kABytes, &tma_a, &full[s], kb * kBK, m0);
          tma_load(sb + s * kBBytes, &tma_b, &full[s], kb * kBK, n0);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      // every stage in flight consumed before the block may retire
      for (int i = 0; i < stages; ++i) {
        mbar_wait(&empty[s], ph ^ 1);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, then the epilogue -----------
    reg_alloc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    __nv_bfloat16* stage_y = sy + wg * 64 * kEpiLd;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    typename Pro::Regs pro_regs;
    pro.load(pro_regs, 0, K, tid);
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * BN;
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[s], ph);
        uint8_t* a = sa + s * kABytes + wg * 64 * (kBK * 2);
        pro(pro_regs, a, kb, nk, K, tid, wg);
        const uint64_t da = desc_sw128(a);
        const uint64_t db = desc_sw128(sb + s * kBBytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          wgmma<BN>(acc, da + 2 * ks, db + 2 * ks, (kb | ks) != 0);
        wgmma_commit();
        fence_acc(acc);
        // the previous K step's group is done: release its stage
        wgmma_wait<1>();
        fence_acc(acc);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // accumulator layout of m64nNk16: register 4j + 2h + e holds row
      // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
      const int r0 = warp * 16 + lane / 4;
      const int c0 = 2 * (lane % 4);
#pragma unroll
      for (int cc = 0; cc < BN / 64; ++cc) {
        warpgroup_bar(1 + wg);  // the previous chunk has been stored
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = jj * 8 + c0;
          const int i = (cc * 8 + jj) * 4;
          const float2 b = epi.bias2(n0 + cc * 64 + col);
          *reinterpret_cast<__nv_bfloat162*>(stage_y + r0 * kEpiLd + col) =
              __floats2bfloat162_rn(epi(acc[i], b.x), epi(acc[i + 1], b.y));
          *reinterpret_cast<__nv_bfloat162*>(stage_y + (r0 + 8) * kEpiLd +
                                             col) =
              __floats2bfloat162_rn(epi(acc[i + 2], b.x),
                                    epi(acc[i + 3], b.y));
        }
        warpgroup_bar(1 + wg);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int piece = tid + 128 * q;
          const int row = piece >> 3, ch = piece & 7;
          const int m = m0 + wg * 64 + row;
          const int n = n0 + cc * 64 + ch * 8;
          if (m < M && n < N)
            *reinterpret_cast<uint4*>(y + (size_t)m * N + n) =
                *reinterpret_cast<const uint4*>(stage_y + row * kEpiLd +
                                                ch * 8);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A K-major bf16 (rows, K) matrix at `base`, read in (box_rows, 64) boxes
// with the 128-byte swizzle; out-of-range elements read as zeros.
inline bool encode_kmajor(CUtensorMap* map, const void* base, long long rows,
                          long long k, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, class Pro, class Epi>
int launch_bn(const CUtensorMap& ma, const CUtensorMap& mb, const Pro& pro,
              const Epi& epi, void* y, int M, int N, int K, int stages,
              int grid, cudaStream_t stream) {
  auto* kernel = gemm_sm90<BN, Pro, Epi>;
  // above 48 KB of dynamic shared memory a launch needs the function's
  // limit raised first, once per device
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !((configured >> dev) & 1u)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) configured |= 1u << dev;
  }
  kernel<<<grid, kThreads, smem_bytes(BN, stages), stream>>>(
      ma, mb, pro, epi, static_cast<__nv_bfloat16*>(y), M, N, K, stages);
  return (int)cudaGetLastError();
}

// Y (M, N) = Epi(Pro(A) (M, K) @ B (N, K)^T) at tile width bn (64, 128 or
// 256) with `stages` stages on `grid` persistent blocks.  Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for what the kernel
// does not take (the caller's route rule keeps such calls away).
template <class Pro, class Epi>
int launch(const void* a, const void* b, const Pro& pro, const Epi& epi,
           void* y, long long M, long long N, long long K, int bn,
           int stages, int grid, cudaStream_t stream) {
  const long long lim = 1LL << 31;
  if (M <= 0 || N <= 0 || K <= 0 || M >= lim || N >= lim || K >= lim ||
      (M + kBM - 1) / kBM * ((N + 63) / 64) >= lim || K % 8 != 0 ||
      N % 8 != 0 || grid <= 0 ||
      stages < 2 || smem_bytes(bn, stages) > kSmemLimit ||
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!encode_kmajor(&ma, a, M, K, kBM) || !encode_kmajor(&mb, b, N, K, bn))
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 64:
      return launch_bn<64>(ma, mb, pro, epi, y, (int)M, (int)N, (int)K,
                           stages, grid, stream);
    case 128:
      return launch_bn<128>(ma, mb, pro, epi, y, (int)M, (int)N, (int)K,
                            stages, grid, stream);
    case 256:
      return launch_bn<256>(ma, mb, pro, epi, y, (int)M, (int)N, (int)K,
                            stages, grid, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace mxtpu
